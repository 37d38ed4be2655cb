"""The port's dry-run tooling (``launch/accounting.py``, ``op_cost.py``,
``specs.py``'s structs, ``dryrun.py``, ``profile_cell.py``) against the
JAX package's (``hlo_analysis.py``, ``hlo_cost.py``, ``specs.py``).

Everything runs in this process on ``meta`` tensors: no spawn, no child.

Tolerance: none.  The analytic accounting and the struct trees are equal
exactly; the FLOPs of one program are integers counted on both sides
(the reference's ``hlo_cost.analyze`` of the program compiled on one CPU
device, the port's ``op_cost.analyze``), equal or apart by the exact
amount each stated cause accounts for (``GAPS``).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import list_archs as jlist
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.kernels.ops import leaf_key as jkey
from repro.launch import hlo_analysis as JH
from repro.launch import hlo_cost as JHC
from repro.launch import specs as JS
from repro_torch.configs import ShapeSpec, get_config, get_shape, list_archs
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.context import DistContext, ShapeGroup
from repro_torch.launch import accounting as H
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_cost as OC
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.tree import flatten_with_path, leaf_key

META = torch.device("meta")
B, S = 4, 64                    # the smoke programs' batch and length


# ---------------------------------------------------------------------------
# analytic accounting (twins of tests/test_launch.py)
# ---------------------------------------------------------------------------

def test_param_counts_sane():
    # dense 1.8B: total within 20% of nameplate
    total, active = H.param_counts(get_config("h2o-danube-1.8b"))
    assert 1.4e9 < total < 2.2e9
    assert active == total
    # kimi: ~1T total, ~32B active
    total, active = H.param_counts(get_config("kimi-k2-1t-a32b"))
    assert 0.75e12 < total < 1.3e12
    assert 20e9 < active < 45e9
    # grok: ~314B total
    total, _ = H.param_counts(get_config("grok-1-314b"))
    assert 2.4e11 < total < 3.9e11
    # zamba2: stored ~7B
    total, active = H.param_counts(get_config("zamba2-7b"))
    assert 4e9 < total < 10e9


def test_model_flops_kinds():
    cfg = get_config("h2o-danube-1.8b")
    tr = H.model_flops_for_cell(cfg, get_shape("train_4k"))
    pf = H.model_flops_for_cell(cfg, get_shape("prefill_32k"))
    dc = H.model_flops_for_cell(cfg, get_shape("decode_32k"))
    assert tr > pf > dc > 0
    # train is ~3x a forward at the same token count
    fwd_like = tr / 3
    assert 0.5 < fwd_like / (2 * H.param_counts(cfg)[1] * 256 * 4096) < 2.5


def test_encdec_prefill_is_source_side():
    """seamless prefill encodes SRC_FRAMES frames + one BOS decode — its
    useful flops must NOT scale with the 32k target length."""
    cfg = get_config("seamless-m4t-large-v2")
    pf32 = H.model_flops_for_cell(cfg, get_shape("prefill_32k"))
    tr = H.model_flops_for_cell(cfg, get_shape("train_4k"))
    assert pf32 < tr / 10


def test_skips_are_exactly_the_full_attention_archs():
    skip = {a for a in list_archs()
            if "long_500k" in get_config(a).skipped_shapes()}
    assert skip == {"command-r-35b", "seamless-m4t-large-v2", "qwen2-vl-7b",
                    "grok-1-314b", "kimi-k2-1t-a32b", "iterpro-100m"}


def test_collective_seconds_algo_factors():
    t = OC.collective_seconds({"all-reduce": 100e9, "all-gather": 50e9},
                              link_bw=50e9)
    assert abs(t - (2 * 100e9 + 50e9) / 50e9 / 1) < 1e-9


def test_input_specs_cover_all_kinds_locally():
    """The structs build for every kind without storage, even off the
    mesh (a local context)."""
    for arch in ("gemma3-1b", "zamba2-7b", "seamless-m4t-large-v2",
                 "qwen2-vl-7b", "kimi-k2-1t-a32b"):
        cfg = get_config(arch)
        st = TS.state_struct(cfg, 256)
        assert "params" in st and "opt" in st and "iv" in st
        b = TS.batch_struct(cfg, 8, 128)
        assert b["tokens"].shape == (8, 128)
        c = TS.cache_struct(cfg, 2, 64)
        assert isinstance(c, dict)
        for _, leaf in flatten_with_path(st):
            assert leaf.is_meta
    cfg = get_config("gemma3-1b")
    keys = {"train": ["state", "batch"], "prefill": ["params", "batch"],
            "decode": ["params", "cache", "token"]}
    for shape in ALL_SHAPES:
        structs, shardings = TS.input_specs(cfg, shape, DistContext.local())
        assert list(structs) == keys[shape.kind] == list(shardings)


# ---------------------------------------------------------------------------
# exactly the reference's numbers and trees, for every arch
# ---------------------------------------------------------------------------

def test_arch_lists_match():
    assert set(list_archs()) == set(jlist())


@pytest.mark.parametrize("arch", sorted(jlist()))
def test_accounting_equals_reference(arch):
    ours, theirs = get_config(arch), jget(arch)
    assert H.param_counts(ours) == JH.param_counts(theirs)
    assert H._param_components(ours) == JH._param_components(theirs)
    assert [s.name for s in ours.shapes()] == \
        [s.name for s in theirs.shapes()]
    assert ours.skipped_shapes() == theirs.skipped_shapes()
    for shape, jshape in zip(ALL_SHAPES, J_SHAPES):
        assert shape.name == jshape.name
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (jshape.seq_len, jshape.global_batch, jshape.kind)
        assert H._attn_context_lengths(ours, shape.seq_len) == \
            JH._attn_context_lengths(theirs, shape.seq_len)
        assert H.model_flops_for_cell(ours, shape) == \
            JH.model_flops_for_cell(theirs, jshape)


def _jsig(tree):
    return sorted((jkey(p), tuple(x.shape), str(x.dtype))
                  for p, x in jax.tree_util.tree_flatten_with_path(tree)[0])


def _tsig(tree):
    return sorted((leaf_key(p), tuple(x.shape),
                   str(x.dtype).replace("torch.", ""))
                  for p, x in flatten_with_path(tree))


@pytest.mark.parametrize("arch", sorted(jlist()))
def test_structs_equal_reference(arch):
    """Every struct tree's leaf paths, shapes and dtypes are the
    reference's ``jax.eval_shape`` structs', at full width.  One stated
    difference: the decode cache's ``pos`` is per row ``(B,)`` in the port
    (each serving slot decodes at its own position), a scalar in the
    reference."""
    ours, theirs = get_config(arch), jget(arch)
    assert _tsig(TS.state_struct(ours, 256)) == \
        _jsig(JS.state_struct(theirs, 256))
    assert _tsig(TS.params_struct(ours)) == _jsig(JS.params_struct(theirs))
    assert _tsig(TS.batch_struct(ours, 8, 128)) == \
        _jsig(JS.batch_struct(theirs, 8, 128))
    mine = _tsig(TS.cache_struct(ours, 2, 64))
    ref = _jsig(JS.cache_struct(theirs, 2, 64))
    assert ("pos", (2,), "int32") in mine and ("pos", (), "int32") in ref
    assert [e for e in mine if e[0] != "pos"] == \
        [e for e in ref if e[0] != "pos"]


# ---------------------------------------------------------------------------
# the op counter (twins of tests/test_hlo_cost.py)
# ---------------------------------------------------------------------------

def test_single_device_matmul_flops():
    M, K, N = 64, 32, 48
    a = torch.empty(M, K, device=META)
    b = torch.empty(K, N, device=META)
    cost, out = OC.analyze(lambda a, b: a @ b, a, b)
    assert cost.flops == 2 * M * K * N
    assert cost.hbm_bytes == 4 * (M * K + K * N + M * N)
    assert tuple(out.shape) == (M, N) and out.is_meta
    assert cost.to_dict()["while_trips"] == {}


def test_loop_trip_count_multiplies():
    """A Python loop of T matmuls counts T times one: every trip is
    dispatched, so no trip count is needed."""
    M, K, T = 32, 16, 9

    def g(x, w):
        for _ in range(T):
            x = torch.tanh(x @ w)
        return x

    cost, _ = OC.analyze(g, torch.empty(M, K, device=META),
                         torch.empty(K, K, device=META))
    assert cost.flops == 2 * M * K * K * T
    assert cost.by_op["aten.mm"][0] == T
    assert cost.by_op["aten.tanh"][0] == T


def test_counts_equal_flop_counter_mode_on_a_mesh_step():
    """A rank's mesh train step (2 x 2, tensor-parallel) counts what
    ``FlopCounterMode`` counts of the same run, and the memo of meta
    shapes changes no count."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config("iterpro-100m").smoke()
    shape = ShapeSpec("smoke", S, B, "train")
    ctx = make_mesh((2, 2), ("data", "model")).at_rank(3)
    structs, shardings = TS.input_specs(cfg, shape, ctx)
    args = D.rank_inputs(cfg, shape, ctx, structs, shardings)
    step = D.build_program(cfg, shape, ctx, shardings)
    with FlopCounterMode(display=False) as fc:
        step(*args.values())
    first, _ = OC.analyze(step, *args.values())
    again, _ = OC.analyze(step, *args.values())
    assert first.flops == again.flops == fc.get_total_flops() > 0
    assert first.hbm_bytes == again.hbm_bytes
    assert first.coll_count_by_kind == again.coll_count_by_kind


def test_spmd_per_device_flops_and_collectives():
    """A model-axis program on a shape-only 1 x 2 context: the rank
    computes its half of the columns (per-device FLOPs) and gathers them
    (one all-gather of max(in, out) bytes); the model's prefill computes
    half of one device's FLOPs, every collective its model-axis gathers."""
    ctx = make_mesh((1, 2), ("data", "model")).at_rank(1)
    tp = TP.for_model(ctx, None)
    assert (tp.size, tp.rank) == (2, 1)
    M, K, N = 512, 256, 1024
    x = torch.empty(M, K, device=META)
    w = torch.empty(K, N // 2, device=META)
    cost, y = OC.analyze(lambda x, w: TP.gather_cols(x @ w, tp), x, w)
    assert cost.flops == 2 * M * K * N / 2
    assert tuple(y.shape) == (M, N)
    assert cost.coll_count_by_kind == {"all-gather": 1}
    assert cost.coll_bytes_by_kind == {"all-gather": 4 * M * N}

    cfg = get_config("iterpro-100m").smoke()
    shape = ShapeSpec("smoke", S, B, "prefill")
    one = D.trace_cell(cfg, shape, make_mesh((1, 1), ("data", "model")))[1]
    before = sum(TP.CALLS.values())
    rec, two = D.trace_cell(cfg, shape, make_mesh((1, 2),
                                                  ("data", "model")))
    assert rec["chips"] == 2 and rec["rank"] == 0
    assert two.flops == one.flops / 2
    assert two.coll_count_by_kind == {
        "all-gather": sum(TP.CALLS.values()) - before}
    assert one.coll_count_by_kind == {}


def test_meta_collectives_never_reach_torch_distributed():
    import torch.distributed as dist
    g = ShapeGroup(4)
    t = torch.empty(3, 5, device=META)
    saved, coll.METER = coll.METER, []
    try:
        assert tuple(coll.all_gather(t, g).shape) == (4, 3, 5)
        assert tuple(coll.all_to_all(torch.empty(8, 5, device=META),
                                     g).shape) == (4, 10)
        assert coll.all_reduce(t, "sum", g) is t
        assert tuple(coll.shift(t, g).shape) == (3, 5)
        assert tuple(coll.all_gather_rows(t, g).shape) == (3, 5)
        got = coll.METER
    finally:
        coll.METER = saved
    assert [k for k, _, _ in got] == ["all-gather", "all-to-all",
                                      "all-reduce", "collective-permute",
                                      "all-gather"]
    assert got[0][1:] == (60, 240)
    assert not dist.is_initialized()


def test_peak_bytes_counts_live_storages():
    """The peak is of the storages alive together: a temporary freed
    before the next allocation is not added twice."""
    n = 1 << 10

    def prog(x):
        a = x * 2          # n floats
        b = a + 1          # n floats, a still alive
        del a
        c = b * 3          # n floats, a freed
        return c

    cost, out = OC.analyze(prog, torch.empty(n, device=META))
    assert cost.peak_bytes == 2 * 4 * n


def test_in_place_writes_count_what_they_write():
    """An indexed write into an argument counts its indices, its values
    and the bytes it writes, whatever the destination's size, and
    allocates nothing; ``copy_`` and ``fill_`` write without reading."""
    b, kv, dh = 4, 2, 32
    row = b * kv * dh * 4

    def prog(cache, v, rows, slot, dst, src):
        cache[rows, slot] = v
        dst.copy_(src)
        src.fill_(0.0)

    for c in (64, 4096):
        args = (torch.empty(b, c, kv, dh, device=META),
                torch.empty(b, kv, dh, device=META),
                torch.empty(b, dtype=torch.int64, device=META),
                torch.empty(b, dtype=torch.int64, device=META),
                torch.empty(b, c, device=META),
                torch.empty(b, c, device=META))
        cost, _ = OC.analyze(prog, *args)
        assert cost.by_op["aten.index_put_"][2] == 2 * 8 * b + 2 * row
        assert cost.by_op["aten.copy_"][2] == 2 * 4 * b * c
        assert cost.by_op["aten.fill_"][2] == 4 * b * c
        assert cost.peak_bytes == 0


def test_decode_cell_counts_its_cache_once():
    """A decode cell's cache is an argument written in place: its new rows
    count as written (a hand count), its temporaries hold no cache, and
    the bytes that grow with the cache's length are the three passes over
    K and V the eager program makes (the einsum's relayout reads and
    writes each, the bmm reads it) beside its f32 scores."""
    cfg = get_config("iterpro-100m").smoke()
    n_layers = cfg.model.n_layers
    mesh = make_mesh((1, 1), ("data", "model"))
    (r1, c1), (r2, c2) = (D.trace_cell(cfg, ShapeSpec("d", c, B, "decode"),
                                       mesh) for c in (S, 2 * S))
    m1, m2 = r1["memory"], r2["memory"]
    d_cache = m2["alias_size_in_bytes"] - m1["alias_size_in_bytes"]
    row = d_cache // (2 * n_layers * S)     # one row of K (or V): B·KV·Dh
    for cost in (c1, c2):                   # rows and slots int64, values
        assert cost.by_op["aten.index_put_"] == [
            2 * n_layers, 0, 2 * n_layers * (2 * 8 * B + 2 * row)]
    assert m1["temp_size_in_bytes"] < m1["alias_size_in_bytes"]
    assert m2["temp_size_in_bytes"] - m1["temp_size_in_bytes"] < d_cache
    d_hbm = c2.hbm_bytes - c1.hbm_bytes
    assert 3 * d_cache <= d_hbm < 3 * d_cache + d_cache // 4


# ---------------------------------------------------------------------------
# FLOPs against the reference's compiled programs
# ---------------------------------------------------------------------------

T_ = B * S
#: port - reference FLOPs of each family's smoke program (B 4, S 64; d 64,
#: V 256, top-2 of 4 experts, 2 layers), each gap with its cause
GAPS = {
    # the reference's loss chunks are jax.checkpoint'ed: the backward
    # recomputes the chunk's logits (one more 2·B·S·d·V dot)
    ("iterpro-100m", "train"): -2 * T_ * 64 * 256,
    # the reference combines the top-k expert rows with a dot
    # (tkd,tk->td: 2·T·k·d a MoE layer, its backward another); the port
    # multiplies and sums, no matmul
    ("grok-1-314b", "prefill"): -2 * (2 * T_ * 2 * 64),
    ("grok-1-314b", "decode"): -2 * (2 * B * 2 * 64),
    ("grok-1-314b", "train"): -4 * (2 * T_ * 2 * 64),
    # small per-head contractions of the mLSTM written as dots on one
    # side and products and sums on the other: the port's chunk
    # normaliser is a (Q, Q) x (Q, 1) bmm (2 x 65,536); the reference's
    # decode reads C·q and n·q with dots (2 x 4,096 + 2 x 1,024); in the
    # train step the reference's backward forms two (64, 64) x (64, 64)
    # head products more (2 x 4,194,304) and the port six column
    # products more (6 x 65,536)
    ("xlstm-350m", "prefill"): 2 * 65_536,
    ("xlstm-350m", "decode"): -(2 * 4_096 + 2 * 1_024),
    ("xlstm-350m", "train"): -2 * 4_194_304 + 6 * 65_536,
    # Mamba-2: the port builds the blocks' final SSM states with four
    # (4, 64) x (64, 64) bmm (4 x 131,072); the reference's decode updates
    # and reads the state with two dots (2 x 5,120); in the train step the
    # reference's SSD backward forms two (64, 16) x (16, 128) chunk
    # products more (2 x 1,048,576), the port eight state products more
    # (8 x 131,072)
    ("zamba2-7b", "prefill"): 4 * 131_072,
    ("zamba2-7b", "decode"): -2 * 5_120,
    ("zamba2-7b", "train"): -2 * 1_048_576 + 8 * 131_072,
}
FAMILIES = ("iterpro-100m", "grok-1-314b", "xlstm-350m", "zamba2-7b",
            "seamless-m4t-large-v2", "qwen2-vl-7b")


def _reference_flops(arch: str, kind: str) -> float:
    from repro.models.registry import get_model as jmodel
    from repro.train.loop import make_train_step as jstep
    cfg = jget(arch).smoke()
    m = jmodel(cfg.model)
    if kind == "train":
        prog = jstep(cfg, global_batch=B)
        args = (JS.state_struct(cfg, B), JS.batch_struct(cfg, B, S))
    elif kind == "prefill":
        bt = JS.batch_struct(cfg, B, S)
        bt.pop("targets")
        args = (JS.params_struct(cfg), bt)

        def prog(p, b):
            return m.prefill(p, cfg.model, b, None, max_len=S)
    else:
        args = (JS.params_struct(cfg), JS.cache_struct(cfg, B, S),
                jax.ShapeDtypeStruct((B,), jnp.int32))

        def prog(p, c, t):
            return m.decode_step(p, cfg.model, c, t, None)
    text = jax.jit(prog).lower(*args).compile().as_text()
    return JHC.analyze(text).flops


def _port_cost(arch: str, kind: str):
    cfg = get_config(arch).smoke()
    one = make_mesh((1, 1), ("data", "model"))
    return D.trace_cell(cfg, ShapeSpec("smoke", S, B, kind), one)[1]


def _port_flops(arch: str, kind: str) -> float:
    return _port_cost(arch, kind).flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_against_reference(arch, kind):
    assert _port_flops(arch, kind) - _reference_flops(arch, kind) == \
        GAPS.get((arch, kind), 0)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_chunked_attention_flops_against_reference(kind, monkeypatch):
    """The chunked attention path (a flash threshold below the smoke
    length, 32-row chunks on both sides): the same counts, the train step
    apart by the loss chunks' recompute alone."""
    from repro.models import layers as JL
    for name, v in (("FLASH_THRESHOLD", 16), ("Q_CHUNK", 32),
                    ("KV_CHUNK", 32)):
        monkeypatch.setattr(JL, name, v)
    variant = {"flash_threshold": 16, "q_chunk": 32, "kv_chunk": 32}
    with D.knobs(variant):
        ours = _port_cost("iterpro-100m", kind)
    theirs = _reference_flops("iterpro-100m", kind)
    assert ours.flops - theirs == GAPS.get(("iterpro-100m", kind), 0)
    direct = _port_cost("iterpro-100m", kind)
    # the chunked path ran: 2 x 2 (q, kv) chunk products a head group
    # where the direct path takes one, the same FLOPs in all
    assert ours.by_op["aten.bmm"][0] > direct.by_op["aten.bmm"][0]
    assert ours.flops == direct.flops


# ---------------------------------------------------------------------------
# the cell, the CLI and the profile
# ---------------------------------------------------------------------------

def test_dryrun_cell_in_process():
    """The twin of ``test_dryrun_cell_subprocess``: an xlstm decode cell
    on a 2 x 4 mesh, in process."""
    from repro_torch.models import layers as L
    before = L.FLASH_THRESHOLD
    rec = D.run_cell("xlstm-350m", "decode_32k", "single",
                     variant={"mesh_shape": [2, 4], "flash_threshold": 8})
    assert L.FLASH_THRESHOLD == before
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 8
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert rec["op_cost"]["flops_per_device"] > 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > mem["alias_size_in_bytes"] > 0
    assert mem["per_device_total"] == sum(mem[k] for k in (
        "argument_size_in_bytes", "temp_size_in_bytes",
        "output_size_in_bytes"))
    skip = D.run_cell("iterpro-100m", "long_500k", "single")
    assert skip == {"arch": "iterpro-100m", "shape": "long_500k",
                    "mesh": "single", "kind": "decode", "status": "skipped",
                    "reason": "full-attention arch: long_500k requires "
                              "sub-quadratic attention (DESIGN.md §8)"}


def test_dryrun_cli_and_profile(tmp_path, capsys):
    import json
    from repro_torch.launch import profile_cell
    out = tmp_path / "dry.json"
    rc = D.main(["--arch", "iterpro-100m", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [(r["mesh"], r["status"], r["chips"]) for r in recs] == \
        [("single", "ok", 256), ("multi", "ok", 512)]
    text = capsys.readouterr().out
    assert "[dryrun] iterpro-100m x decode_32k x single: ok trace=" in text
    assert "[dryrun] done: 2 ok, 0 skipped, 0 errors" in text
    cost = profile_cell.profile("iterpro-100m", "decode_32k", top=5)
    text = capsys.readouterr().out
    assert "total HBM traffic:" in text and "top 5 HBM ops:" in text
    assert "collectives:" in text and " all-gather " in text
    assert cost.flops > 0 and cost.coll_count_by_kind["all-gather"] > 0


def test_loss_chunk_knob_is_read_at_call_time():
    """``variant["loss_chunk"]`` cuts the cross-entropy into more chunks
    (more, smaller logits products; the same FLOPs) and is put back."""
    from repro_torch.models import transformer as T
    before = T.LOSS_CHUNK
    with D.knobs({"loss_chunk": 16}):
        chunked = _port_cost("iterpro-100m", "train")
    assert T.LOSS_CHUNK == before
    whole = _port_cost("iterpro-100m", "train")
    assert chunked.flops == whole.flops
    assert chunked.by_op["aten.bmm"][0] > whole.by_op["aten.bmm"][0]


@pytest.mark.parametrize("arch,kind", [("iterpro-100m", "train"),
                                       ("xlstm-350m", "decode")])
def test_memo_changes_no_count(arch, kind):
    """``variant["memo"] = False`` runs every op through its shape
    function: the record it gives is the memo's, count for count."""
    cfg = get_config(arch).smoke()
    shape = ShapeSpec("m", S, B, kind)
    mesh = make_mesh((1, 2), ("data", "model"))
    with D.knobs({"memo": False}):
        assert not OC.MEMO
        slow, slow_cost = D.trace_cell(cfg, shape, mesh)
    assert OC.MEMO
    fast, fast_cost = D.trace_cell(cfg, shape, mesh)
    for key in ("memory", "op_cost", "roofline", "ops"):
        assert slow[key] == fast[key], key
    assert slow_cost.by_op == fast_cost.by_op
