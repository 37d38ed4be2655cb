"""The port's off-mesh XOR parity layer against the JAX package (smoke
config, B=2, S=32, on the CPU): the two kernels' plain versions against
the Pallas kernels in interpret mode, ``ops.xor_fold``/``xor_reconstruct``,
the plan layout and the built parity buffer, the canary's gated
incremental update, the ``parity_xor`` rung, ``train --parity`` and
``serve --parity``.

Everything here is integer or bitwise: every comparison is equality, and
every repair is checked bit for bit against the never-faulted state.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import ChecksumCanary as JCanary
from repro.core import ParityStore as JStore
from repro.core import parity_plan_for as jplan_for
from repro.kernels import ops as jops
from repro.kernels import parity as jpk
from repro.kernels import ref as jref
from repro.models.registry import get_model as jget_model
from repro.serving import ServingEngine as JEngine
from repro.train.loop import make_train_state as jmake_state
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import ParityPlan, ParityStore, parity_plan_for
from repro_torch.core.detect import ChecksumCanary, FaultReport
from repro_torch.core.faults import InjectionPlan, inject, sample_plan
from repro_torch.core.icp import promote
from repro_torch.core.microcheckpoint import MicroCheckpointer
from repro_torch.core.recover import RecoveryFailed, RecoveryRuntime
from repro_torch.core.recovery_table import RUNG_PARITY
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import _build
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as tdg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity as tpk
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.serving import ServingEngine
from repro_torch.train.loop import make_train_step
from repro_torch.tree import flatten_with_path, leaf_key, tree_map

ROWS, LANES = tpk.TILE_ROWS, tpk.LANES
EXTREMES = np.array([2**31 - 1, -2**31, -1, 0, 1], np.int32)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clone(tree):
    return tree_map(torch.clone, tree)


def _flat(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _bitwise_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


def _tiles(rng, *lead):
    """Random int32 tiles with the int32 extremes planted in each row."""
    x = rng.integers(-2**31, 2**31, size=(*lead, ROWS, LANES),
                     dtype=np.int64).astype(np.int32)
    x[..., 0, :len(EXTREMES)] = EXTREMES
    return x


@pytest.fixture(scope="module")
def port(tiny_setup):
    """(cfg, bridged initial state, functional step, batch_fn)."""
    cfg = get_config("iterpro-100m").smoke()
    _, jstate0, _, _ = tiny_setup
    pipe = TokenPipeline(cfg.model.vocab_size, 32, 2, seed=0)
    return (cfg, state_from_numpy(_host(jstate0)),
            make_train_step(cfg, global_batch=2), pipe.batch_at)


def _runtime(port, **kw):
    cfg, _, step, bfn = port
    return RecoveryRuntime(step_fn=step, batch_fn=bfn,
                           iv_registry=promote(cfg, 2),
                           micro=MicroCheckpointer(interval=4), **kw)


def _store(state):
    ps = ParityStore(state)
    ps.build(state, 0)
    return ps


def _wipe_block(state, ps, key, blk, value=0.0):
    """A copy of ``state`` with exactly parity block ``blk`` of ``key`` set
    to ``value`` — the plan's own boundaries define one shard."""
    out = _clone(state)
    flat = _flat(out)[key].view(-1)
    csum = np.cumsum((0,) + ps.plan.block_sizes[key])
    flat[int(csum[blk]):int(csum[blk + 1])] = value
    return out


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2, 4, 5])
def test_xor_fold_tiles_matches_the_pallas_kernel(r):
    x = _tiles(np.random.default_rng(r), r, 3)
    theirs = np.asarray(jpk.xor_fold_tiles(jnp.asarray(x), interpret=True))
    ours = tpk.xor_fold_tiles(torch.from_numpy(x.copy()))
    assert ours.dtype == torch.int32 and ours.shape == (3, ROWS, LANES)
    assert np.array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("d", [1, 2, 4, 5])
def test_xor_update_tiles_matches_the_pallas_kernel_in_place(d):
    rng = np.random.default_rng(10 + d)
    x, p = _tiles(rng, d, 2), _tiles(rng, 2)
    theirs = np.asarray(jpk.xor_update_tiles(jnp.asarray(x), jnp.asarray(p),
                                             interpret=True))
    parity = torch.from_numpy(p.copy())
    ptr = parity.data_ptr()
    ours = tpk.xor_update_tiles(torch.from_numpy(x), parity)
    assert ours is parity and parity.data_ptr() == ptr
    assert np.array_equal(parity.numpy(), theirs)


def test_xor_update_of_zeros_is_the_fold():
    x = torch.from_numpy(_tiles(np.random.default_rng(3), 4, 2))
    zeros = torch.zeros((2, ROWS, LANES), dtype=torch.int32)
    assert torch.equal(tpk.xor_update_tiles(x, zeros), tpk.xor_fold_tiles(x))
    assert torch.equal(tref.xor_fold_tiles_ref(x), tpk.xor_fold_tiles(x))


@pytest.mark.parametrize("bad", [
    torch.zeros((2, 1, ROWS, LANES), dtype=torch.int64),
    torch.zeros((2, 1, ROWS, LANES), dtype=torch.float32),
    torch.zeros((2, ROWS, LANES), dtype=torch.int32),
    torch.zeros((0, 1, ROWS, LANES), dtype=torch.int32),
    torch.zeros((2, 1, ROWS, LANES + 1), dtype=torch.int32),
])
def test_parity_wrappers_refuse_misshaped_operands(bad):
    with pytest.raises(ValueError):
        tpk.xor_fold_tiles(bad)
    with pytest.raises(ValueError):
        tpk.xor_update_tiles(bad, torch.zeros((1, ROWS, LANES),
                                              dtype=torch.int32))


def test_xor_update_refuses_a_mismatched_parity():
    x = torch.zeros((2, 3, ROWS, LANES), dtype=torch.int32)
    for p in (torch.zeros((2, ROWS, LANES), dtype=torch.int32),
              torch.zeros((3, ROWS, LANES), dtype=torch.float32)):
        with pytest.raises(ValueError, match="parity"):
            tpk.xor_update_tiles(x, p)


def test_cpu_parity_wrappers_launch_no_kernel():
    _build.LAUNCHES.clear()
    x = torch.zeros((2, 1, ROWS, LANES), dtype=torch.int32)
    tpk.xor_update_tiles(x, tpk.xor_fold_tiles(x))
    tops.xor_fold([torch.ones(5), torch.ones(5)])
    assert sum(_build.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# ops.xor_fold / xor_reconstruct: tests/test_kernels.py:72, case for case
# ---------------------------------------------------------------------------

def _shards(n, dtype, seed):
    """n random (65, 9) shards of ``dtype`` as jax arrays and tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if dtype == "int32":
            a = rng.integers(-2**31, 2**31, (65, 9), dtype=np.int64) \
                .astype(np.int32)
            t = torch.from_numpy(a.copy())
        else:
            a = rng.standard_normal((65, 9)).astype(np.float32)
            if dtype == "bfloat16":
                a = a.astype(ml_dtypes.bfloat16)
                t = torch.from_numpy(a.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
        out.append((jnp.asarray(a), t))
    return out


def _bits_of(t):
    return t.reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("n_shards", [2, 4, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_xor_reconstruct_bit_exact(n_shards, dtype):
    pairs = _shards(n_shards, dtype, n_shards)
    js, ts = [a for a, _ in pairs], [t for _, t in pairs]
    parity = tops.xor_fold(ts)
    assert parity.dtype == ts[0].dtype and parity.shape == ts[0].shape
    jparity = np.asarray(jops.xor_fold(js))
    assert np.array_equal(_bits_of(parity), jparity.reshape(-1).view(np.uint8))
    assert np.array_equal(_bits_of(tref.xor_fold_ref(ts)), _bits_of(parity))
    for lost in range(n_shards):
        others = ts[:lost] + ts[lost + 1:]
        rec = tops.xor_reconstruct(parity, others)
        assert np.array_equal(_bits_of(rec), _bits_of(ts[lost])), lost
        assert np.array_equal(_bits_of(tref.xor_reconstruct_ref(parity,
                                                                others)),
                              _bits_of(ts[lost]))


def test_xor_fold_refuses_mixed_operands():
    with pytest.raises(ValueError):
        tops.xor_fold([torch.zeros(4), torch.zeros(5)])
    with pytest.raises(ValueError):
        tops.xor_fold([torch.zeros(4), torch.zeros(4, dtype=torch.int32)])


# ---------------------------------------------------------------------------
# plan layout and built parity, against the reference
# ---------------------------------------------------------------------------

def _same_layout(ours: ParityPlan, theirs) -> None:
    assert ours.keys == theirs.keys
    for name in ("offsets", "block_len", "block_sizes", "block_shapes",
                 "n_blocks", "device_block", "groups", "block_group"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.stream_len, ours.n_tiles, ours.buffer_shape,
            ours.memory_bytes, ours.n_shards) == (
        theirs.stream_len, theirs.n_tiles, theirs.buffer_shape,
        theirs.memory_bytes, theirs.n_shards)


@pytest.mark.parametrize("part", ["state", "params"])
def test_plan_and_built_parity_match_reference(tiny_setup, part):
    _, jstate, _, _ = tiny_setup
    jtree = jstate if part == "state" else jstate["params"]
    ttree = state_from_numpy(_host(jtree))
    jps = JStore(jtree)
    jps.build(jtree)
    ps = _store(ttree)
    _same_layout(ps.plan, jps.plan)
    assert np.array_equal(ps.parity.numpy(), np.asarray(jps.parity))
    assert not any(k.startswith("iv") for k in ps.plan.keys)
    prefix = "params/" if part == "state" else ""
    assert "opt/t" not in ps.plan.keys and ps.covers(prefix + "embed/table")


@pytest.mark.parametrize("part", ["state", "params"])
def test_full_width_plan_matches_reference(part):
    """iterpro-100m at full width, shapes only (meta tensors): the layout
    the card runs — 33 leaves / 2,291 tiles for the train state, 11 / 764
    for the params."""
    cfg = jget("iterpro-100m")
    if part == "state":
        shapes = jax.eval_shape(lambda: jmake_state(
            cfg, jax.random.PRNGKey(0), global_batch=8))
    else:
        m = cfg.model
        shapes = jax.eval_shape(lambda: jget_model(m).init(
            m, jax.random.PRNGKey(0)))
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta", dtype=getattr(
            torch, np.dtype(s.dtype).name)), shapes)
    ours, theirs = parity_plan_for(meta), jplan_for(shapes)
    _same_layout(ours, theirs)
    n_leaves, n_tiles = (33, 2291) if part == "state" else (11, 764)
    assert (len(ours.keys), ours.n_tiles) == (n_leaves, n_tiles)


def test_plan_is_cached_per_structure(port):
    _, state, _, _ = port
    assert parity_plan_for(state) is ParityStore(_clone(state)).plan
    assert parity_plan_for(state, n_shards=3) is not parity_plan_for(state)
    assert parity_plan_for(state, n_shards=1).n_shards == 2   # max(2, D)


# the mesh parity and its row-safe placement are ported
# (tests/test_torch_mesh*.py): a mesh store still needs the state's
# shardings, and off the mesh ``row_safe`` keeps the plain placement, as
# the reference's store does (no row to lose)
@pytest.mark.parametrize("kw", [dict(ctx=type("Ctx", (), {"enabled": True})(),
                                     row_safe=True),
                                dict(row_safe=True)])
def test_mesh_parity_is_not_ported(port, kw):
    _, state, _, _ = port
    if "ctx" in kw:
        with pytest.raises(ValueError, match="shardings"):
            ParityStore(state, **kw)
        return
    ps = ParityStore(state, **kw)
    assert ps.plan is _store(state).plan
    assert not getattr(ps.plan, "row_safe", False)


def test_mesh_only_methods_raise(port):
    _, state, _, _ = port
    ps = _store(state)
    leaf = state["params"]["embed"]["table"]
    # a block of a mesh store (ported); off the mesh a leaf is rebuilt whole
    with pytest.raises(ValueError, match="mesh parity store only"):
        ps.reconstruct_shard(leaf, "params/embed/table", 0)
    # the hard-loss helpers: off the mesh the parity stream is the
    # buffer's words (the reference's), the block reads are a mesh
    # plan's (collectives over the survivors; tests/test_torch_mesh*.py)
    assert torch.equal(ps.plan.host_parity_flat(ps.parity),
                       ps.parity.reshape(-1)[:ps.plan.stream_len])
    for name in ("host_surviving_blocks", "host_reconstruct_block",
                 "host_assemble_leaf"):
        assert not hasattr(ps.plan, name), name
    with pytest.raises(ValueError, match="shardings"):
        parity_plan_for(state, mesh=object())


# ---------------------------------------------------------------------------
# maintenance through the canary
# ---------------------------------------------------------------------------

def test_incremental_update_matches_reference_and_rebuild(tiny_setup,
                                                          monkeypatch):
    """Over 4 check_and_arm steps of the reference's own state sequence
    (bridged): the port's parity equals the reference's incrementally
    maintained parity every step and a fresh build at the end; each step
    costs 1 row_checksums launch, 1 fetch and 1 xor_update_tiles call."""
    _, jstate, jstep, jbfn = tiny_setup
    jcan, tcan = JCanary(jstate, n_slices=2), None
    jps = JStore(jstate)
    jps.build(jstate, 0)
    jcan.attach_parity(jps)
    tstate = state_from_numpy(_host(jstate))
    tcan = ChecksumCanary(tstate, n_slices=2)
    ps = _store(tstate)
    tcan.attach_parity(ps)
    assert tcan.parity_store is ps
    calls = {"row_checksums": 0, "xor_update_tiles": 0}
    for mod, name in ((tck, "row_checksums"), (tpk, "xor_update_tiles")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(mod, name, counted)
    ptr = ps.parity.data_ptr()
    for s in range(4):
        jnew, _ = jstep(jstate, jbfn(s))
        tnew = state_from_numpy(_host(jnew))
        assert jcan.check_and_arm(s, jstate, jnew) is None
        tdg.STATS.reset()
        for k in calls:
            calls[k] = 0
        assert tcan.check_and_arm(s, tstate, tnew) is None
        assert (calls["row_checksums"], tdg.STATS.syncs,
                calls["xor_update_tiles"]) == (1, 1, 1)
        assert np.array_equal(ps.parity.numpy(), np.asarray(jps.parity))
        assert ps.version == jps.version == s + 1
        jstate, tstate = jnew, tnew
    assert ps.parity.data_ptr() == ptr            # updated in place
    fresh = _store(tstate)
    assert torch.equal(ps.parity, fresh.parity)


def test_arm_rebuilds_the_armed_tree(port):
    cfg, state0, step, bfn = port
    can = ChecksumCanary(state0, n_slices=2)
    ps = ParityStore(state0)                  # never built: all zeros
    can.attach_parity(ps)
    can.arm(3, state0)
    assert ps.version == 4
    assert torch.equal(ps.parity, _store(state0).parity)


def test_fault_gated_check_and_arm_leaves_parity_unchanged(port):
    cfg, state0, step, bfn = port
    can = ChecksumCanary(state0, n_slices=1)
    ps = _store(state0)
    can.attach_parity(ps)
    before = ps.parity.clone()
    bad = inject(_clone(state0), InjectionPlan("embed/table", 11, 4, 0))
    new, _ = step(bad, bfn(0))
    rep = can.check_and_arm(0, bad, new)
    assert rep is not None and rep.leaves == ["params/embed/table"]
    assert torch.equal(ps.parity, before)


# ---------------------------------------------------------------------------
# the parity_xor rung (twins of tests/test_parity.py and test_recovery.py)
# ---------------------------------------------------------------------------

def test_finite_flip_localized_and_repaired(port):
    """A low-mantissa flip is invisible to the non-finite scan: the rung
    localises it by unique-match trial reconstruction against the fired
    check's reference digest and repairs it bit for bit."""
    cfg, state0, step, bfn = port
    can = ChecksumCanary(state0, n_slices=1)
    ps = _store(state0)
    plan = dataclasses.replace(
        sample_plan(random.Random(7), state0, max_step=1, target="params"),
        bit=3)
    bad = inject(_clone(state0), plan)
    report = can.check_full(0, bad)
    assert report is not None and report.leaves == ["params/" + plan.leaf]
    fixed, ev = _runtime(port, parity=ps, canary=can).recover(
        bad, report, 0, ladder=[RUNG_PARITY])
    assert ev.rung == RUNG_PARITY and ev.steps_replayed == 0
    assert ev.bytes_moved == 4 * max(ps.plan.block_sizes["params/"
                                                         + plan.leaf])
    assert _bitwise_equal(fixed, state0)


def test_sign_flip_is_ambiguous_and_escalates(port):
    """A sign-bit flip in a leaf of even block length digest-collides for
    every false candidate (the mirrored ±2^31 deltas cancel mod 2^32), so
    several candidates certify: the rung aborts instead of guessing."""
    cfg, state0, step, bfn = port
    can = ChecksumCanary(state0, n_slices=1)
    ps = _store(state0)
    key = "params/embed/table"
    assert ps.plan.block_len[key] % 2 == 0
    bad = inject(_clone(state0), InjectionPlan("embed/table", 5, 31, 0))
    report = can.check_full(0, bad)
    rt = _runtime(port, parity=ps, canary=can)
    with pytest.raises(RecoveryFailed):
        rt.recover(bad, report, 0, ladder=[RUNG_PARITY])
    assert "Fletcher collision" in rt.events[-1].report.detail


def test_lost_whole_shard_reconstructs(port):
    """A zero-wiped block with external (leaf, shard) attribution — a lost
    slice, nothing non-finite to scan for — reconstructs bit for bit."""
    cfg, state0, step, bfn = port
    ps = _store(state0)
    key = "params/final_norm/scale"
    assert ps.covers(key)
    bad = _wipe_block(state0, ps, key, 0)
    report = FaultReport(0, "external", leaves=[key], shards={key: [0]})
    fixed, ev = _runtime(port, parity=ps).recover(bad, report, 0,
                                                  ladder=[RUNG_PARITY])
    assert ev.rung == RUNG_PARITY and ev.steps_replayed == 0
    assert ev.bytes_moved == 4 * ps.plan.block_sizes[key][0] > 0
    assert _bitwise_equal(fixed, state0)


def test_two_injured_shards_escalate(port):
    cfg, state0, step, bfn = port
    ps = _store(state0)
    key = "params/embed/table"
    bad = _wipe_block(_wipe_block(state0, ps, key, 0), ps, key, 2)
    report = FaultReport(0, "external", leaves=[key], shards={key: [0, 2]})
    rt = _runtime(port, parity=ps)
    with pytest.raises(RecoveryFailed):
        rt.recover(bad, report, 0, ladder=[RUNG_PARITY])
    assert "2 injured shards" in rt.events[-1].report.detail


def test_uncovered_leaf_aborts_up_front(port):
    cfg, state0, step, bfn = port
    rt = _runtime(port, parity=_store(state0))
    with pytest.raises(RecoveryFailed):
        rt.recover(state0, FaultReport(0, "external", leaves=["iv/step"]),
                   0, ladder=[RUNG_PARITY])
    assert "no injured leaf is parity-covered" in rt.events[-1].report.detail


def test_consumed_report_aborts(port):
    cfg, state0, step, bfn = port
    rt = _runtime(port, parity=_store(state0))
    with pytest.raises(RecoveryFailed):
        rt.recover(state0, FaultReport(0, "checksum",
                                       leaves=["params/embed/table"],
                                       consumed=True),
                   0, ladder=[RUNG_PARITY])
    assert "consumed" in rt.events[-1].report.detail


def test_parity_rung_reconstructs_lost_shard(port):
    """Twin of tests/test_recovery.py:125: block 1 of the embedding NaN-
    wiped, an external report naming only the leaf; with no canary the
    non-finite scan localises the block."""
    cfg, state0, step, bfn = port
    state = state0
    for s in range(2):
        state, _ = step(state, bfn(s))
    ps = ParityStore(state)
    ps.build(state, 2)
    key = "params/embed/table"
    bad = _wipe_block(state, ps, key, 1, value=float("nan"))
    fixed, ev = _runtime(port, parity=ps).recover(
        bad, FaultReport(2, "external", leaves=[key]), 2,
        ladder=["parity_xor"])
    assert ev.rung == "parity_xor" and ev.steps_replayed == 0
    assert ev.bytes_moved > 0
    assert torch.equal(fixed["params"]["embed"]["table"],
                       state["params"]["embed"]["table"])


# ---------------------------------------------------------------------------
# entry points: train --parity, serve --parity
# ---------------------------------------------------------------------------

def _train(tcfg, **kw):
    return tlaunch.train(tcfg, steps=13, global_batch=2, seq_len=32, seed=0,
                         snapshot_interval=4, canary_slices=1, verbose=False,
                         device="cpu", return_state=True, **kw)


def test_train_parity_storm_recovers_in_place_bitwise(port):
    """Flips at steps 4, 8 and 12 (seed 0): one is repaired in place by
    ``parity_xor``; the two whose trial reconstruction digest-collides
    (bits 25 and 23 in leaves of power-of-two block length) fall through
    to replay.  The final state equals the clean run's, bit for bit."""
    cfg = port[0]
    clean, clean_state = _train(cfg)
    out, state = _train(cfg, parity=True, inject_every=4)
    assert out["faults_injected"] == 3
    assert out["faults_detected"] == out["faults_injected"]
    assert out["faults_recovered"] == out["faults_detected"]
    assert out["recovery"]["by_rung"] == {"parity_xor": 1, "replay": 2}
    assert _bitwise_equal(state, clean_state)


def test_train_cli_parity_flag(capsys):
    out = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "13",
                        "--batch", "2", "--seq", "32", "--canary-slices",
                        "1", "--inject", "4", "--seed", "3", "--parity",
                        "--json"])
    assert out["faults_detected"] == out["faults_injected"] == \
        out["faults_recovered"] == 3
    assert out["recovery"]["by_rung"] == {"parity_xor": 3}
    assert out["recovery"]["mean_steps_replayed"] == 0.0
    assert '"parity_xor": 3' in capsys.readouterr().out


def test_serve_parity_scrub_repairs_the_flipped_param(port):
    cfg = port[0]
    out = tserve.serve(cfg, n_requests=2, prompt_len=8, gen_tokens=4,
                       seed=0, inject_every=3, verbose=False, device="cpu",
                       parity=True)
    par = out["parity"]
    assert par["repaired"] == 1 and par["failed"] == []
    assert par["checked"] == 11 and par["bytes_moved"] > 0
    jeng = JEngine(jget("iterpro-100m").smoke(), n_slots=2, max_len=13,
                   canary_slices=0, paged=True, parity=True)
    assert par["memory_bytes"] == jeng.scrub_params()["memory_bytes"]


def test_scrub_reports_clean_params_and_refuses_ambiguity(port):
    cfg = port[0]
    eng = ServingEngine(cfg, n_slots=1, max_len=16, canary_slices=0,
                        device="cpu", parity=True)
    assert eng.scrub_params()["repaired"] == 0
    eng.corrupt_param(random.Random(0), key="embed/table", bit=31)
    stats = eng.scrub_params()
    assert stats["repaired"] == 0 and stats["failed"] == ["embed/table"]


def test_corrupt_param_leaves_shared_params_untouched(port):
    cfg = port[0]
    a = ServingEngine(cfg, n_slots=1, max_len=16, canary_slices=0,
                      device="cpu", parity=True)
    b = ServingEngine(cfg, n_slots=1, max_len=16, canary_slices=0,
                      device="cpu", params=a.params)
    orig = _clone(a.params)
    key, bit = a.corrupt_param(random.Random(1), key="embed/table", bit=2)
    assert (key, bit) == ("embed/table", 2)
    assert not _bitwise_equal(a.params, orig)
    assert _bitwise_equal(b.params, orig)
    stats = a.scrub_params()
    assert (stats["repaired"], stats["failed"]) == (1, [])
    assert _bitwise_equal(a.params, orig)


def test_corrupt_param_and_scrub_need_parity(port):
    eng = ServingEngine(port[0], n_slots=1, max_len=16, canary_slices=0,
                        device="cpu")
    assert eng.parity_store is None
    with pytest.raises(ValueError):
        eng.corrupt_param(random.Random(0))
    with pytest.raises(ValueError):
        eng.scrub_params()
