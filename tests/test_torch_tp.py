"""Tensor-parallel compute on the CPU: the head and vocabulary ranges
against the spec boxes, and on two gloo ranks (a 1 x 2 mesh) the
parallel model against the single-device one, within the f32 tolerance.

* **Ranges** (no ranks): ``layers.heads_plan`` for every rank of model
  axes of 2, 4 and 8 against the ``wq``/``wk`` boxes of the spec rules
  (whole heads; GQA's groups kept inside a rank where both counts
  divide; a replicated ``wk/wv`` read at the heads the rank's query
  heads map to; query heads the axis does not divide: replicated
  attention), and ``DistContext.model_range`` equal to
  ``TensorParallel.span`` of the block.
* **On 1 x 2** (one spawn): the vocabulary-parallel cross-entropy
  against ``layers.cross_entropy``; ``train_loss`` and every gradient
  (the rank's blocks of the single-device gradients), ``prefill``,
  ``decode_step`` and ``prefill_chunk`` (logits and the whole caches)
  for a config whose heads all split (iterpro-100m), one with a
  replicated ``wk/wv`` (gemma3-1b: one KV head), one with replicated
  attention (three query heads), the two MoE configs, the xLSTM, hybrid,
  enc-dec and VLM smoke configs with every kind of block they have in
  two layers, and two where the axis divides neither the heads nor the
  vocabulary (``xlstm-heads3``: the sLSTM's pre-activations gathered, its
  ``r`` replicated; ``zamba2-heads3``: the shared block's attention
  replicated while its LoRA factors are cut); the three MoE
  mesh schedules against ``_moe_local_math`` with their gradients; the
  model axis's collectives counted; ``pipeline_apply`` over two stages
  against the sequential composition.
"""

import dataclasses

import numpy as np
import pytest
import torch

TOL = 2e-5


def _tp(size, rank):
    """A ``TensorParallel`` of model-axis rank ``rank`` on a shape-only
    1 x ``size`` context (no groups: the ranges need none)."""
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.tensor_parallel import TensorParallel
    tp = TensorParallel.__new__(TensorParallel)
    tp.ctx = dataclasses.replace(DistContext.for_shape(
        (1, size), ("data", "model")), rank=rank)
    tp.group, tp.size, tp.rank = None, size, rank
    return tp


def _box_range(sh, shard, dim):
    b = sh.box(shard)[dim]
    return (b.start or 0, sh.shape[dim] if b.stop is None else b.stop)


@pytest.mark.parametrize("tsize", [2, 4, 8])
@pytest.mark.parametrize("arch", ["iterpro-100m", "gemma3-1b",
                                  "h2o-danube-1.8b", "command-r-35b"])
def test_heads_plan_matches_the_spec_boxes(arch, tsize):
    """The heads a rank computes are the columns its ``wq``/``wk`` blocks
    hold; with a replicated ``wk`` it reads, for each query head h, KV
    head ``h // (H / KV)``; ``model_range`` reads the same ranges off the
    boxes."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import init_lm

    cfg = get_config(arch)
    m = cfg.model
    ctx0 = DistContext.for_shape((2, tsize), ("data", "model"))
    params = init_lm(m, 0, "meta")
    psh, _ = param_shardings(ctx0, cfg, params)
    attn = psh["groups"][0][0]["attn"]
    hd = m.resolved_head_dim
    H, KV = m.n_heads, m.n_kv_heads
    for r in range(tsize):
        ctx = dataclasses.replace(ctx0, rank=r)      # shard r: model r
        plan = L.heads_plan(m, _tp(tsize, r))
        lo, hi = _box_range(attn["wq"]["w"], r, 2)
        if H % tsize:
            assert plan is None and (lo, hi) == (0, H * hd), (arch, r)
            continue
        assert (lo // hd, hi // hd) == _tp(tsize, r).span(H // tsize)
        assert ctx.model_range(attn["wq"]["w"], 2) == (lo, hi)
        q = range(lo // hd, hi // hd)
        klo, khi = _box_range(attn["wk"]["w"], r, 2)
        if KV % tsize == 0:
            assert plan[0] and plan[1] == (klo // hd, khi // hd), (arch, r)
            assert all(h // (H // KV) in range(klo // hd, khi // hd)
                       for h in q)
            continue
        assert not plan[0] and (klo, khi) == (0, KV * hd), (arch, r)
        want = [h // (H // KV) for h in q]
        got = list(range(*plan[1])) if isinstance(plan[1], tuple) else \
            plan[1]
        # a contiguous range serves whole groups of query heads
        if isinstance(plan[1], tuple):
            per = len(q) // len(got)
            got = [got[i // per] for i in range(len(q))]
        assert got == want, (arch, r, plan)


def test_moe_param_specs_are_the_tp_capacity_layout():
    """``moe_param_specs`` (the reference's helper) gives the
    TP/capacity layout the spec rules give an MoE layer without expert
    parallelism, with and without fsdp."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.sharding import P
    from repro_torch.models import moe as M
    cfg = get_config("kimi-k2-1t-a32b").model
    for fsdp, d in ((False, None), (True, "data")):
        ctx = DistContext.for_shape((2, 4), ("data", "model"), fsdp=fsdp)
        sp = M.moe_param_specs(cfg, ctx)
        assert sp["gate"] == sp["up"] == P(None, d, "model")
        assert sp["down"] == P(None, "model", d)
        assert sp["router"]["w"] == P()
        assert sp["shared"]["down"]["w"] == P("model", None)


def test_vocab_and_ffn_ranges_are_the_boxes():
    """The embedding's vocabulary rows, the untied head's columns and the
    FFN columns a rank holds are ``span`` of its block's size."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models.transformer import init_lm

    cfg = get_config("command-r-35b")
    ctx0 = DistContext.for_shape((2, 4), ("data", "model"))
    params = init_lm(cfg.model, 0, "meta")
    psh, _ = param_shardings(ctx0, cfg, params)
    for r in range(4):
        ctx = dataclasses.replace(ctx0, rank=r)
        tp = _tp(4, r)
        V, ff = cfg.model.vocab_size, cfg.model.d_ff
        assert ctx.model_range(psh["embed"]["table"], 0) == tp.span(V // 4)
        assert ctx.model_range(psh["groups"][0][0]["ffn"]["gate"]["w"],
                               2) == tp.span(ff // 4)
        assert ctx.model_range(psh["groups"][0][0]["ffn"]["down"]["w"],
                               1) == tp.span(ff // 4)


# ---------------------------------------------------------------------------
# on two gloo ranks
# ---------------------------------------------------------------------------

ARCHS = ("iterpro-100m", "gemma3-1b", "heads3", "grok-1-314b",
         "kimi-k2-1t-a32b", "xlstm-350m", "zamba2-7b",
         "seamless-m4t-large-v2", "qwen2-vl-7b", "xlstm-heads3",
         "zamba2-heads3")

#: the recurrent families' smoke configs with every kind of block they
#: have in their two layers: xLSTM[1:1] (an mLSTM and an sLSTM block),
#: Zamba2 with the shared block after one Mamba-2 block
PATTERN = {"xlstm-350m": dict(mlstm_ratio=1), "zamba2-7b": dict(
    hybrid_ratio=1)}


def _cfg(arch):
    from repro_torch.configs import get_config
    if arch == "heads3":        # query heads the axis does not divide
        c = get_config("iterpro-100m").smoke()
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, n_heads=3, n_kv_heads=1))
    if arch == "xlstm-heads3":
        # the guard's replicated path in a recurrent family: 3 heads (the
        # sLSTM's w cut off whole heads, its r replicated), a vocabulary
        # of 255 (the embedding and head replicated); an mLSTM and an
        # sLSTM block
        c = get_config("xlstm-350m").smoke()
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, d_model=96, n_heads=3, n_kv_heads=3, vocab_size=255,
            mlstm_ratio=1, n_layers=2))
    if arch == "zamba2-heads3":
        # the shared block's attention replicated by the whole-heads rule
        # (3 query heads, 1 KV head) while its LoRA factors are cut by
        # width: the merged q/k/v columns and wo rows are the replicated
        # weight's slices plus the factors' blocks, gathered and summed
        c = get_config("zamba2-7b").smoke()
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, n_heads=3, n_kv_heads=1, vocab_size=255,
            hybrid_ratio=1))
    c = get_config(arch).smoke()
    if arch in PATTERN:
        c = dataclasses.replace(c, model=dataclasses.replace(
            c.model, **PATTERN[arch]))
    return c


def _batch(m, B, S, rng):
    """Tokens and targets, and a family's inputs: source frames (enc-dec),
    patches with their grid positions (VLM)."""
    tok = torch.from_numpy(rng.integers(0, m.vocab_size, (B, S)))
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    if m.n_enc_layers:
        batch["src_embeds"] = torch.from_numpy(
            rng.standard_normal((B, 6, m.frontend_dim)).astype(np.float32))
    if m.patch_dim:
        Np = 4
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, Np, m.patch_dim)).astype(np.float32))
        pos = np.zeros((B, Np + S, 3), np.int32)
        pos[:, :Np, 1] = np.arange(Np) // 2
        pos[:, :Np, 2] = np.arange(Np) % 2
        pos[:, Np:, :] = (2 + np.arange(S))[None, :, None]
        batch["positions"] = torch.from_numpy(pos)
    return batch


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


def _model_checks(ctx, tp, arch):
    """One config's forward, gradients and serving calls: the largest
    |parallel - single| of each, on this rank."""
    from repro_torch.distributed.sharding import local_tree
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models.registry import get_model
    from repro_torch.tree import (flatten_with_path, leaf_key, leaves,
                                  map_with_path)

    cfg = _cfg(arch)
    m = cfg.model
    model = get_model(m)
    full = model.init(m, 0, "cpu")
    g = torch.Generator().manual_seed(1)
    for _, t in flatten_with_path(full):     # norms and biases non-zero
        if (t.dim() <= 2 and t.shape[-1] == m.d_model
                and t.numel() < 4096) or not t.any():
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    psh, _ = param_shardings(ctx, cfg, full)
    blocks = local_tree(full, psh)
    rng = np.random.default_rng(2)
    B, S = 2, 12
    batch = _batch(m, B, S, rng)
    tok = batch["tokens"]
    serve = {k: v for k, v in batch.items() if k != "targets"}
    out = {}

    def loss_grads(p, **kw):
        req = {leaf_key(q): t.detach().requires_grad_(True)
               for q, t in flatten_with_path(p)}
        tree = map_with_path(lambda q, _: req[leaf_key(q)], p)
        loss, _ = model.train_loss(tree, m, batch, remat=False, **kw)
        grads = torch.autograd.grad(loss, list(req.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(req, grads))

    l1, g1 = loss_grads(full)
    l2, g2 = loss_grads(blocks, tp=tp)
    out["loss"] = _err(l1, l2)
    shs = {leaf_key(q): sh for q, sh in flatten_with_path(psh)}
    # a key bias's gradient is zero in exact arithmetic (the softmax is
    # invariant to a shift of a query's scores): its rounding noise is
    # held against the model's gradient scale, not its own
    top = max(float(t.abs().max()) for t in g1.values())
    out["grads"] = max(_err(shs[k].local(g1[k]), g2[k]) / max(
        top if k.endswith("wk/b") else float(g1[k].abs().max()), 1e-6)
        for k in g1)
    with torch.no_grad():
        lg1, c1 = model.prefill(full, m, serve, max_len=S + 8)
        lg2, c2 = model.prefill(blocks, m, serve, max_len=S + 8, tp=tp)
        out["prefill"] = _err(lg1, lg2)
        out["cache"] = max(_err(a, b) for a, b in zip(
            leaves(c1), leaves(c2)))
        nt = lg1.argmax(-1).to(torch.int32)
        d1, c1 = model.decode_step(full, m, c1, nt)
        d2, c2 = model.decode_step(blocks, m, c2, nt, tp=tp)
        out["decode"] = _err(d1, d2)
        out["decode_cache"] = max(_err(a, b) for a, b in zip(
            leaves(c1), leaves(c2)))
        if not hasattr(model, "prefill_chunk") or m.m_rope:
            return out
        ctx_cache = {"groups": [[{n: v[n][:, :, :S] for n in ("k", "v")}
                                 for v in grp] for grp in c1["groups"]]}
        kpos = torch.arange(S, dtype=torch.int32)[None, :]
        chunk = {"tokens": tok[:, :4]}
        p1, n1 = model.prefill_chunk(full, m, chunk, ctx_cache, kpos, S, 3)
        p2, n2 = model.prefill_chunk(blocks, m, chunk, ctx_cache, kpos, S,
                                     3, tp=tp)
        out["chunk"] = _err(p1, p2)
        out["chunk_kv"] = max(_err(a, b) for a, b in zip(
            leaves(n1), leaves(n2)))
    return out


def _moe_checks(ctx, tp):
    """The three mesh schedules on every expert block layout against the
    local math over the same tokens (capacity 8: nothing dropped), and
    the gradients of the rank's blocks."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import P, LeafSharding
    from repro_torch.models import moe as M

    base = get_config("kimi-k2-1t-a32b").smoke().model
    out = {}
    for impl in ("tp_ragged", "ep_a2a", "ep_token_a2a"):
        cfg = dataclasses.replace(base, moe_impl=impl, moe_capacity=8.0,
                                  n_shared_experts=0)
        gen = torch.Generator().manual_seed(0)
        p = {k: (v[0] if k != "router" else {"w": v["w"][0]})
             for k, v in M.moe_init(gen, cfg, torch.float32, "cpu",
                                    1).items()}
        x = torch.randn((2, 8, cfg.d_model), generator=gen)
        ep = M.use_ep(cfg, ctx)
        specs = {"gate": P("model", None, None) if ep else
                 P(None, None, "model"),
                 "up": P("model", None, None) if ep else
                 P(None, None, "model"),
                 "down": P("model", None, None) if ep else
                 P(None, "model", None)}
        mine = {"router": p["router"]}
        for k, s in specs.items():
            mine[k] = LeafSharding(ctx, s, tuple(p[k].shape),
                                   p[k].dtype).local(p[k])
        req = {k: (v.requires_grad_(True) if k != "router" else v)
               for k, v in mine.items()}
        y, aux = M.moe_apply(req, cfg, x, tp=tp)
        full = {k: (v.clone().requires_grad_(True) if k != "router" else v)
                for k, v in p.items()}
        y1, aux1 = M._moe_local_math(x.reshape(-1, cfg.d_model), full, cfg)
        (y * y).sum().backward()
        (y1 * y1).sum().backward()
        gerr = max(_err(LeafSharding(ctx, specs[k], tuple(p[k].shape),
                                     p[k].dtype).local(full[k].grad),
                        req[k].grad) / float(full[k].grad.abs().max())
                   for k in specs)
        lb1 = aux1["lb_loss"]
        if impl == "ep_token_a2a":
            # each rank's term over its own rows, averaged over the axis
            # (the reference's pmean): the local math's over each half
            xs = x.reshape(-1, cfg.d_model).chunk(tp.size)
            lb1 = sum(M._moe_local_math(h, full, cfg)[1]["lb_loss"]
                      for h in xs) / tp.size
        out[impl] = {"ep": ep, "y": _err(y.reshape(-1, cfg.d_model), y1),
                     "lb": _err(aux["lb_loss"], lb1),
                     "grads": gerr}
    return out


def _pipe_check():
    """Two stages (the two ranks as a stage axis), 3 microbatches."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.pipeline import pipeline_apply

    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("stage",))
    ctx = DistContext.for_mesh(mesh, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    Sg, M_, B, d = 2, 3, 2, 8
    params = {"w": torch.randn((Sg, d, d), generator=gen) * 0.3,
              "b": torch.randn((Sg, d), generator=gen) * 0.1}
    xs = torch.randn((M_, B, d), generator=gen)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    want = xs
    for i in range(Sg):
        want = stage_fn({"w": params["w"][i], "b": params["b"][i]}, want)
    return _err(pipeline_apply(stage_fn, params, xs, ctx, axis="stage"),
                want)


def _ranks():
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.mesh import make_context
    torch.manual_seed(0)
    ctx = make_context("1,2", torch.device("cpu"))
    tp = TP.for_model(ctx, _cfg("iterpro-100m").model)
    res = {"tp_rank": ctx.tp_rank,
           # every family computes on the model axis
           "families": {a: TP.for_model(ctx, _cfg(a).model) is not None
                        for a in ARCHS}}
    # the vocabulary-parallel cross-entropy's reductions on a chunk
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(4)
    logits = torch.randn((2, 5, 16), generator=gen) * 3
    t = torch.randint(0, 16, (2, 5), generator=gen)
    lo, hi = tp.span(8)
    logz, ll = TP.vocab_logsumexp_and_target(logits[..., lo:hi], t, lo, tp)
    res["ce"] = _err((logz - ll).mean(), L.cross_entropy(logits, t))
    TP.CALLS.clear()
    res["models"] = {a: _model_checks(ctx, tp, a) for a in ARCHS}
    res["calls"] = dict(TP.CALLS)
    res["moe"] = _moe_checks(ctx, tp)
    res["pipe"] = _pipe_check()
    return res


@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.mesh import spawn
    return spawn(_ranks, (1, 2), device="cpu")


def test_vocab_parallel_cross_entropy_matches_the_whole_vocabulary(ranks):
    assert [r["tp_rank"] for r in ranks] == [0, 1]
    assert all(all(r["families"].values()) for r in ranks), ranks[0]
    for r in ranks:
        assert r["ce"] <= TOL, r["ce"]


@pytest.mark.parametrize("arch", ARCHS)
def test_parallel_model_matches_one_device(ranks, arch):
    """The loss, every gradient (the rank's blocks of one device's,
    relative to the leaf's largest), prefill and decode logits, the
    whole caches after each, and a prefill chunk's logits and new rows
    within the f32 tolerance on both ranks."""
    for r in ranks:
        got = r["models"][arch]
        assert all(v <= TOL for v in got.values()), (arch, got)


def test_model_axis_collectives_are_counted(ranks):
    """The forward's sums and the backward's gathers both ran, the same
    number on each rank (gloo pairs calls by their order)."""
    c = ranks[0]["calls"]
    assert c["reduce_sum"] > 0 and c["copy_in/backward"] > 0, c
    assert c["gather_cat"] > 0, c
    assert ranks[1]["calls"] == c


@pytest.mark.parametrize("impl", ["tp_ragged", "ep_a2a", "ep_token_a2a"])
def test_moe_mesh_schedules_match_the_local_math(ranks, impl):
    for r in ranks:
        got = r["moe"][impl]
        assert got["ep"] == (impl != "tp_ragged"), got
        assert got["y"] <= TOL and got["lb"] <= TOL, got
        assert got["grads"] <= TOL, got


def test_pipeline_matches_the_sequential_stages(ranks):
    for r in ranks:
        assert r["pipe"] <= 1e-5, r["pipe"]
