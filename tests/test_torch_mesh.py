"""The port's mesh layer on the CPU: specs against the JAX package, and the
resilient loop on gloo ranks (one torch thread each).

* **Specs** — the port's ``param_specs`` / ``opt_state_specs`` for the
  iterpro-100m, command-r-35b (fsdp), kimi-k2-1t-a32b (expert-parallel
  storage) and zamba2-7b (LoRA, per-head vectors) smoke configs, with
  AdamW f32 / int8 and Adafactor state, equal the reference's on an
  ``AbstractMesh((4, 2))`` (spec generation needs no devices) and on a
  ``("data",)`` mesh, where no spec names ``model``.
* **Storms** on 4 x 2 (8 ranks): a params flip every step (the even
  step's repaired by ``shard_patch``; the odd ones have no
  version-matched snapshot: ``replay``) and an ``iv`` storm (``eq1``)
  end bitwise equal to the clean run; fsdp and expert-parallel layouts
  train (command-r-35b within 2e-5 of one device); a steady check is 1
  launch + 1 fetch on every rank; a partial refresh keeps the
  generation; a mesh checkpoint round trip.
* **Tensor-parallel compute** (in the same spawn): iterpro-100m and
  gemma3-1b (one KV head: ``wk/wv`` replicated by the guard) on 4 x 2
  within 2e-5 of one device, gemma3-1b's storm == clean, every leaf
  replicated over the model axis bitwise equal on the model-axis peers;
  the serving runs read the blocks in place (no params gather but the
  fsdp leaves' over the batch axes).  The ssm, hybrid, encdec and vlm
  families (``FAMILIES``: xlstm-350m, zamba2-7b, seamless, qwen2-vl) on
  4 x 2: a bound step gathers only fsdp leaves over ``data``, a params
  storm == clean bitwise, the state within 2e-5 of one device's, the
  replicated leaves bitwise on the model-axis peers; each served under a
  storm (``SERVE_RUNS``) with the tokens of one device's engine and the
  decode cache bitwise on the model-axis peers.
* **1 x 2** (data width 1): the rank's blocks updated from one device's
  grads bitwise one device's update of them; the trajectory within 2e-5
  of one device's (tensor-parallel sums round otherwise).
* **The CLI**: ``train --mesh 4,2 --device cpu --smoke``.
* **The modes** (in the same spawn): the donated mesh step bitwise the
  functional one with every ``data_ptr`` kept (AdamW f32; Adafactor on
  kimi-k2-1t-a32b), the fused mesh step's ``(K, K)`` over K steady steps,
  storms == clean under ``--donate`` and ``--donate --fused-detect``,
  each with and without ``--parity``, a flip in one replica of a block
  escalating past triage, the CLI with every combination of the four
  mode flags.
* **Elastic hard loss** (in the same spawn): the CLI's drill, 4 x 2 ->
  3 x 2 before step 3 of 6, functional and ``--donate --fused-detect``;
  an ``on_loss`` of row 0 (world rank 2 becomes shard 0); two losses in
  one process, 4 x 2 -> 3 x 2 -> 2 x 2, with no plan, canary unit or
  fused unit of an older context left.  The dead ranks poison their
  blocks once the test's oracle read them; every survivor's state is
  bitwise the oracle's, its losses bitwise a clean run on the degraded
  mesh from the oracle, a steady check (1, 1), and after the loss no
  survivor makes a collective on WORLD.
* **Mesh serving** (in the same spawn, before the elastic drills):
  ``ServingEngine(ctx=...)`` at the iterpro-100m smoke — paged, donated,
  K=4, ``parity`` under an armed storm, then ``corrupt_param`` +
  ``scrub_params``; dense ping-pong; paged with ``prefill_chunk``; a
  storm placed in rank 5's replica only; kimi-k2-1t-a32b (fsdp +
  expert-parallel blocks) with parity, a storm and a scrub — every
  rank's token logs bitwise the single-device engine's over the same
  params, detected == injected == recovered, 0 dropped, a steady step
  ``STATS`` (1, 1), each rank's blocks after the scrub bitwise their
  bits before the flip, ``evict_mesh`` counting the engine's entries;
  ``serve(mesh=...)`` and the CLI inside the ranks; ``gather_tree(out=)``
  equal to ``gather_tree()`` with every pointer kept.
* **Refusals**: ``relower_degraded`` raises naming its ROADMAP item.
"""

import dataclasses

import numpy as np
import pytest
import torch

SMOKE = dict(steps=4, global_batch=8, seq_len=32, canary_slices=1,
             snapshot_interval=2, device="cpu", verbose=False,
             return_state=True)
ARCHS = ["iterpro-100m", "command-r-35b", "kimi-k2-1t-a32b", "zamba2-7b"]
OPTS = {"adamw-f32": dict(optimizer="adamw", moment_dtype="float32"),
        "adamw-int8": dict(optimizer="adamw", moment_dtype="int8"),
        "adafactor": dict(optimizer="adafactor", moment_dtype="float32")}
MESHES = {"4x2": ((4, 2), ("data", "model")), "4": ((4,), ("data",))}


def _with_opt(cfg, opt):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **OPTS[opt]))


def _bitwise(a, b):
    from repro_torch.tree import flatten_with_path, leaf_key
    fa = {leaf_key(p): t for p, t in flatten_with_path(a)}
    fb = {leaf_key(p): t for p, t in flatten_with_path(b)}
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


# ---------------------------------------------------------------------------
# specs against the reference (in process, no devices)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, opt, mesh):
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec as JP
    from repro.configs import get_config as jcfg
    from repro.distributed import sharding as jsh
    from repro.distributed.context import DistContext as JCtx
    from repro.kernels.ops import leaf_key as jkey
    from repro.launch.specs import state_struct
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.specs import state_shardings
    from repro_torch.train.loop import make_train_state
    from repro_torch.tree import flatten_with_path, leaf_key

    shape, axes = MESHES[mesh]
    jc = _with_opt(jcfg(arch).smoke(), opt)
    jctx = JCtx.for_mesh(AbstractMesh(shape, axes), fsdp=jc.sharding.fsdp)
    st = state_struct(jc, 8)
    jp = jsh.param_specs(jctx, st["params"], jc.sharding, jc.model)
    jo = jsh.opt_state_specs(jctx, st["params"], jp, jc.train)
    want = {}
    for name, tree in (("params", jp), ("opt", jo)):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]
        want.update({f"{name}/{jkey(p)}": tuple(s) for p, s in flat})

    tc = _with_opt(get_config(arch).smoke(), opt)
    ctx = DistContext.for_shape(shape, axes, fsdp=tc.sharding.fsdp)
    state = make_train_state(tc, 0, global_batch=8, device="meta")
    _, specs = state_shardings(ctx, tc, state)
    got = {leaf_key(p): tuple(s) for p, s in flatten_with_path(specs)
           if not leaf_key(p).startswith("iv/")}
    assert got == want
    if mesh == "4":
        assert not any("model" in str(s) for s in got.values())
    else:
        assert any(s for s in got.values())     # something is sharded


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, mesh):
    """The serving engine's ``param_shardings`` of a bare param tree:
    specs equal the reference's ``launch/specs.param_shardings`` on an
    ``AbstractMesh``, and each ``LeafSharding`` carries the leaf's global
    shape and dtype."""
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec as JP
    from repro.configs import get_config as jcfg
    from repro.distributed.context import DistContext as JCtx
    from repro.kernels.ops import leaf_key as jkey
    from repro.launch.specs import param_shardings as jparam_shardings
    from repro.launch.specs import params_struct
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models.registry import get_model
    from repro_torch.tree import flatten_with_path, leaf_key

    shape, axes = MESHES[mesh]
    jc = jcfg(arch).smoke()
    jctx = JCtx.for_mesh(AbstractMesh(shape, axes), fsdp=jc.sharding.fsdp)
    _, jspecs = jparam_shardings(jctx, jc, params_struct(jc))
    want = {jkey(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JP))[0]}

    tc = get_config(arch).smoke()
    params = get_model(tc.model).init(tc.model, 0, "meta")
    ctx = DistContext.for_shape(shape, axes, fsdp=tc.sharding.fsdp)
    sh, specs = param_shardings(ctx, tc, params)
    assert {leaf_key(p): tuple(s) for p, s in
            flatten_with_path(specs)} == want
    for (_, t), (_, s) in zip(flatten_with_path(params),
                              flatten_with_path(sh)):
        assert (s.shape, s.dtype) == (tuple(t.shape), t.dtype)


def test_boxes_tile_every_leaf_once():
    """Every element of a leaf lies in the box of exactly the shards that
    differ only along the axes its spec does not name, and
    ``local_index`` inverts the box."""
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.sharding import LeafSharding, P

    ctx = DistContext.for_shape((4, 2), ("data", "model"))
    for spec, shape in [(P("data", None), (8, 6)), (P(None, "model"), (3, 4)),
                        (P(("data", "model"),), (16,)),
                        (P("model", "data"), (4, 8)), (P(), ())]:
        sh = LeafSharding(ctx, spec, shape, torch.float32)
        cover = np.zeros(shape, np.int64)
        for d in range(8):
            cover[sh.box(d)] += 1
        assert (cover == 8 // ctx.axis_size(spec.axes())).all(), spec


def test_parse_mesh_and_backend_rule():
    from repro_torch.distributed.collectives import choose_backend
    from repro_torch.launch.mesh import parse_mesh
    assert parse_mesh("4,2") == ((4, 2), ("data", "model"))
    assert parse_mesh("4") == ((4,), ("data",))
    assert parse_mesh("2x4x2") == ((2, 4, 2), ("pod", "data", "model"))
    assert parse_mesh(None) == (None, None)
    with pytest.raises(ValueError):
        parse_mesh("1,2,3,4")
    # NCCL refuses two ranks on one card: 4 ranks on 1 card share it over
    # gloo; a card each takes nccl; the CPU is always gloo
    assert choose_backend("cuda", 4, 1) == "gloo"
    assert choose_backend("cuda", 4, 4) == "nccl"
    assert choose_backend("cpu", 8, 0) == "gloo"


def test_mesh_modes_of_later_slices_raise(storms):
    """Every mesh mode of the later slices runs (the name is kept from
    when some raised): the degraded-mesh re-trace of the dry-run tooling
    returns an ``ok`` record; mesh serving (item 6.4) serves: ``serve
    --mesh 4,2`` ran inside the spawn's ranks, and
    ``invalidate_mesh_caches`` reports the serving engines it drops."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.elastic import (invalidate_mesh_caches,
                                            relower_degraded)

    cfg = get_config("iterpro-100m").smoke()
    assert all(r["serving"]["serve"]["mesh"]["devices"] == 8
               for r in storms)
    got = invalidate_mesh_caches(DistContext.for_shape((4, 2),
                                                       ("data", "model")))
    assert got["serving"] == 0, got
    rec, ctx, _ = relower_degraded(cfg, get_shape("decode_32k"))
    assert rec["status"] == "ok", rec
    assert ctx.shape == {"data": 15, "model": 16}


# ---------------------------------------------------------------------------
# the resilient loop on 8 gloo ranks (one spawn for the module)
# ---------------------------------------------------------------------------

def _full(cfg, mesh, local):
    """The whole state from every rank's blocks ``local`` (collective)."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import state_shardings
    from repro_torch.train.loop import make_train_state
    ctx = make_context(mesh, torch.device("cpu"))
    sh, _ = state_shardings(ctx, cfg, make_train_state(
        cfg, 0, global_batch=8, device="meta"))
    return gather_tree(local, sh)


def _max_rel_err(a, b):
    """The largest |a - b| of any float leaf over that leaf's largest
    |b|."""
    from repro_torch.tree import flatten_with_path, leaf_key
    fb = {leaf_key(p): t for p, t in flatten_with_path(b)}
    err = 0.0
    for p, t in flatten_with_path(a):
        ref = fb[leaf_key(p)]
        if t.is_floating_point():
            scale = max(float(ref.abs().max()), 1e-30)
            err = max(err, float((t.double() - ref.double()).abs().max())
                      / scale)
    return err


def _storm_ranks(ckpt_dir):
    from repro_torch.checkpoint.store import CheckpointManager, \
        load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import bind_state
    from repro_torch.launch.train import train
    from repro_torch.train.loop import make_train_state, make_train_step

    cfg = get_config("iterpro-100m").smoke()
    # params: a flip every step; steps 1 and 3 have no snapshot of their
    # version (replay), step 2 has (shard_patch)
    runs = {"clean": train(cfg, mesh="4,2", **SMOKE),
            "params": train(cfg, mesh="4,2", inject_every=1, **SMOKE),
            "iv": train(cfg, mesh="4,2", inject_every=2,
                        inject_target="iv", **SMOKE)}
    # each rank holds its own blocks of every run's final state
    same = {n: _bitwise(st, runs["clean"][1]) for n, (_, st) in runs.items()}
    summaries = {n: out for n, (out, _) in runs.items()}

    ctx = make_context("4,2", torch.device("cpu"))
    pipe = TokenPipeline(cfg.model.vocab_size, 32, 8, seed=0)
    state, step, bfn, sh = bind_state(
        ctx, cfg, make_train_state(cfg, 0, global_batch=8),
        make_train_step(cfg, global_batch=8), pipe.batch_at)
    canary = ChecksumCanary(state, n_slices=3, ctx=ctx)
    from repro_torch.distributed import sharding
    sharding.GATHERS.clear()
    ns, _ = step(state, bfn(0))
    # tensor-parallel: the step reads the rank's blocks, no params gather;
    # an fsdp config's step gathers those leaves over the batch axes only
    gathers = {"iterpro-100m": dict(sharding.GATHERS)}
    c = get_config("command-r-35b").smoke()
    cst, cstep, cbfn, _ = bind_state(
        ctx, c, make_train_state(c, 0, global_batch=8),
        make_train_step(c, global_batch=8),
        TokenPipeline(c.model.vocab_size, 32, 8, seed=0).batch_at)
    sharding.GATHERS.clear()
    cstep(cst, cbfn(0))
    gathers["command-r-35b"] = dict(sharding.GATHERS)
    del cst
    kd.STATS.reset()
    steady = canary.check_and_arm(0, state, ns) is None
    stats = kd.STATS.snapshot()
    gen = canary.generation
    canary.refresh(ns, keys=[canary._keys[0]])
    partial = canary.generation == gen and \
        canary.check_and_arm(1, ns, ns) is None

    # fsdp specs (command-r-35b: blocks that differ across the data
    # peers) against one device; fsdp + expert-parallel storage with
    # Adafactor's factored bf16 stats (kimi-k2-1t-a32b: the update of
    # the whole tree, then the rank's blocks), a params storm == clean
    kw = dict(SMOKE, steps=2)
    others = {}
    for arch in ("command-r-35b", "kimi-k2-1t-a32b"):
        c = get_config(arch).smoke()
        out, local = train(c, mesh="4,2", **kw)
        storm, st = train(c, mesh="4,2", inject_every=1, **kw)
        others[arch] = {"out": out, "storm": storm,
                        "storm_same": _bitwise(st, local)}
        if arch == "command-r-35b":
            one, single = train(c, **kw)
            others[arch]["one"] = one
            others[arch]["err"] = _max_rel_err(
                _full(c, "4,2", local), single)

    # tensor-parallel against one device: iterpro-100m (every projection
    # split) and gemma3-1b (one KV head: wk/wv replicated by the guard);
    # the model-axis peers' replicated leaves bitwise equal
    tp = {"iterpro-100m": {
        "err": _state_close(_full(cfg, "4,2", runs["clean"][1]),
                            train(cfg, **SMOKE)[1]),
        "peers": all(_peers_equal(ctx, cfg, st)
                     for _, st in runs.values())}}
    c = get_config("gemma3-1b").smoke()
    out, local = train(c, mesh="4,2", **kw)
    storm, st = train(c, mesh="4,2", inject_every=1, **kw)
    one, single = train(c, **kw)
    tp["gemma3-1b"] = {"out": out, "storm": storm, "one": one,
                       "storm_same": _bitwise(st, local),
                       "err": _state_close(_full(c, "4,2", local), single),
                       "peers": _peers_equal(ctx, c, local)
                       and _peers_equal(ctx, c, st)}

    # the ssm, hybrid, encdec and vlm families on 4 x 2, tensor-parallel:
    # one bound step's gathers, clean == storm bitwise, one device within
    # 2e-5, the replicated leaves bitwise on the model-axis peers
    from repro_torch.launch.train import batch_for
    fam = {}
    for arch in FAMILIES:
        c = _family_cfg(arch)
        fpipe = TokenPipeline(c.model.vocab_size, 32, 8, seed=0)
        fst, fstep, fbfn, _ = bind_state(
            ctx, c, make_train_state(c, 0, global_batch=8),
            make_train_step(c, global_batch=8),
            lambda s, c=c, fp=fpipe: batch_for(c, fp, s))
        sharding.GATHERS.clear()
        fstep(fst, fbfn(0))
        del fst
        gathered = dict(sharding.GATHERS)
        out, local = train(c, mesh="4,2", **kw)
        storm, st = train(c, mesh="4,2", inject_every=1, **kw)
        one, single = train(c, **kw)
        fam[arch] = {"gathers": gathered, "out": out, "storm": storm,
                     "one": one, "storm_same": _bitwise(st, local),
                     "err": _state_close(_full(c, "4,2", local), single),
                     "peers": _peers_equal(ctx, c, local)
                     and _peers_equal(ctx, c, st)}

    ckpt = CheckpointManager(ckpt_dir, interval=1, ctx=ctx, shardings=sh)
    ckpt.save(3, ns)
    back, at = ckpt.restore(ns)
    round_trip = at == 3 and _bitwise(back, ns)
    full = gather_tree(ns, sh)
    on_disk = load_checkpoint(ckpt_dir, full)[0]
    return {"steady": steady, "stats": stats, "partial": partial,
            "round_trip": round_trip, "on_disk": _bitwise(on_disk, full),
            "same": same, "summaries": summaries, "others": others,
            "tp": tp, "gathers": gathers, "families": fam,
            "serving": _serve_ranks(ctx),
            "modes": _mode_ranks(ctx, cfg, runs["clean"][1]),
            "elastic": _elastic_ranks(cfg)}


def _peers_equal(ctx, cfg, local):
    """Every leaf the spec does not shard over the model axis holds the
    same bits on this rank and its model-axis peers (collective)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.specs import state_shardings
    from repro_torch.train.loop import make_train_state
    from repro_torch.tree import leaves
    sh, _ = state_shardings(ctx, cfg, make_train_state(
        cfg, 0, global_batch=8, device="meta"))
    mine = [t.reshape(-1).view(torch.uint8)
            for t, s in zip(leaves(local), leaves(sh))
            if ctx.model_axis not in s.axes]
    rows = coll.all_gather(torch.cat(mine), ctx.group(ctx.model_axis))
    return all(torch.equal(rows[0], r) for r in rows[1:])


#: the ssm, hybrid, encdec and vlm families at the smoke size with every
#: kind of block they have in two layers (xLSTM[1:1]: an mLSTM and an
#: sLSTM block; Zamba2: a Mamba-2 block and the shared block with its
#: LoRA; the enc-dec's 2 + 2 layers with cross-attention; the VLM's
#: patches and m-rope)
FAMILIES = {"xlstm-350m": dict(mlstm_ratio=1),
            "zamba2-7b": dict(hybrid_ratio=1),
            "seamless-m4t-large-v2": {}, "qwen2-vl-7b": {}}


def _family_cfg(arch):
    from repro_torch.configs import get_config
    c = get_config(arch).smoke()
    return dataclasses.replace(c, model=dataclasses.replace(
        c.model, **FAMILIES[arch]))


# -- mesh serving (in the same spawn) -------------------------------------------

#: the serving scenarios: (arch, engine flags, storm cadence, scrub).
#: Every run serves SERVE_REQS requests of SERVE_PROMPT tokens, SERVE_GEN
#: new tokens each, through 4 slots
SERVE_REQS, SERVE_PROMPT, SERVE_GEN = 4, 8, 6
SERVE_RUNS = {
    "paged+parity": ("iterpro-100m", dict(donate=True, parity=True), 3,
                     True),
    "dense": ("iterpro-100m", dict(donate=False, paged=False), 3, False),
    "chunked": ("iterpro-100m", dict(donate=True, prefill_chunk=3), 3,
                False),
    "rank5": ("iterpro-100m", dict(donate=True), 3, False),
    "kimi": ("kimi-k2-1t-a32b", dict(donate=True, parity=True), 3, True),
    "gemma3": ("gemma3-1b", dict(donate=True), 3, False),
    # the recurrent, enc-dec and VLM families (dense slot-major caches;
    # the VLM's requests carry 4 patches: 4 more rows)
    "xlstm": ("xlstm-350m", dict(donate=True), 3, False),
    "zamba2": ("zamba2-7b", dict(donate=True), 3, False),
    "seamless": ("seamless-m4t-large-v2", dict(donate=True), 3, False),
    "qwen2-vl": ("qwen2-vl-7b", dict(donate=True, max_len=SERVE_PROMPT
                                     + SERVE_GEN + 5), 3, False),
}
#: the patches of a VLM request
SERVE_PATCHES = 4
#: the shard whose replica alone takes the "rank5" run's flips
ONE_RANK = 5


def _serve_requests(cfg):
    """The scenario's requests; a VLM's each with ``SERVE_PATCHES``
    patches on a grid at t = 0 and its text from 2 on all three
    streams."""
    from repro_torch.launch.serve import make_requests
    rng = np.random.default_rng(0)
    reqs = make_requests(cfg, SERVE_REQS, SERVE_PROMPT, SERVE_GEN, rng)
    m = cfg.model
    if m.patch_dim:
        for rq in reqs:
            n = SERVE_PATCHES
            pos = np.zeros((1, n + SERVE_PROMPT, 3), np.int32)
            pos[0, :n, 1], pos[0, :n, 2] = np.arange(n) // 2, np.arange(n) % 2
            pos[0, n:, :] = (2 + np.arange(SERVE_PROMPT))[:, None]
            rq.features = {"patch_embeds": rng.standard_normal(
                (1, n, m.patch_dim), dtype=np.float32), "positions": pos}
    return reqs


def _cache_peers(ctx, eng):
    """Every leaf of the engine's decode cache (the recurrent states, the
    K/V, the cross-attention memory) holds the same bits on the model-axis
    peers (collective)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.tree import leaves
    mine = torch.cat([t.reshape(-1).view(torch.uint8)
                      for t in leaves(eng.cache)])
    rows = coll.all_gather(mine, ctx.group(ctx.model_axis))
    return all(torch.equal(rows[0], r) for r in rows[1:])


def _serve_one(ctx, name):
    """One serving scenario on this rank: the mesh engine's run (and
    scrub), its faults as every rank saw them, a steady step's STATS, and
    on shard 0 the single-device engine's clean logs over the same
    (gathered) params."""
    import random
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import digest as kd
    from repro_torch.serving import ServingEngine
    from repro_torch.tree import leaves

    from repro_torch.distributed.sharding import gather_tree
    arch, kw, every, scrub = SERVE_RUNS[name]
    kw = dict(kw)
    max_len = kw.pop("max_len", SERVE_PROMPT + SERVE_GEN + 1)
    cfg = _family_cfg(arch) if arch in FAMILIES else \
        get_config(arch).smoke()
    eng = ServingEngine(cfg, n_slots=4, ctx=ctx, device="cpu", seed=0,
                        max_len=max_len, canary_slices=4,
                        max_replays=10**6, **kw)
    faults = []
    handle = eng.handle_fault

    def spy(report, finite, now, queue):
        victims = handle(report, finite, now, queue)
        faults.append((eng.step_count, None if report is None else
                       (report.leaves, report.shards), list(victims)))
        return victims
    eng.handle_fault = spy
    if name == "rank5":
        flip = eng.corrupt_slot
        eng.corrupt_slot = lambda rng, **k: flip(rng, ranks=[ONE_RANK], **k)
    rng = random.Random(0)
    eng.warm()
    sharding.GATHERS.clear()
    TP.CALLS.clear()
    rep = eng.run(_serve_requests(cfg), inject_every=every, inject_rng=rng)
    out = {"logs": {rid: r["tokens"] for rid, r in rep.per_request.items()},
           "summary": rep.summary(), "faults": faults,
           # tensor-parallel: the model reads the blocks in place; only
           # fsdp leaves are gathered (over the batch axes), each call
           "tp": eng.params is eng.blocks and eng._whole is None,
           "gathers": dict(sharding.GATHERS), "tp_calls": dict(TP.CALLS),
           "cache_peers": _cache_peers(ctx, eng) if not eng.paged
           else None}
    kd.STATS.reset()
    eng.engine_step()
    out["stats"] = kd.STATS.snapshot()
    if scrub:
        before = [t.clone() for t in leaves(eng.blocks)]
        out["flip"] = eng.corrupt_param(rng)
        out["flipped"] = any(not torch.equal(a, b) for a, b in
                             zip(leaves(eng.blocks), before))
        out["scrub"] = eng.scrub_params()
        plan = eng.parity_store.plan
        key = out["flip"][0]
        sh = dict(zip(plan.keys, plan.leaves(eng._psh)))[key]
        out["expect_moved"] = sh.nbytes_local * len(plan.block_devices(
            key, plan.device_block[key][ctx.shard_id]))
        out["healed"] = all(
            torch.equal(a.view(-1).view(torch.uint8),
                        b.view(-1).view(torch.uint8))
            for a, b in zip(leaves(eng.blocks), before))
    # the whole params from every rank's blocks (a collective)
    full = gather_tree(eng.blocks, eng._psh)
    if ctx.shard_id == 0:
        flags = {k: v for k, v in kw.items() if k in ("paged",
                                                     "prefill_chunk")}
        one = ServingEngine(cfg, n_slots=4, device="cpu", canary_slices=0,
                            max_len=max_len, params=full, **flags)
        out["single"] = {rid: r["tokens"] for rid, r in
                         one.run(_serve_requests(cfg)).per_request.items()}
    return eng, out


def _serve_ranks(ctx):
    """This rank's share of the mesh serving scenarios."""
    import gc
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving.engine import evict_mesh
    from repro_torch.tree import leaves, tree_map

    res = {}
    for name in SERVE_RUNS:
        eng, res[name] = _serve_one(ctx, name)
        del eng
    gc.collect()
    # evict_mesh closes the live engines of this mesh: the last one's
    # graphs (none on the CPU), cores and gathered storage
    eng, _ = _serve_one(ctx, "dense")
    full = gather_tree(eng.blocks, eng._psh)
    # fixed whole-params storage, as a whole-params family's engine keeps
    whole = tree_map(lambda b, sh: b if not sh.axes else torch.empty(
        sh.shape, dtype=sh.dtype), eng.blocks, eng._psh)
    gather_tree(eng.blocks, eng._psh, out=whole)
    ptrs = [t.data_ptr() for t in leaves(whole)]
    gather_tree(eng.blocks, eng._psh, out=whole)
    res["gather_out"] = {
        "ptrs": ptrs == [t.data_ptr() for t in leaves(whole)],
        "same": _bitwise(whole, full),
        # a replicated leaf of the storage is the rank's block itself
        "aliased": sum(t is b for t, b in zip(leaves(whole),
                                              leaves(eng.blocks))),
        "replicated": sum(not sh.axes for sh in leaves(eng._psh))}
    # a mesh engine admits in lockstep: open-loop arrivals need a clock
    # every rank reads alike
    from repro_torch.serving import Request
    late = Request(rid=9, prompt=np.zeros(4, np.int32), max_new_tokens=1,
                   arrival_s=1.0)
    try:
        eng.run([late])
        res["wall_clock_refused"] = False
    except ValueError:
        res["wall_clock_refused"] = True
    want = len(eng._graphs) + sum(
        c is not None for c in eng._cores.values()) + \
        (eng._whole is not None)
    gc.collect()
    res["evicted"] = (evict_mesh(ctx), want)
    try:
        eng.engine_step()
        res["closed"] = False
    except RuntimeError:
        res["closed"] = True
    del eng
    # the entry points inside a rank
    from repro_torch.configs import get_config
    res["serve"] = serve_cli.serve(
        get_config("iterpro-100m").smoke(), n_requests=SERVE_REQS,
        prompt_len=SERVE_PROMPT, gen_tokens=SERVE_GEN, inject_every=3,
        mesh="4,2", device="cpu", parity=True, verbose=False)
    res["cli"] = serve_cli.main([
        "--smoke", "--device", "cpu", "--mesh", "4,2", "--requests", "4",
        "--prompt-len", "16", "--gen", "12", "--inject", "5", "--parity",
        "--dense", "--prefill-chunk", "5", "--donate"])
    return res


# -- the training modes on the mesh (in the same spawn) -----------------------

#: the modes whose storms must end on the clean run's bits
STORM_MODES = {"donate": dict(donate=True),
               "donate+fused": dict(donate=True, fused_detect=True),
               "parity+donate": dict(parity=True, donate=True),
               "parity+donate+fused": dict(parity=True, donate=True,
                                           fused_detect=True)}
CLI_FLAGS = ("--donate", "--fused-detect", "--triage", "--parity")
FUSED_K = 2


def _bound(ctx, cfg, donate: bool):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.specs import bind_state
    from repro_torch.train.loop import make_train_state, make_train_step
    pipe = TokenPipeline(cfg.model.vocab_size, 32, 8, seed=0)
    return bind_state(ctx, cfg, make_train_state(cfg, 0, global_batch=8),
                      make_train_step(cfg, global_batch=8, donate=donate),
                      pipe.batch_at)


def _ptrs(tree):
    from repro_torch.tree import leaves
    return [t.data_ptr() for t in leaves(tree)]


def _mode_ranks(ctx, cfg, clean):
    """One rank's share of the mode scenarios: the donated mesh step
    against the functional one (AdamW f32, and kimi-k2's Adafactor), the
    fused step's steady accounting, storms in every mode, a flip in one
    replica only, and the CLI with every flag combination."""
    from repro_torch.configs import get_config
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import flip_bit
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.kernels import digest as kd
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.train import train

    out = {}
    # the donated mesh step, bitwise the functional one, pointers kept
    for arch in ("iterpro-100m", "kimi-k2-1t-a32b"):
        c = get_config(arch).smoke()
        fs, fstep, fbfn, _ = _bound(ctx, c, False)
        ds, dstep, dbfn, _ = _bound(ctx, c, True)
        ptrs = _ptrs(ds)
        for s in range(2):
            fs, fm = fstep(fs, fbfn(s))
            ds2, dm = dstep(ds, dbfn(s))
            assert ds2 is ds
        out[f"donated/{arch}"] = {
            "same": _bitwise(ds, fs), "ptrs": ptrs == _ptrs(ds),
            "loss": (float(fm["loss"]), float(dm["loss"]))}

    # the fused donated mesh step: K rotations to warm, then K steady
    # steps of one launch and one fetch each; bitwise the plain steps
    fs, fstep, fbfn, _ = _bound(ctx, cfg, False)
    ds, dstep, dbfn, _ = _bound(ctx, cfg, True)
    canary = ChecksumCanary(ds, n_slices=FUSED_K, ctx=ctx)
    factory = canary.fuse_into_step(dstep, donate=True)
    reports = []
    for s in range(2 * FUSED_K):
        if s == FUSED_K:
            kd.STATS.reset()
        fs, _ = fstep(fs, fbfn(s))
        ds, _, rep = factory.step(s, ds, dbfn(s))
        reports.append(rep)
    out["fused"] = {"stats": kd.STATS.snapshot(), "same": _bitwise(ds, fs),
                    "clean": all(r is None for r in reports)}

    # storms == clean in every mode (a flip every step, K=1)
    out["storms"] = {}
    for name, kw in STORM_MODES.items():
        summary, st = train(cfg, mesh="4,2", inject_every=1, **SMOKE, **kw)
        out["storms"][name] = {"summary": summary,
                               "same": _bitwise(st, clean)}

    # a flip in ONE replica of a block: replicas now disagree, so triage
    # must not tolerate it (rung 0 refuses; replay from the snapshot)
    st, step, bfn, sh = _bound(ctx, cfg, False)
    micro = MicroCheckpointer(interval=1, ctx=ctx, shardings=sh)
    canary = ChecksumCanary(st, n_slices=1, ctx=ctx)
    rt = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                         iv_registry=promote(cfg, 8), micro=micro,
                         canary=canary, triage=True, shardings=sh)
    micro.maybe_snapshot(0, st)
    key = "opt/v/groups/0/0/ffn/up/w"
    truth = {k: t.clone() for k, t in zip(canary.plan.keys,
                                          canary.plan.leaves(st))}
    if ctx.shard_id == 0:
        flip_bit(dict(zip(canary.plan.keys, canary.plan.leaves(st)))[key],
                 5, 2)
    rep = canary.check(0, st)
    rep.resolve()
    fixed, ev = rt.recover(st, rep, 0)
    out["one_replica"] = {
        "shards": rep.shards, "rung": ev.rung, "attempted": ev.attempted,
        "detail": ev.report.detail,
        "healed": all(torch.equal(a.view(-1).view(torch.uint8),
                                  truth[k].view(-1).view(torch.uint8))
                      for k, a in zip(canary.plan.keys,
                                      canary.plan.leaves(fixed)))}

    # the CLI on the mesh, every combination of the four mode flags
    out["cli"] = {}
    base = ["--arch", "iterpro-100m", "--smoke", "--mesh", "4,2", "--device",
            "cpu", "--steps", "3", "--batch", "8", "--seq", "32", "--inject",
            "1", "--canary-slices", "1", "--snapshot-interval", "2"]
    for bits in range(1 << len(CLI_FLAGS)):
        flags = [f for i, f in enumerate(CLI_FLAGS) if bits >> i & 1]
        res = train_cli.main(base + flags)
        out["cli"][" ".join(flags)] = {
            k: res[k] for k in ("steps", "final_loss", "faults_injected",
                                "faults_detected", "faults_recovered")}
        out["cli"][" ".join(flags)]["rungs"] = res["recovery"]["by_rung"]
    return out


# -- elastic hard loss (in the same spawn) ------------------------------------

#: the byte a rank of a lost row writes over its blocks once the oracle
#: has read them: a survivor that read a dead block would see it
POISON = 0x5A
KILL, ELASTIC_STEPS = 3, 6
#: the drill's modes: (train flags, fsdp).  Without fsdp no leaf is
#: data-sharded and the survivors re-gather every leaf (the CLI's drill);
#: with it the row-safe parity covers the data-sharded leaves, kept by
#: the donated pair's rebuild or the fused unit's gated update
ELASTIC_MODES = {"functional": ({}, False),
                 "donate": (dict(donate=True), True),
                 "donate+fused": (dict(donate=True, fused_detect=True),
                                  True),
                 # a flip every 2 steps in the checked slice of a K=2
                 # canary, before and after the loss (the snapshot of the
                 # resumed state replays the one after)
                 "storm": (dict(donate=True, triage=True, canary_slices=2,
                                inject_every=2, inject_armed_only=True),
                           True)}


def _fsdp(cfg):
    return dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, fsdp=True))


def _poison(state):
    from repro_torch.tree import leaves
    for t in leaves(state):
        t.reshape(-1).view(torch.uint8).fill_(POISON)


def _row_of(ctx):
    return ctx.coords(ctx.shard_id)[ctx.data_axis]


class _WorldSpy:
    """Records every collective a rank makes through ``torch.distributed``
    while active, and counts those on WORLD (``group`` None or the
    default group)."""

    OPS = ("all_reduce", "all_gather_into_tensor", "all_to_all_single",
           "all_gather_object", "broadcast", "barrier")

    def __enter__(self):
        import torch.distributed as dist
        self.calls, self.world, self._saved = 0, [], {}
        for name in self.OPS:
            fn = self._saved[name] = getattr(dist, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.calls += 1
                g = kw.get("group")
                if g is None or g is dist.group.WORLD:
                    self.world.append(_name)
                return _fn(*a, **kw)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._saved.items():
            setattr(dist, name, fn)


def _continue(ctx, cfg, full, batch, first, last, donate=False):
    """A clean functional run on ``ctx`` from the full state ``full``
    over steps ``[first, last)``: (losses, this rank's final blocks)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.specs import bind_state
    from repro_torch.train.loop import make_train_step
    seq = 32 if batch == 8 else 16
    pipe = TokenPipeline(cfg.model.vocab_size, seq, batch, seed=0)
    st, step, bfn, _ = bind_state(
        ctx, cfg, full, make_train_step(cfg, global_batch=batch),
        pipe.batch_at)
    losses = []
    for s in range(first, last):
        st, m = step(st, bfn(s))
        losses.append(float(m["loss"]))
    return losses, st


def _train_drills(cfg):
    """The CLI's drill, 4 x 2 -> 3 x 2 (row 3 dies before step 3 of 6),
    in each of ``ELASTIC_MODES``: the dead ranks poison their blocks after
    the oracle read them; each survivor resumes on the oracle's blocks,
    and its final blocks and losses must equal a clean 3 x 2 run from
    the oracle."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_map
    out = {}
    for name, (kw, fsdp) in ELASTIC_MODES.items():
        c = _fsdp(cfg) if fsdp else cfg
        box = {}

        def on_kill(ctx, state, sh, rows):
            box.update(ctx=ctx, rows=rows, oracle=tree_map(
                torch.clone, gather_tree(state, sh)))
            if _row_of(ctx) in rows:
                _poison(state)
                box["poisoned"] = True
            return on_resume

        def on_resume(ctx, state, sh):
            box["resumed"] = _bitwise(gather_tree(state, sh), box["oracle"])

        summary, st = train(c, mesh="4,2", parity=True, elastic=True,
                            kill_row_at=KILL, on_kill=on_kill,
                            **{**SMOKE, "steps": ELASTIC_STEPS, **kw})
        res = {"summary": summary, "poisoned": box.get("poisoned", False),
               "resumed": box.get("resumed")}
        if not summary.get("dead"):
            losses, clean = _continue(box["ctx"].degrade(box["rows"]), c,
                                      box["oracle"], 8, KILL, ELASTIC_STEPS)
            res["clean_losses"] = losses
            res["same"] = _bitwise(st, clean)
        out[name] = res
    return out


def _bound_fsdp(ctx, cfg, batch=12):
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.parity import ParityStore
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.specs import bind_state
    from repro_torch.train.loop import make_train_state, make_train_step
    pipe = TokenPipeline(cfg.model.vocab_size, 16, batch, seed=0)
    state, step, bfn, sh = bind_state(
        ctx, cfg, make_train_state(cfg, 0, global_batch=batch),
        make_train_step(cfg, global_batch=batch), pipe.batch_at)
    canary = ChecksumCanary(state, n_slices=1, ctx=ctx)
    pstore = ParityStore(state, ctx=ctx, row_safe=True, shardings=sh)
    pstore.build(state)
    canary.attach_parity(pstore)
    return state, step, bfn, sh, canary, pstore, pipe


def _loss_and_continue(emgr, cfg, at, rows, state, step, sh, canary,
                       pstore, pipe, steps=2):
    """One hard loss of ``rows`` before step ``at`` on the survivors (a
    WORLD spy running): the resume, its state against the oracle (taken
    first, with every rank), ``steps`` checked steps on the new mesh and
    one steady check, against a clean run from the oracle."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.kernels import digest as kd
    ctx = emgr.ctx
    oracle = gather_tree(state, sh)
    if _row_of(ctx) in rows:
        _poison(state)
        return {"dead": True}, None
    with _WorldSpy() as spy:
        r = emgr.on_loss(step=at, dead_rows=rows, state=state,
                         raw_step=step, cfg=cfg, batch_fn=pipe.batch_at,
                         canary=canary, pstore=pstore, shardings=sh)
        res = {"rank": r.ctx.rank, "shard_id": r.ctx.shard_id,
               "shape": r.ctx.shape, "event": r.event.to_dict(),
               "same": _bitwise(gather_tree(r.state, r.shardings), oracle)}
        st, losses, clean_checks = r.state, [], True
        for s in range(at, at + steps):
            if s == at + steps - 1:
                kd.STATS.reset()
            ns, m = r.step(st, r.bfn(s))
            clean_checks &= r.canary.check_and_arm(s, st, ns) is None
            losses.append(float(m["loss"]))
            st = ns
        res["stats"] = kd.STATS.snapshot()
    res.update(losses=losses, checks_clean=clean_checks,
               world_calls=spy.world, calls=spy.calls,
               clean_losses=_continue(ctx.degrade(rows), cfg, oracle,
                                      pipe.global_batch, at,
                                      at + steps)[0])
    return res, (r, st)


def _row_safe_rebuilds(pstore, state, sh):
    """The ``parity_xor`` rung's rebuild on the row-safe placement
    (``RowSafeParityPlan.reconstruct_shard``, collective): every block of
    every covered leaf rebuilt with its holders' copies zeroed, against
    the block itself.  Returns the blocks rebuilt bitwise and in all."""
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.tree import flatten_with_path, leaf_key
    plan = pstore.plan
    full = {leaf_key(p): t for p, t in flatten_with_path(
        gather_tree(state, sh))}
    local = {leaf_key(p): t for p, t in flatten_with_path(state)}
    by_sh = {leaf_key(p): s for p, s in flatten_with_path(sh)}
    exact = n = 0
    for key in plan.keys:
        for b in range(plan.n_blocks[key]):
            mine = plan.device_block[key][plan.rank] == b
            leaf = torch.zeros_like(local[key]) if mine else local[key]
            got = pstore.reconstruct_shard(leaf, key, b)
            d = plan.block_devices(key, b)[0]
            exact += _bitwise({"x": got}, {"x": full[key][by_sh[key].box(d)]})
            n += 1
    return exact, n


def _elastic_ranks(cfg):
    """One rank's share of the elastic scenarios: the CLI's drill in two
    modes, an ``on_loss`` of row 0 (world rank 2 becomes shard 0), and
    two losses in one process, 4 x 2 -> 3 x 2 -> 2 x 2, where nothing
    keyed on an older context survives."""
    from repro_torch.core import fused_step
    from repro_torch.core import parity as cp
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.elastic import ElasticManager
    from repro_torch.launch.mesh import make_context

    out = {"train": _train_drills(cfg)}
    fcfg = _fsdp(cfg)

    # row 0 dies: a world rank is not its shard id after the loss
    ctx = make_context("4,2", torch.device("cpu"))
    state, step, bfn, sh, canary, pstore, pipe = _bound_fsdp(ctx, fcfg)
    for s in range(2):
        ns, _ = step(state, bfn(s))
        assert canary.check_and_arm(s, state, ns) is None
        state = ns
    out["rebuilt"] = _row_safe_rebuilds(pstore, state, sh)
    out["row0"], _ = _loss_and_continue(
        ElasticManager(ctx), fcfg, 2, (0,), state, step, sh, canary,
        pstore, pipe)
    out["row0"]["covers"] = len(pstore.plan.keys)

    # two losses in one process: 4 x 2 -> 3 x 2 -> 2 x 2
    ctx0 = make_context("4,2", torch.device("cpu"))
    state, step, bfn, sh, canary, pstore, pipe = _bound_fsdp(ctx0, fcfg)
    fused = canary.fuse_into_step(step)
    fused.warm(state, bfn(0))
    ns, _ = step(state, bfn(0))
    assert canary.check_and_arm(0, state, ns) is None
    emgr = ElasticManager(ctx0)
    twice = []

    def stale(c):
        mk = kd.mesh_key(c)
        return (sum(k[0] == "mesh" and k[1] == mk for k in kd._PLAN_CACHE)
                + sum(k[0] == "mesh" and k[1] == mk
                      for k in cp._PARITY_PLAN_CACHE)
                + sum(kd.mesh_key(f.canary.ctx) == mk
                      for f in fused_step._ON_MESH))
    before = stale(ctx0)
    for at, rows in ((1, (3,)), (2, (2,))):
        old = emgr.ctx
        res, resumed = _loss_and_continue(emgr, fcfg, at, rows, ns, step,
                                          sh, canary, pstore, pipe, steps=1)
        if resumed is None:
            twice.append(res)
            break
        res["stale_old"] = stale(old)
        res["fused_closed"] = not fused._rotations
        r, ns = resumed
        step, sh, canary, pstore = r.step, r.shardings, r.canary, r.pstore
        fused = canary.fuse_into_step(step)
        fused.warm(ns, r.bfn(at + 1))
        twice.append(res)
    if twice and "dead" not in twice[-1]:
        try:
            emgr.on_loss(step=3, dead_rows=(0, 1), state=ns, raw_step=step,
                         cfg=fcfg, batch_fn=pipe.batch_at, canary=canary,
                         pstore=pstore, shardings=sh)
            twice.append({"all_lost": "no error"})
        except RuntimeError as e:
            twice.append({"all_lost": str(e)})
        twice.append({"dead_slices": sorted(emgr.dead),
                      "slice_ids": emgr.slice_ids, "stale_first": before})
    out["twice"] = twice
    return out


@pytest.fixture(scope="module")
def storms(tmp_path_factory):
    from repro_torch.launch.mesh import spawn
    d = str(tmp_path_factory.mktemp("mesh_ckpt"))
    return spawn(_storm_ranks, (4, 2), (d,), device="cpu")


def test_storms_end_bitwise_equal_to_the_clean_run(storms):
    for r in storms:
        sm = r["summaries"]
        clean = sm["clean"]
        assert clean["faults_injected"] == 0
        assert clean["mesh"] == {"shape": {"data": 4, "model": 2},
                                 "devices": 8}
        for name in ("params", "iv"):
            out = sm[name]
            assert out["faults_injected"] > 0, name
            assert out["faults_detected"] == out["faults_injected"], name
            assert out["faults_recovered"] == out["faults_detected"], name
            assert r["same"][name], name      # this rank's blocks
            assert out["final_loss"] == clean["final_loss"], name
        assert sm["params"]["recovery"]["by_rung"] == {"replay": 2,
                                                       "shard_patch": 1}
        assert sm["iv"]["recovery"]["by_rung"] == {"eq1": 1}
        # every rank reports the same run (timings aside)
        def what(x):
            return {n: (o["steps"], o["final_loss"], o["faults_detected"],
                        o["recovery"]["by_rung"],
                        o["recovery"]["shard_patches"])
                    for n, o in x.items()}
        assert what(sm) == what(storms[0]["summaries"])


def test_mesh_serving_matches_the_single_device_engine(storms):
    """Every scenario's token logs on every rank are bitwise the
    single-device engine's clean logs over the same params (storm ==
    clean); detected == injected == recovered, nothing dropped; every
    rank saw the same faults at the same steps and evicted the same
    slots; a steady step is 1 launch + 1 fetch."""
    for name, (arch, kw, every, scrub) in SERVE_RUNS.items():
        first = storms[0]["serving"][name]
        for r in storms:
            got = r["serving"][name]
            assert got["logs"] == first["single"], (name, r["serving"])
            sm = got["summary"]
            f = sm["faults"]
            assert sm["completed"] == SERVE_REQS and sm["dropped"] == 0, \
                (name, sm)
            assert f["injected"] > 0, (name, f)
            assert f["detected"] == f["injected"] == f["recovered"], \
                (name, f)
            assert got["faults"] == first["faults"], name
            assert tuple(got["stats"]) == (1, 1), (name, got["stats"])


def test_tensor_parallel_training_holds_one_device(storms):
    """Tensor-parallel on 4 x 2 (iterpro-100m: every projection split;
    gemma3-1b: its one KV head's ``wk/wv`` replicated): the state after
    the steps within 2e-5 of one device's, the storm bitwise its clean
    run, and every leaf replicated over the model axis bitwise equal on
    the model-axis peers, on every rank."""
    for r in storms:
        tp = r["tp"]
        for arch, o in tp.items():
            assert o["err"] == [], (arch, o["err"])
            assert o["peers"], arch
        g = tp["gemma3-1b"]
        assert g["storm"]["faults_injected"] > 0
        assert g["storm"]["faults_recovered"] == \
            g["storm"]["faults_detected"] == g["storm"]["faults_injected"]
        assert g["storm_same"]
        assert abs(g["out"]["final_loss"] - g["one"]["final_loss"]) <= 2e-5


def test_tensor_parallel_step_gathers_no_params(storms):
    """The mesh step's front reads the rank's blocks in place: no
    ``gather_tree`` of the params (iterpro-100m), only the fsdp leaves'
    over the batch axes (command-r-35b: one gather, over ``data``)."""
    for r in storms:
        assert r["gathers"] == {"iterpro-100m": {},
                                "command-r-35b": {"data": 1}}, r["gathers"]


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_families_train_tensor_parallel_on_the_mesh(storms, arch):
    """xLSTM, Zamba2, the enc-dec and the VLM on 4 x 2 compute on the
    rank's blocks: a bound step gathers no params (the fsdp configs'
    leaves over ``data`` only), a params flip every step ends bitwise on
    the clean run, the state after the steps lies within 2e-5 of one
    device's, and every leaf replicated over the model axis is bitwise
    equal on the model-axis peers, on every rank."""
    fsdp = _family_cfg(arch).sharding.fsdp
    for r in storms:
        o = r["families"][arch]
        assert o["gathers"] == ({"data": 1} if fsdp else {}), \
            (arch, o["gathers"])
        f = o["storm"]
        assert f["faults_injected"] > 0, (arch, f)
        assert f["faults_recovered"] == f["faults_detected"] == \
            f["faults_injected"], (arch, f)
        assert o["storm_same"], arch
        assert o["err"] == [], (arch, o["err"])
        assert o["peers"], arch
        assert abs(o["out"]["final_loss"] - o["one"]["final_loss"]) <= 2e-5


def test_mesh_serving_caches_are_replicas_on_the_peers(storms):
    """After every dense-layout run (the recurrent states, the K/V, the
    enc-dec's memory K/V), the decode cache holds the same bits on every
    model-axis peer."""
    for r in storms:
        for name, got in r["serving"].items():
            if name in SERVE_RUNS and got["cache_peers"] is not None:
                assert got["cache_peers"], (name, r["serving"])


def test_mesh_serving_reads_the_blocks_in_place(storms):
    """The tensor-parallel engine's model reads the rank's blocks (no
    whole-params storage): a run makes no params gather, except the fsdp
    leaves' over the batch axes (kimi-k2-1t-a32b), and the model axis's
    collectives ran."""
    for r in storms:
        for name, got in r["serving"].items():
            if name not in SERVE_RUNS:
                continue
            assert got["tp"], name
            want = {"data"} if name in ("kimi", "zamba2", "qwen2-vl") \
                else set()
            assert set(got["gathers"]) == want, (name, got["gathers"])
            assert got["tp_calls"]["reduce_sum"] > 0, name


def test_mesh_serving_flip_in_one_replica_names_its_shard(storms):
    """The "rank5" storm flips rank 5's replica only: every rank flags
    at the same steps, each report's shards are [5], and every rank
    evicts the same slots."""
    faults = storms[0]["serving"]["rank5"]["faults"]
    assert faults
    for step, report, victims in faults:
        leaves, shards = report
        assert leaves and victims, (step, report)
        assert all(v == [ONE_RANK] for v in shards.values()), shards


def test_mesh_serving_scrub_repairs_the_block_on_every_holder(storms):
    """``corrupt_param`` + ``scrub_params`` on the mesh: one leaf
    repaired, nothing failed, ``bytes_moved`` the block's bytes times its
    holders, every rank's blocks bitwise their bits before the flip; the
    parity is the reference's size (checked by the oracle file)."""
    for name in ("paged+parity", "kimi"):
        flipped = 0
        for r in storms:
            got = r["serving"][name]
            sc = got["scrub"]
            assert sc["repaired"] == 1 and sc["failed"] == [], (name, sc)
            assert sc["bytes_moved"] == got["expect_moved"], (name, sc)
            assert got["healed"], (name, r["serving"])
            assert sc == storms[0]["serving"][name]["scrub"], name
            flipped += got["flipped"]
        assert flipped >= 1, name


def test_gather_tree_out_and_evict_mesh_on_the_serving_engine(storms):
    """``gather_tree(out=)`` equals ``gather_tree()`` and keeps every
    pointer of ``out`` (its replicated leaves are the rank's blocks
    themselves); ``serving.engine.evict_mesh`` drops the live engine's
    cores and gathered storage, counts them, and the engine refuses to
    step after it; its ``run`` refuses open-loop arrivals on a wall clock
    (the ranks would admit at different times)."""
    for r in storms:
        g = r["serving"]["gather_out"]
        assert g["ptrs"] and g["same"], g
        assert g["aliased"] == g["replicated"] > 0, g
        got, want = r["serving"]["evicted"]
        assert got == want > 1, (got, want)
        assert r["serving"]["closed"]
        assert r["serving"]["wall_clock_refused"]


def test_serve_entry_points_inside_the_ranks(storms):
    """``serve(mesh="4,2")`` and ``main([... "--mesh", "4,2"])`` called
    inside the ranks serve as those ranks: every request completes, the
    storm is detected and recovered, the scrub repairs the flipped
    param, the summary names the mesh, every rank the same counters."""
    for r in storms:
        for what in ("serve", "cli"):
            out = r["serving"][what]
            f = out["faults"]
            assert out["completed"] == 4 and out["dropped"] == 0, out
            assert f["injected"] > 0 and \
                f["detected"] == f["injected"] == f["recovered"], f
            assert out["parity"]["repaired"] == 1, out["parity"]
            assert out["parity"]["failed"] == [], out["parity"]
            assert out["mesh"] == {"shape": {"data": 4, "model": 2},
                                   "devices": 8}, out["mesh"]
            for k in ("tokens_out", "faults", "replay_tokens",
                      "engine_steps", "parity"):
                assert out[k] == storms[0]["serving"][what][k], (what, k)


def test_fsdp_and_expert_parallel_layouts_train_on_the_mesh(storms):
    """command-r-35b's fsdp blocks differ across the data peers (the
    grads' exchange sends each its own); on 4 x 2 its trajectory stays
    within the f32 tolerance of one device's.  kimi-k2-1t-a32b (fsdp +
    expert-parallel storage, Adafactor with bf16 stats: the optimizer
    updates the whole tree) and command-r-35b each end a params storm
    bitwise on their clean run, on every rank."""
    for r in storms:
        for arch, o in r["others"].items():
            assert o["storm"]["faults_injected"] > 0, arch
            assert o["storm"]["faults_recovered"] == \
                o["storm"]["faults_injected"], arch
            assert o["storm_same"], arch
        cr = r["others"]["command-r-35b"]
        assert abs(cr["out"]["final_loss"] - cr["one"]["final_loss"]) \
            <= 2e-5
        assert cr["err"] <= 2e-5, cr["err"]


def test_steady_check_is_one_launch_one_fetch_on_every_rank(storms):
    for r in storms:
        assert r["steady"] and tuple(r["stats"]) == (1, 1)
        assert r["partial"]


def test_mesh_checkpoint_round_trip(storms):
    for r in storms:
        assert r["round_trip"] and r["on_disk"]


def test_donated_mesh_step_is_bitwise_the_functional_one(storms):
    """AdamW's in-place update of the rank's blocks and Adafactor's
    whole-tree update written back into them (kimi-k2-1t-a32b) step
    bitwise as the functional mesh step, every ``data_ptr`` kept."""
    for r in storms:
        for arch in ("iterpro-100m", "kimi-k2-1t-a32b"):
            d = r["modes"][f"donated/{arch}"]
            assert d["same"] and d["ptrs"], (arch, d)
            assert d["loss"][0] == d["loss"][1], (arch, d)


def test_fused_mesh_step_is_k_launches_k_fetches_over_k_steps(storms):
    """The reference's ``(K, K, 0)`` over K steady steps on every rank
    (the flag's all-reduce is no fetch), bitwise the plain steps."""
    for r in storms:
        f = r["modes"]["fused"]
        assert tuple(f["stats"]) == (FUSED_K, FUSED_K), f
        assert f["same"] and f["clean"], f


def test_mode_storms_end_bitwise_equal_to_the_clean_run(storms):
    """A params flip every step under ``--donate`` and ``--donate
    --fused-detect``, each with and without ``--parity``: detected ==
    injected == recovered and the final blocks are the clean run's on
    every rank.  Donated, the fused reports are consumed (replay); the
    donated pair checks before the step, so with a parity its reports
    are rebuilt in place (``parity_xor``)."""
    for r in storms:
        for name, o in r["modes"]["storms"].items():
            sm = o["summary"]
            assert sm["faults_injected"] > 0, name
            assert sm["faults_detected"] == sm["faults_injected"], name
            assert sm["faults_recovered"] == sm["faults_detected"], name
            assert o["same"], (name, r["modes"]["storms"])
            assert sm["pointers_kept"], name
            rungs = set(sm["recovery"]["by_rung"])
            want = {"parity_xor"} if name == "parity+donate" \
                else {"replay"}
            assert rungs == want, (name, sm["recovery"])
        assert {n: o["summary"]["recovery"]["by_rung"]
                for n, o in r["modes"]["storms"].items()} == \
            {n: o["summary"]["recovery"]["by_rung"]
             for n, o in storms[0]["modes"]["storms"].items()}


def test_flip_in_one_replica_escalates_past_triage(storms):
    """The port holds each replica of a block on its own rank, so a flip
    can leave replicas unequal (the reference's global array cannot):
    triage refuses it on every rank, and the next rung heals it."""
    for r in storms:
        o = r["modes"]["one_replica"]
        assert o["shards"] == {"opt/v/groups/0/0/ffn/up/w": [0]}, o
        assert o["attempted"][0] == "triage" and o["rung"] != "triage", o
        assert "replicas disagree" in o["detail"], o
        assert o["healed"], o


def test_train_cli_every_mode_combination_on_a_4x2_mesh(storms):
    """``train --mesh 4,2`` with every combination of ``--donate``,
    ``--fused-detect``, ``--triage`` and ``--parity`` (a flip every step):
    each detects and recovers every flip and ends on the same loss."""
    for r in storms:
        cli = r["modes"]["cli"]
        assert len(cli) == 1 << len(CLI_FLAGS)
        for flags, o in cli.items():
            assert o["steps"] == 3 and o["faults_injected"] == 2, flags
            assert o["faults_detected"] == o["faults_injected"], flags
            assert o["faults_recovered"] == o["faults_detected"], flags
            assert o["final_loss"] == cli[""]["final_loss"], flags
        assert cli == storms[0]["modes"]["cli"]


def _one_by_two():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import local_tree
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import bind_state
    from repro_torch.launch.train import train
    from repro_torch.train.loop import make_train_state, make_train_step
    ctx = make_context("1,2", torch.device("cpu"))
    out = {}
    for opt in sorted(OPTS):
        cfg = _with_opt(get_config("iterpro-100m").smoke(), opt)
        kw = dict(SMOKE, steps=2)
        mesh, local = train(cfg, mesh="1,2", **kw)
        # the rank's blocks updated from one device's grads (the tail of
        # the mesh step) against one device's update of those blocks
        state0 = make_train_state(cfg, 0, global_batch=8)
        raw = make_train_step(cfg, global_batch=8)
        batch = TokenPipeline(cfg.model.vocab_size, 32, 8, seed=0).batch_at(0)
        loss, _, grads = raw.loss_and_grads(state0["params"], batch)
        one_step, _ = raw(state0, batch)
        bound = bind_state(ctx, cfg, make_train_state(cfg, 0, global_batch=8),
                           raw, lambda s: batch)
        fr = {"scalars": {"loss": loss}, "grads": grads}
        if not raw.opt.elementwise:
            fr.update(full=state0["params"], opt=state0["opt"])
        blocks, _ = bound.step.tail(bound.state, fr)
        same = _bitwise(blocks, local_tree(one_step, bound.shardings))
        out[opt] = (mesh, _full(cfg, "1,2", local)), train(cfg, **kw), same
    return out


def _state_close(got, want, tol=2e-5):
    """Every float leaf within ``tol`` (absolute and relative), counters
    exact, int8 moment payloads within one step of their rounding."""
    from repro_torch.tree import flatten_with_path, leaf_key
    fw = {leaf_key(p): t for p, t in flatten_with_path(want)}
    bad = []
    for p, t in flatten_with_path(got):
        k, w = leaf_key(p), fw[leaf_key(p)]
        if t.is_floating_point():
            ok = torch.allclose(t.double(), w.double(), atol=tol, rtol=tol)
        elif t.dtype == torch.int8:
            ok = int((t.int() - w.int()).abs().max()) <= 1
        else:
            ok = torch.equal(t, w)
        if not ok:
            bad.append(k)
    return bad


def test_data_width_one_equals_single_device_bitwise():
    """Tensor-parallel on 1 x 2: AdamW's elementwise update of the rank's
    blocks, and the whole-tree update of int8 moments and Adafactor,
    from one device's grads, are each bitwise one device's update of
    those blocks; the loss and the state after two steps hold one
    device's within 2e-5 (the model axis's sums round otherwise than
    one device's whole products)."""
    from repro_torch.launch.mesh import spawn
    runs = spawn(_one_by_two, (1, 2), device="cpu")[0]
    assert sorted(runs) == sorted(OPTS)
    for opt, ((mesh, ms), (single, ss), same) in runs.items():
        assert mesh["mesh"]["devices"] == 2, opt
        assert same, opt
        assert abs(mesh["final_loss"] - single["final_loss"]) <= 2e-5, opt
        assert _state_close(ms, ss) == [], opt


def test_train_cli_on_a_4x2_mesh():
    from repro_torch.launch import train
    out = train.main(["--arch", "iterpro-100m", "--smoke", "--mesh", "4,2",
                      "--device", "cpu", "--steps", "4", "--batch", "8",
                      "--seq", "32", "--inject", "2", "--canary-slices", "1",
                      "--snapshot-interval", "2"])
    assert out["mesh"] == {"shape": {"data": 4, "model": 2}, "devices": 8}
    assert out["steps"] == 4 and out["faults_injected"] == 1
    assert out["faults_detected"] == out["faults_injected"]
    assert out["faults_recovered"] == out["faults_detected"]


# -- elastic hard loss ----------------------------------------------------------

def test_elastic_train_drill_remeshes_and_continues_bitwise(storms):
    """``train --mesh 4,2 --parity --elastic --kill-row-at 3`` (6 steps),
    functional, ``--donate`` and ``--donate --fused-detect`` (the last two
    with fsdp: blocks rebuilt from the row-safe parity): row 3's ranks
    poison their blocks and leave; the survivors take one ``remesh`` (no
    disk restore), finish at 3 x 2, and end on the blocks and losses of a
    clean 3 x 2 run from the oracle state, 1 launch + 1 fetch a step (the
    donated pair: 2 launches, its arm and its check); under a storm of
    flips before and after the loss every flip is repaired exactly."""
    for rank, r in enumerate(storms):
        assert sorted(r["elastic"]["train"]) == sorted(ELASTIC_MODES)
        for name, o in r["elastic"]["train"].items():
            sm = o["summary"]
            if rank // 2 == 3:
                assert sm.get("dead") and o["poisoned"], (rank, name)
                continue
            assert not o["poisoned"], (rank, name)
            storm = sm["faults_injected"]
            assert sm["steps"] == ELASTIC_STEPS, (name, sm)
            assert sm["faults_detected"] == sm["faults_recovered"] == \
                1 + storm, (name, sm)
            assert sm["recovery"]["by_rung"].pop("remesh") == 1, name
            assert sum(sm["recovery"]["by_rung"].values()) == storm, name
            [ev] = sm["elastic_events"]
            assert tuple(ev["lost_rows"]) == tuple(ev["lost_slices"]) == (3,)
            assert ev["disk_restores"] == 0 and ev["new_dp"] == 3, ev
            # K=1 certifies every surviving block; at K=2 the slice armed
            # a step earlier mismatches (not strict)
            assert ev["certified_blocks"] > 0, ev
            assert (ev["uncertified_blocks"] == 0) == (not storm), ev
            assert (ev["blocks_reconstructed"] > 0) == \
                ELASTIC_MODES[name][1], (name, ev)
            assert sm["mesh"] == {"shape": {"data": 3, "model": 2},
                                  "devices": 6}, name
            assert o["resumed"] and o["same"], (rank, name)
            assert sm["losses"][KILL:] == o["clean_losses"], (rank, name)
            # the donated pair: its arm and its check, one fetch
            want = [[2, 1]] if name in ("donate", "storm") else [[1, 1]]
            assert sm["digest_per_step"] == want, (name, sm)
            if name != "functional":
                assert sm["pointers_kept"], name


def test_elastic_loss_of_row_zero_renumbers_the_shards(storms):
    """Row 0 dies (fsdp: the row-safe parity covers the data-sharded
    leaves): world rank ``r`` becomes shard ``r - 2``, the dead rows'
    blocks are rebuilt from the parity, the state is bitwise the oracle,
    and from the loss on no survivor calls a collective on WORLD."""
    for rank, r in enumerate(storms):
        o = r["elastic"]["row0"]
        if rank < 2:
            assert o.get("dead"), rank
            continue
        assert o["covers"] > 0
        exact, n = r["elastic"]["rebuilt"]
        assert exact == n > 0, (rank, exact, n)
        assert (o["rank"], o["shard_id"]) == (rank, rank - 2), o
        assert o["shape"] == {"data": 3, "model": 2}
        ev = o["event"]
        assert tuple(ev["lost_rows"]) == (0,) and ev["disk_restores"] == 0, ev
        assert ev["blocks_reconstructed"] > 0, ev
        assert ev["uncertified_blocks"] == 0 < ev["certified_blocks"], ev
        assert o["same"] and o["checks_clean"], o
        assert o["losses"] == o["clean_losses"], o
        assert tuple(o["stats"]) == (1, 1), o
        assert o["calls"] > 0 and o["world_calls"] == [], o


def test_elastic_two_losses_leave_nothing_of_the_older_meshes(storms):
    """4 x 2 -> 3 x 2 -> 2 x 2 in one process: each loss keeps the
    survivors' state bitwise the oracle and their losses a clean run's;
    after each, no digest or parity plan and no fused unit of the older
    mesh is left; the manager keeps the original slice ids; losing every
    row left refuses."""
    for rank, r in enumerate(storms):
        twice = r["elastic"]["twice"]
        if rank >= 6:
            assert twice == [{"dead": True}], rank
            continue
        first = twice[0]
        assert first["shape"] == {"data": 3, "model": 2}, first
        if rank >= 4:
            assert twice[1] == {"dead": True} and len(twice) == 2, rank
        else:
            second, refused, book = twice[1:]
            assert second["shape"] == {"data": 2, "model": 2}, second
            assert tuple(second["event"]["lost_slices"]) == (2,), second["event"]
            assert "no surviving" in refused["all_lost"], refused
            assert book["dead_slices"] == [2, 3], book
            assert book["slice_ids"] == [0, 1], book
            assert book["stale_first"] > 0, book
        for o in twice[:2 if rank < 4 else 1]:
            assert o["stale_old"] == 0 and o["fused_closed"], o
            assert o["same"] and o["checks_clean"], o
            assert o["losses"] == o["clean_losses"], o
            assert tuple(o["stats"]) == (1, 1), o
            assert o["event"]["uncertified_blocks"] == 0, o["event"]
            assert o["world_calls"] == [], o
