"""The port's mesh path against the JAX package on a 4 x 2 mesh.

A one-device tier-1 run skips the reference's in-process mesh tests, so
the oracle is a child process: it forces 8 CPU devices, wraps
``jax.make_mesh`` to build Auto axes (jax 0.9 builds Explicit ones, which
the reference's shard_map paths refuse) and dumps, once per module:

* every leaf's ``shard_indices`` of the iterpro-100m smoke train state,
* the ``sharded_plan_for`` digest table of that state,
* the ``SHARDED_PROG`` outcome of ``tests/test_sharded_resilience.py``
  (leaves ``["b"]``, shards ``{"b": [1, 3, 5, 7]}``, STATS ``(1, 1, 0)``),
* four bound steps' losses and the state after them,
* the shard_patch scenario of
  ``test_shard_local_recovery_restores_only_injured_shard``: the injured
  shard ids, the rung, ``bytes_moved``, and the version-mismatch replay;
* the elastic programs of ``tests/test_elastic.py`` (its toy tree's
  row-safe parity and reconstructions, the chaos drill, two drills in
  one process, the CLI's drill);
* ``tests/test_moe.py``'s EP_PROG (a 2 x 4 mesh, fsdp) for every
  ``moe_impl`` at capacity 8.0 and 1.25, at its 32 tokens and at 512
  (each rank's rows of the mesh output, ``lb_loss``, the rows capacity
  1.25 drops) and
  ``tests/test_pipeline.py``'s PIPE_PROG (S 4, M 6, B 2, d 8), the port
  running each on contexts its 8 ranks make anew;
* the ssm, hybrid, encdec and vlm families (xlstm-350m, zamba2-7b,
  seamless, qwen2-vl smoke configs with every kind of block in two
  layers), in a second child beside the first (``CHILD_FAM``): two bound
  mesh steps from the same state (losses and state within the f32
  tolerance) and the mesh engines' clean serving runs over the same
  params (token logs bitwise); and one forward of xlstm-350m-smoke in
  bf16 (``X16``: a prefill and a decode step) on a 1 x 2 mesh against
  one device, each package against itself (the bf16 drift of the mesh);
* the training modes: the programs of ``test_sharded_resilience.py::
  test_donation_and_fused_detect_compose_on_mesh`` and
  ``::test_partial_refresh_patches_without_generation_bump`` and of
  ``test_parity.py::test_tp_sharded_slice_map_regression``; a sharded
  parity build and three gated updates (every device's row); triage on
  the sharded canary with a bit-2 and a bit-30 ``opt/v`` flip.

Both packages start from the same bits: this process makes the
reference's state (PRNGKey(0)) and the toy tree once and hands them to
the child and to the port's 8 gloo ranks, which run the same scenarios
meanwhile.  Boxes, digest tables and shard ids are held bitwise; losses
and state within the f32 tolerance of ``tests/test_torch_train.py``;
the rung and ``bytes_moved`` equal; the healed state bitwise its own
pre-injection truth, with every healthy block's ``data_ptr`` kept.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
B, S = 8, 32
UP = "groups/0/0/ffn/up/w"
TOY_SPECS = {"a": ("data", None), "b": (None, "model"),
             "c": (("data", "model"),), "s": ()}

CHILD = textwrap.dedent("""
    import os, sys, json, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    _make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: _make_mesh(
        shape, axes, axis_types=(AxisType.Auto,) * len(shape))
    from repro.configs import get_config
    from repro.core.detect import ChecksumCanary
    from repro.core.faults import InjectionPlan, inject
    from repro.core.icp import promote
    from repro.core.microcheckpoint import MicroCheckpointer
    from repro.core.recover import RecoveryRuntime
    from repro.data.pipeline import TokenPipeline
    from repro.distributed.context import DistContext
    from repro.kernels import digest as kd
    from repro.kernels.ops import leaf_key
    from repro.launch.specs import bind_state
    from repro.train.loop import make_train_step

    src, out = sys.argv[1], sys.argv[2]
    with open(src, "rb") as f:
        inp = pickle.load(f)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    ctx = DistContext.for_mesh(mesh)
    res = {}

    def boxes(x):
        return [[(0 if s.start is None else s.start,
                  d if s.stop is None else s.stop)
                 for s, d in zip(idx, x.shape)]
                for idx in kd.shard_indices(x)]

    # -- the toy tree of SHARDED_PROG --------------------------------------
    put = lambda x, *s: jax.device_put(jnp.asarray(x),
                                       NamedSharding(mesh, P(*s)))
    specs = inp["toy_specs"]
    tree = {k: put(v, *specs[k]) for k, v in inp["toy"].items()}
    plan = kd.sharded_plan_for(tree, mesh)
    table = np.asarray(plan.digest_table(tree))
    res["toy_keys"] = list(plan.keys)
    res["toy_table"] = table.tolist()
    res["toy_oracle"] = bool(all(
        np.array_equal(table[:, i], kd.host_shard_checksums(tree[k]))
        for i, k in enumerate(plan.keys)))
    canary = ChecksumCanary(tree, n_slices=1, ctx=ctx)
    res["toy_clean"] = canary.check(0, tree) is None
    kd.STATS.reset()
    canary.check(1, tree)
    res["toy_stats"] = list(kd.STATS.snapshot())
    bad = dict(tree)
    bad["b"] = tree["b"].at[0, 20].set(99.0)
    rep = canary.check(2, bad)
    res["toy_leaves"] = rep.leaves
    res["toy_shards"] = rep.shards

    # -- the iterpro-100m smoke state, bound ---------------------------------
    cfg = get_config("iterpro-100m").smoke()
    pipe = TokenPipeline(cfg.model.vocab_size, inp["S"], inp["B"], seed=0)
    state0 = jax.tree_util.tree_map(jnp.asarray, inp["state"])
    state0, raw, bfn, sh = bind_state(
        ctx, cfg, state0, make_train_step(cfg, global_batch=inp["B"]),
        lambda s: pipe.batch_at(s))
    step = jax.jit(raw)
    flat = jax.tree_util.tree_flatten_with_path(state0)[0]
    res["boxes"] = {leaf_key(p): boxes(x) for p, x in flat}
    splan = kd.sharded_plan_for(state0, mesh)
    res["keys"] = list(splan.keys)
    res["table"] = np.asarray(splan.digest_table(state0)).tolist()

    # -- the shard_patch scenario -------------------------------------------
    clone = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.array(x, copy=True), t)
    micro = MicroCheckpointer(interval=2, ctx=ctx)
    canary = ChecksumCanary(state0, n_slices=1, ctx=ctx)
    runtime = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                              iv_registry=promote(cfg, inp["B"]),
                              micro=micro, shardings=sh)
    state = clone(state0)
    losses = []
    for s in range(4):
        micro.maybe_snapshot(s, state)
        ns, m = step(state, bfn(s))
        assert canary.check_and_arm(s, state, ns) is None
        losses.append(float(m["loss"]))
        state = ns
    micro.maybe_snapshot(4, state)
    res["losses"] = losses
    truth = {leaf_key(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(state)[0]}
    up = inp["up"]
    bad = inject(state, InjectionPlan(up, 1000, 30, 0, "params"))
    ns, m = step(bad, bfn(4))
    rep = canary.check_and_arm(4, bad, ns)
    res["injured"] = rep.shards["params/" + up]
    fixed, ev = runtime.recover(bad, rep, 4)
    res["rung"] = ev.rung
    res["bytes_moved"] = ev.bytes_moved
    res["healed_exact"] = all(
        np.array_equal(np.asarray(x), truth[leaf_key(p)]) for p, x in
        jax.tree_util.tree_flatten_with_path(fixed)[0])
    state = fixed
    ns, m = step(state, bfn(5))
    canary.refresh(state)
    bad = inject(state, InjectionPlan(up, 1000, 30, 0, "params"))
    ns, m = step(bad, bfn(5))
    rep = canary.check_and_arm(5, bad, ns)
    fixed2, ev2 = runtime.recover(bad, rep, 5)
    res["rung2"] = ev2.rung
    res["attempted2"] = list(ev2.attempted)

    # -- donation and fused detection compose on the mesh --------------------
    # (test_sharded_resilience.py::test_donation_and_fused_detect_compose_
    # on_mesh, at K = inp["K"])
    K = inp["K"]
    plain = clone(state0)
    for s in range(2 * K):
        plain, _ = step(plain, bfn(s))
    fstate = clone(state0)
    fcan = ChecksumCanary(fstate, n_slices=K, ctx=ctx)
    factory = fcan.fuse_into_step(raw, donate=True)
    for s in range(2 * K):
        if s == K:
            kd.STATS.reset()
        fstate, _, rep = factory.step(s, fstate, bfn(s))
        assert rep is None
    res["fused_stats"] = list(kd.STATS.snapshot())
    res["fused_exact"] = all(
        np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
            jax.tree_util.tree_leaves(fstate),
            jax.tree_util.tree_leaves(plain)))
    fused = {leaf_key(p): np.asarray(x) for p, x in
             jax.tree_util.tree_flatten_with_path(fstate)[0]}

    # -- partial refresh of a sharded canary (test_sharded_resilience.py::
    # test_partial_refresh_patches_without_generation_bump) ------------------
    pcan = ChecksumCanary(tree, n_slices=3, ctx=ctx)
    st, ok = tree, True
    for s in range(3):
        pcan.arm_current(s, st)
        ok = ok and pcan.check(s, st) is None
    gen = pcan.generation
    st = dict(st)
    st["a"] = st["a"] * jnp.float32(1.5)
    pcan.refresh(st, keys=["a"])
    res["partial_gen_kept"] = pcan.generation == gen
    for s in range(3, 6):
        ok = ok and pcan.check(s, st) is None
        pcan.arm_current(s + 1, st)
    res["partial_ok"] = bool(ok)
    res["partial_table"] = np.asarray(pcan.reference).tolist()

    # -- the parity slice map (test_parity.py::
    # test_tp_sharded_slice_map_regression, on the 4 x 2 mesh) ---------------
    from repro.core.parity import ParityStore
    tp = {}
    leaf = jnp.arange(16 * 256, dtype=jnp.float32).reshape(16, 256)
    shw = NamedSharding(mesh, P(None, "model"))
    ps = ParityStore({"w": jax.device_put(leaf, shw)}, ctx=ctx)
    ps.build({"w": jax.device_put(leaf, shw)}, 0)
    tp["n_blocks"] = ps.plan.n_blocks["w"]
    tp["device_block"] = list(ps.plan.device_block["w"])
    tp["holders"] = list(ps.plan.block_devices("w", 1))
    tp["parity"] = np.asarray(ps.parity).tolist()
    wiped = np.asarray(leaf).copy()
    wiped[:, 128:] = 0.0
    rec = np.asarray(ps.reconstruct_shard(
        jax.device_put(jnp.asarray(wiped), shw), "w", 1))
    tp["rec_exact"] = bool(np.array_equal(rec, np.asarray(leaf)[:, 128:]))
    rleaf = jnp.arange(512, dtype=jnp.float32)
    shr = NamedSharding(mesh, P(None))
    rps = ParityStore({"w": jax.device_put(rleaf, shr)}, ctx=ctx)
    rps.build({"w": jax.device_put(rleaf, shr)}, 0)
    tp["r_n_blocks"] = rps.plan.n_blocks["w"]
    rec = np.asarray(rps.reconstruct_shard(
        jax.device_put(jnp.zeros_like(rleaf), shr), "w", 0))
    tp["r_rec_exact"] = bool(np.array_equal(rec.ravel(), np.asarray(rleaf)))
    res["tp"] = tp

    # -- a sharded parity build and three gated updates -----------------------
    cur = clone(state0)
    ps = ParityStore(cur, ctx=ctx)
    ps.build(cur, 0)
    rows = [np.asarray(ps.parity)]
    update = jax.jit(ps.plan.update_leaves)
    for new_np, flag in zip(inp["updates"], inp["flags"]):
        new = jax.tree_util.tree_map_with_path(
            lambda p, x: jax.device_put(jnp.asarray(new_np[leaf_key(p)]),
                                        x.sharding)
            if leaf_key(p) in new_np else x, cur)
        ps.parity = update(ps.parity, ps.plan.leaves(cur),
                           ps.plan.leaves(new), jnp.bool_(flag))
        rows.append(np.asarray(ps.parity))
        if not flag:
            cur = new
    res["parity_crow"] = int(rows[0].shape[1])

    # -- triage on the sharded canary: a bit-2 and a bit-30 opt/v flip --------
    tstate = clone(state0)
    tcan = ChecksumCanary(tstate, n_slices=1, ctx=ctx)
    tmicro = MicroCheckpointer(interval=1, ctx=ctx)
    trt = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                          iv_registry=promote(cfg, inp["B"]), micro=tmicro,
                          shardings=sh, canary=tcan, triage=True)
    for s in range(2):
        ns, _ = step(tstate, bfn(s))
        assert tcan.check_and_arm(s, tstate, ns) is None
        tstate = ns
    tmicro.maybe_snapshot(2, tstate)
    vkey = "opt/v/" + up
    tri = {}
    for name, (elem, bit) in inp["tri_flips"].items():
        bad = inject(tstate, InjectionPlan("v/" + up, elem, bit, 0, "opt"))
        ns, _ = step(bad, bfn(2))
        rep = tcan.check_and_arm(2, bad, ns)
        rep.resolve()
        vleaf = [x for p, x in jax.tree_util.tree_flatten_with_path(bad)[0]
                 if leaf_key(p) == vkey][0]
        fbit, cands = trt._localise_flip(vkey, vleaf, np.asarray(vleaf))
        fixed, ev = trt.recover(bad, rep, 2)
        tri[name] = {"bit": int(fbit), "cands": [int(j) for j, _, _ in
                                                 cands],
                     "leaves": rep.leaves, "shards": rep.shards,
                     "rung": ev.rung, "attempted": list(ev.attempted),
                     "bytes": int(ev.bytes_moved)}
        tstate = fixed
        tcan.refresh(tstate)
    res["triage"] = tri

    # -- elastic (tests/test_elastic.py) --------------------------------------
    # TestRowSafeReconstruction on its toy tree: the row-safe plan, every
    # row's survivor parity, the reconstructions, the dedup edge, the
    # legacy refusal and the degraded target
    from repro.launch.elastic import ElasticManager, _host_regather
    el = {}
    etree = {k: put(v, *inp["etoy_specs"][k])
             for k, v in inp["etoy"].items()}
    eps = ParityStore(etree, ctx=ctx, row_safe=True)
    eps.build(etree)
    eplan = eps.plan
    el["keys"] = list(eplan.keys)
    el["groups"] = {k: [list(g) for g in eplan.groups[k]]
                    for k in eplan.keys}
    el["offsets"] = {k: int(eplan.offsets[k]) for k in eplan.keys}
    el["stream_len"] = int(eplan.stream_len)
    el["buffer_shape"] = list(eplan.buffer_shape)
    pflats, recon = [], []
    for row in range(4):
        dead = set(ctx.row_devices(row))
        pflats.append(np.asarray(eplan.host_parity_flat(eps.parity, dead)))
        ok = True
        for key, leaf in etree.items():
            if key in eplan.key_set:
                full, missing = eplan.host_assemble_leaf(key, leaf, dead)
                blocks = eplan.host_surviving_blocks(key, leaf, dead)
                uniq, _ = eplan.slices[key]
                for b in missing:
                    full[tuple(slice(a, e) for a, e in uniq[b])] = \
                        eplan.host_reconstruct_block(key, b, pflats[-1],
                                                     blocks)
            else:
                full = _host_regather(leaf, dead)
            ok = ok and np.array_equal(
                np.atleast_1d(np.asarray(full)).view(np.uint8),
                np.atleast_1d(inp["etoy"][key]).view(np.uint8))
        recon.append(bool(ok))
    el["recon_ok"] = recon
    dead2 = set(ctx.row_devices(2))
    uniq, dmap = eplan.slices["wdup"]
    el["wdup"] = [len(uniq), len(dmap),
                  sorted(eplan.host_surviving_blocks("wdup", etree["wdup"],
                                                     dead2)),
                  list(eplan.host_assemble_leaf("wdup", etree["wdup"],
                                                dead2)[1])]
    legacy = ParityStore(etree, ctx=ctx)
    legacy.build(etree)
    try:
        legacy.plan.host_parity_flat(legacy.parity, set(ctx.row_devices(1)))
        el["legacy"] = "no error"
    except RuntimeError as e:
        el["legacy"] = str(e)
    try:
        ElasticManager(ctx).on_loss(
            step=0, dead_rows=(1,), state=etree,
            raw_step=lambda s, b: (s, {}), cfg=None,
            batch_fn=lambda s: None, pstore=legacy)
        el["legacy_on_loss"] = "no error"
    except RuntimeError as e:
        el["legacy_on_loss"] = str(e)
    res["elastic_toy"] = el
    np.save(out + "_pflats.npy", np.stack(pflats))

    # the chaos drill (_DRILL): fsdp, B=12, S=16, row 3 lost before step 3
    import dataclasses
    from repro.core.detect import FaultReport
    from repro.core.parity import ParityStore as PS
    fcfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, fsdp=True))
    EB, ES, KILL, STEPS = 12, 16, 3, 7
    epipe = TokenPipeline(fcfg.model.vocab_size, ES, EB, seed=0)
    dstate, draw, dbfn, dsh = bind_state(
        ctx, fcfg, jax.tree_util.tree_map(jnp.asarray, inp["state"]),
        make_train_step(fcfg, global_batch=EB), lambda s: epipe.batch_at(s))
    dstep = jax.jit(draw)
    dcan = ChecksumCanary(dstate, n_slices=1, ctx=ctx)
    dps = PS(dstate, ctx=ctx, row_safe=True)
    dps.build(dstate)
    dcan.attach_parity(dps)
    emgr = ElasticManager(ctx)
    drt = RecoveryRuntime(
        step_fn=dstep, batch_fn=dbfn, iv_registry=promote(fcfg, EB),
        micro=MicroCheckpointer(interval=2, ctx=ctx), parity=dps,
        shardings=dsh, canary=dcan,
        elastic=emgr.hook(raw_step=draw, cfg=fcfg,
                          batch_fn=lambda s: epipe.batch_at(s),
                          canary=dcan, pstore=dps))
    dr = {"covers": len(dps.plan.keys), "losses": []}
    for s in range(KILL):
        ns, m = dstep(dstate, dbfn(s))
        assert dcan.check_and_arm(s, dstate, ns) is None
        dr["losses"].append(float(m["loss"]))
        dstate = ns
    doracle = jax.tree_util.tree_map(np.asarray, dstate)
    dstate, dev_ = drt.recover(dstate, FaultReport(KILL, "external",
                                                   lost_rows=(3,)), KILL)
    resume = drt.pending_remesh
    dr["rung"], dr["attempted"] = dev_.rung, list(dev_.attempted)
    dr["event"] = {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in resume.event.to_dict().items()}
    dr["new_dp"] = int(resume.ctx.mesh.shape["data"])
    dr["same"] = all(np.array_equal(np.atleast_1d(a).view(np.uint8),
                                    np.atleast_1d(b).view(np.uint8))
                     for a, b in zip(jax.tree_util.tree_leaves(resume.state),
                                     jax.tree_util.tree_leaves(doracle)))
    resumed = {leaf_key(p): np.asarray(x) for p, x in
               jax.tree_util.tree_flatten_with_path(resume.state)[0]}
    st, after = resume.state, []
    for s in range(KILL, STEPS):
        ns, m = resume.step(st, resume.bfn(s))
        assert resume.canary.check_and_arm(s, st, ns) is None
        after.append(float(m["loss"]))
        st = ns
    dr["after"] = after
    res["drill"] = dr
    np.savez(out + "_drill.npz", **resumed)

    # two drills in one process (test_two_drills_in_one_process_...)
    tstate, traw, tbfn, tsh = bind_state(
        ctx, fcfg, jax.tree_util.tree_map(jnp.asarray, inp["state"]),
        make_train_step(fcfg, global_batch=EB), lambda s: epipe.batch_at(s))
    tst = jax.jit(traw)
    tcan2 = ChecksumCanary(tstate, n_slices=1, ctx=ctx)
    tps = PS(tstate, ctx=ctx, row_safe=True)
    tps.build(tstate)
    tcan2.attach_parity(tps)
    ns, m = tst(tstate, tbfn(0))
    assert tcan2.check_and_arm(0, tstate, ns) is None
    tmgr = ElasticManager(ctx)
    two = []
    r1 = tmgr.on_loss(step=1, dead_rows=(3,), state=ns, raw_step=traw,
                      cfg=fcfg, batch_fn=lambda s: epipe.batch_at(s),
                      canary=tcan2, pstore=tps)
    two.append({k: (list(v) if isinstance(v, tuple) else v)
                for k, v in r1.event.to_dict().items()})
    st1, m = r1.step(r1.state, r1.bfn(1))
    assert r1.canary.check_and_arm(1, r1.state, st1) is None
    r2 = tmgr.on_loss(step=2, dead_rows=(2,), state=st1,
                      raw_step=r1.raw_step, cfg=fcfg,
                      batch_fn=lambda s: epipe.batch_at(s),
                      canary=r1.canary, pstore=r1.pstore)
    two.append({k: (list(v) if isinstance(v, tuple) else v)
                for k, v in r2.event.to_dict().items()})
    res["two"] = {"events": two, "dead": sorted(tmgr.dead),
                  "slice_ids": list(tmgr.slice_ids),
                  "shapes": [dict(r1.ctx.mesh.shape),
                             dict(r2.ctx.mesh.shape)]}

    # the CLI drill (test_train_cli_elastic_kill_row_smoke)
    from repro.launch.train import train as jtrain
    cli = jtrain(cfg, steps=6, global_batch=8, seq_len=16, canary_slices=1,
                 mesh="4,2", parity=True, elastic=True, kill_row_at=3,
                 verbose=False)
    res["cli"] = json.loads(json.dumps(cli))

    # -- mesh serving: the reference's engine with ctx (its own seed-0
    # params, checked against the ones the port's ranks are given) ---------
    import random
    from repro.serving import Request as SReq, ServingEngine as SEng
    srv = {}
    ys = {}
    for name, prog in inp["serve"].items():
        scfg = get_config(prog["arch"]).smoke()
        eng = SEng(scfg, ctx=ctx, seed=0, max_replays=10**6, **prog["eng"])
        mine = {leaf_key(p): np.asarray(x) for p, x in
                jax.tree_util.tree_flatten_with_path(eng.params)[0]}
        want = {leaf_key(p): np.asarray(x) for p, x in
                jax.tree_util.tree_flatten_with_path(
                    inp["sparams"][prog["arch"]])[0]}
        first = {}

        def spy(report, *a, _h=eng.handle_fault, _f=first, **k):
            v = _h(report, *a, **k)
            if report is not None and not _f:
                _f["leaves"] = list(report.leaves)
                _f["shards"] = {q: [int(d) for d in w]
                                for q, w in report.shards.items()}
            return v
        eng.handle_fault = spy
        rng = random.Random(0)
        reqs = [SReq(rid=i, prompt=np.asarray(p, np.int32),
                     max_new_tokens=inp["serve_gen"])
                for i, p in enumerate(inp["serve_prompts"])]
        eng.warm()
        rep = eng.run(reqs, inject_every=prog["inject"], inject_rng=rng)
        sm = rep.summary()
        r = {"same_params": sorted(mine) == sorted(want) and all(
                 np.array_equal(np.atleast_1d(mine[k]).view(np.uint8),
                                np.atleast_1d(want[k]).view(np.uint8))
                 for k in want),
             "logs": {str(q): w["tokens"]
                      for q, w in rep.per_request.items()},
             "summary": {k: sm[k] for k in inp["serve_keys"]},
             "first": first,
             "keys": list(eng.canary.plan.keys),
             "table": np.asarray(eng.canary.reference).tolist()}
        if prog["eng"].get("parity"):
            r["refs"] = {k: np.asarray(v).tolist()
                         for k, v in eng._param_refs.items()}
            r["parity"] = np.asarray(eng.parity_store.parity).tolist()
            r["memory_bytes"] = int(eng.parity_store.memory_bytes)
            r["flip"] = list(eng.corrupt_param(rng))
            r["scrub"] = eng.scrub_params()
        srv[name] = r
    res["serve"] = json.loads(json.dumps(srv))

    # -- tests/test_moe.py's EP_PROG, every moe_impl and two capacities ---
    from repro.configs.base import ModelConfig
    from repro.models import moe as M
    mctx = DistContext.for_mesh(jax.make_mesh((2, 4), ("data", "model")),
                                fsdp=True)
    mp = jax.tree_util.tree_map(jnp.asarray, inp["moe_p"])
    moe = {}
    for impl, cf, size in inp["moe_cases"]:
        mx = jnp.asarray(inp["moe_x"][size])
        mcfg = ModelConfig(family="moe", n_layers=1, d_model=16,
                           n_heads=2, n_kv_heads=2, d_ff=32,
                           vocab_size=64, n_experts=8, top_k=2,
                           moe_d_ff=32, moe_impl=impl, moe_capacity=cf,
                           param_dtype="float32",
                           compute_dtype="float32")
        with mctx.mesh:
            y, aux = jax.jit(lambda p, x, c=mcfg: M.moe_apply(
                p, c, x, mctx))(mp, mx)
        moe[f"{impl}/{cf}/{size}"] = {"ep": bool(M.use_ep(mcfg, mctx)),
                                      "lb": float(aux["lb_loss"])}
        ys[f"{impl}/{cf}/{size}"] = np.asarray(y).reshape(-1, 16)
    res["moe"] = moe
    # -- tests/test_pipeline.py's PIPE_PROG ---------------------------------
    from repro.distributed.pipeline import pipeline_apply
    pmesh = jax.make_mesh((4,), ("stage",))
    pp = jax.tree_util.tree_map(jnp.asarray, inp["pipe_p"])
    with pmesh:
        ys["pipe"] = np.asarray(pipeline_apply(
            lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), pp,
            jnp.asarray(inp["pipe_x"]), pmesh, axis="stage"))

    with open(out + ".json", "w") as f:
        json.dump(res, f)
    np.savez(out + ".npz", **truth)
    np.savez(out + "_fused.npz", **fused)
    np.save(out + "_parity.npy", np.stack(rows))
    np.savez(out + "_ys.npz", **ys)
""")


#: the reference's family programs, in a child of their own beside
#: ``CHILD`` (the same 8 forced CPU devices and Auto axes)
CHILD_FAM = textwrap.dedent("""
    import os, sys, json, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    _make_mesh = jax.make_mesh
    jax.make_mesh = lambda shape, axes, **kw: _make_mesh(
        shape, axes, axis_types=(AxisType.Auto,) * len(shape))
    from repro.configs import get_config
    from repro.data.pipeline import TokenPipeline
    from repro.distributed.context import DistContext
    from repro.kernels.ops import leaf_key
    from repro.launch.specs import bind_state
    from repro.serving import Request as SReq, ServingEngine as SEng
    from repro.train.loop import make_train_step

    src, out = sys.argv[1], sys.argv[2]
    with open(src, "rb") as f:
        inp = pickle.load(f)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    ctx = DistContext.for_mesh(mesh)

    # -- the ssm, hybrid, encdec and vlm families: two bound mesh steps
    # from the given state, and a clean mesh serving run over the
    # engine's seed-0 params -----------------------------------------------
    import dataclasses
    from repro.launch.train import batch_for
    fam = {}
    for arch, kw in inp["fam"].items():
        fcfg = get_config(arch).smoke()
        fcfg = dataclasses.replace(fcfg, model=dataclasses.replace(
            fcfg.model, **kw))
        fpipe = TokenPipeline(fcfg.model.vocab_size, inp["S"], inp["B"],
                              seed=0)
        fst, fraw, fbfn, _ = bind_state(
            ctx, fcfg, jax.tree_util.tree_map(jnp.asarray,
                                              inp["fam_states"][arch]),
            make_train_step(fcfg, global_batch=inp["B"]),
            lambda s, c=fcfg, p=fpipe: batch_for(c, p, s))
        fstep = jax.jit(fraw)
        fl = []
        for s in range(2):
            fst, m = fstep(fst, fbfn(s))
            fl.append(float(m["loss"]))
        np.savez(out + "_fam_" + arch + ".npz",
                 **{leaf_key(p): np.asarray(x) for p, x in
                    jax.tree_util.tree_flatten_with_path(fst)[0]})
        eng = SEng(fcfg, ctx=ctx, seed=0, **inp["fam_eng"])
        mine = {leaf_key(p): np.asarray(x) for p, x in
                jax.tree_util.tree_flatten_with_path(eng.params)[0]}
        want = {leaf_key(p): np.asarray(x) for p, x in
                jax.tree_util.tree_flatten_with_path(
                    inp["fam_params"][arch])[0]}
        reqs = [SReq(rid=i, prompt=np.asarray(p, np.int32),
                     max_new_tokens=inp["serve_gen"],
                     features=inp["fam_features"][arch][i])
                for i, p in enumerate(inp["serve_prompts"])]
        eng.warm()
        rep = eng.run(reqs)
        fam[arch] = {"losses": fl,
                     "same_params": sorted(mine) == sorted(want) and all(
                         np.array_equal(np.asarray(mine[k]),
                                        np.asarray(want[k])) for k in want),
                     "logs": {str(q): w["tokens"]
                              for q, w in rep.per_request.items()}}
    # -- xlstm-350m-smoke in bf16: a 1 x 2 mesh's prefill and decode
    # logits against one device's (the mesh's bf16 drift) ----------------
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.distributed.sharding import param_specs
    from repro.models.registry import get_model
    x16 = inp["x16"]
    xcfg = get_config("xlstm-350m").smoke()
    xcfg = dataclasses.replace(xcfg, model=dataclasses.replace(
        xcfg.model, **x16["kw"]))
    xm = get_model(xcfg.model)
    xp = jax.tree_util.tree_map(jnp.asarray, x16["params"])

    def xfwd(p, c):
        lg, cache = xm.prefill(p, xcfg.model,
                               {"tokens": jnp.asarray(x16["tokens"])}, c,
                               max_len=x16["max_len"])
        d, _ = xm.decode_step(p, xcfg.model, cache, jnp.asarray(x16["tok"]),
                              c)
        return lg, d

    x_one = jax.jit(lambda p: xfwd(p, None))(xp)
    mesh12 = jax.make_mesh((1, 2), ("data", "model"),
                           devices=jax.devices()[:2])
    ctx12 = DistContext.for_mesh(mesh12)
    xsh = jax.tree_util.tree_map(
        lambda sp: NamedSharding(mesh12, sp),
        param_specs(ctx12, xp, xcfg.sharding, xcfg.model),
        is_leaf=lambda v: isinstance(v, PartitionSpec))
    with mesh12:
        x_two = jax.jit(lambda p: xfwd(p, ctx12))(jax.device_put(xp, xsh))
    fam["x16"] = {k: float(np.abs(np.asarray(a, np.float32) -
                                  np.asarray(b, np.float32)).max())
                  for k, a, b in zip(("prefill", "decode"), x_two, x_one)}
    with open(out + "_fam.json", "w") as f:
        json.dump(fam, f)

""")


FUSED_K = 2
#: the gated parity updates: a fault flag each (a set flag keeps the
#: parity, and the state, of the last healthy version)
UPDATE_FLAGS = (False, True, False)
UPDATE_KEYS = ("params/embed/table", "opt/m/groups/0/0/ffn/up/w",
               "params/final_norm/scale")
#: triage's flips in ``opt/v/`` + UP: (element, bit)
TRI_FLIPS = {"b2": (1000, 2), "b30": (1007, 30)}
#: mesh serving: the programs both packages run (the engine's flags, the
#: storm's cadence), every one over the same 4 requests of 8 tokens, 6
#: new tokens each, 4 slots
SERVE = {"paged+parity": {"arch": "iterpro-100m", "inject": 3,
                          "eng": dict(n_slots=4, max_len=15, canary_slices=4,
                                      donate=True, parity=True)},
         "dense": {"arch": "iterpro-100m", "inject": 3,
                   "eng": dict(n_slots=4, max_len=15, canary_slices=4,
                               donate=False, paged=False)},
         "kimi": {"arch": "kimi-k2-1t-a32b", "inject": 3,
                  "eng": dict(n_slots=4, max_len=15, canary_slices=4,
                              donate=True, parity=True)}}
SERVE_GEN = 6
#: the ssm, hybrid, encdec and vlm families at the
#: smoke size with every kind of block they have in two layers; each
#: runs two bound mesh steps and a clean serving run (4 requests, dense,
#: donated, no canary: the tokens are held, the canary and storms are
#: the ``storms`` spawn's; the enc-dec's with a source of max_len frames,
#: the VLM's text only, as the reference's CLI serves it)
FAMILIES = {"xlstm-350m": dict(mlstm_ratio=1),
            "zamba2-7b": dict(hybrid_ratio=1),
            "seamless-m4t-large-v2": {}, "qwen2-vl-7b": {}}
FAM_ENG = dict(n_slots=4, max_len=15, canary_slices=0, donate=True)
#: the bf16 forward: xlstm-350m-smoke with both block kinds, 2 prompts
#: of 8 tokens, a decode step
X16 = dict(kw=dict(mlstm_ratio=1, param_dtype="bfloat16",
                   compute_dtype="bfloat16"), max_len=16)
#: the reference's bf16 tolerance (chip_smoke.py's ``BF16_TOL``)
BF16_TOL = 3e-2
SERVE_KEYS = ("requests", "completed", "dropped", "tokens_out",
              "engine_steps", "admissions", "admission_rejected", "slots",
              "faults", "replay_tokens", "retracted_tokens")


def _updates(state):
    """Three new values of a few leaves (the same bits for both
    packages)."""
    rng = np.random.default_rng(5)
    flat = {}

    def walk(prefix, t):
        items = t.items() if isinstance(t, dict) else \
            enumerate(t) if isinstance(t, (list, tuple)) else None
        if items is None:
            flat[prefix] = t
            return
        for k, v in items:
            walk(f"{prefix}/{k}" if prefix else str(k), v)
    walk("", state)
    return [{k: (flat[k] + rng.standard_normal(flat[k].shape).astype(
        np.float32)) for k in UPDATE_KEYS} for _ in UPDATE_FLAGS]


#: tests/test_elastic.py's toy tree: data in dim 0, data in a middle dim,
#: bf16 over (model, data), data-sharded and replicated over model (the
#: dedup edge), replicated (the re-gather path)
ETOY_SPECS = {"w0": ("data", "model"), "w3d": (None, "data", "model"),
              "wbf": ("model", "data"), "wdup": ("data", None), "wrep": ()}


def _etoy(jax, jnp):
    k = jax.random.PRNGKey
    return {"w0": np.asarray(jax.random.normal(k(0), (12, 8))),
            "w3d": np.asarray(jax.random.normal(k(1), (1, 60, 64))),
            "wbf": np.asarray(jax.random.normal(k(2), (4, 12)).astype(
                jnp.bfloat16)),
            "wdup": np.asarray(jax.random.normal(k(3), (12, 6))),
            "wrep": np.asarray(jax.random.normal(k(4), (8,)))}


def _toy(jax, jnp):
    k = jax.random.PRNGKey
    return {"a": np.asarray(jax.random.normal(k(0), (16, 64))),
            "b": np.asarray(jax.random.normal(k(1), (8, 32))),
            "c": np.asarray(jax.random.normal(k(2), (64,)).astype(
                jnp.bfloat16)),
            "s": np.asarray(jnp.int32(7))}


def _port_ranks(inp_path):
    """One rank of the port's 4 x 2 mesh running the oracle's scenarios;
    returns what the tests compare."""
    import torch
    from repro_torch.bridge import state_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import InjectionPlan, inject
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import (P, gather_tree,
                                                  local_tree, shardings_for)
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import bind_state
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import flatten_with_path, leaf_key

    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    ctx = make_context("4,2", torch.device("cpu"))
    me = ctx.shard_id
    res = {"shard_id": me}

    def boxes(sh):
        return [[(0 if s.start is None else s.start,
                  d if s.stop is None else s.stop)
                 for s, d in zip(box, sh.shape)]
                for box in kd.shard_indices(sh)]

    # -- the toy tree of SHARDED_PROG --------------------------------------
    toy = state_from_numpy(inp["toy"])
    tsh = shardings_for(ctx, {k: P(*v) for k, v in inp["toy_specs"].items()},
                        toy)
    local = local_tree(toy, tsh)
    plan = kd.sharded_plan_for(local, ctx)
    res["toy_keys"] = list(plan.keys)
    res["toy_table"] = kd.fetch(
        plan.gather_table(plan.digest_table(local))).tolist()
    res["toy_oracle"] = all(
        np.array_equal(np.asarray(res["toy_table"])[:, i],
                       kd.host_shard_checksums(toy[k], tsh[k]))
        for i, k in enumerate(plan.keys))
    canary = ChecksumCanary(local, n_slices=1, ctx=ctx)
    res["toy_clean"] = canary.check(0, local) is None
    kd.STATS.reset()
    canary.check(1, local)
    res["toy_stats"] = list(kd.STATS.snapshot())
    j = tsh["b"].local_index(0 * 32 + 20)
    bad = dict(local, b=local["b"].clone())
    if j is not None:
        bad["b"].view(-1)[j] = 99.0
    rep = canary.check(2, bad)
    res["toy_leaves"] = rep.leaves
    res["toy_shards"] = rep.shards

    # -- the iterpro-100m smoke state, bound ---------------------------------
    cfg = get_config("iterpro-100m").smoke()
    pipe = TokenPipeline(cfg.model.vocab_size, inp["S"], inp["B"], seed=0)
    state0, step, bfn, sh = bind_state(
        ctx, cfg, state_from_numpy(inp["state"]),
        make_train_step(cfg, global_batch=inp["B"]),
        lambda s: pipe.batch_at(s))
    res["boxes"] = {leaf_key(p): boxes(x)
                    for p, x in flatten_with_path(sh)}
    splan = kd.sharded_plan_for(state0, ctx)
    res["keys"] = list(splan.keys)
    res["table"] = kd.fetch(
        splan.gather_table(splan.digest_table(state0))).tolist()

    # -- the shard_patch scenario -------------------------------------------
    micro = MicroCheckpointer(interval=2, ctx=ctx, shardings=sh)
    canary = ChecksumCanary(state0, n_slices=1, ctx=ctx)
    runtime = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                              iv_registry=promote(cfg, inp["B"]),
                              micro=micro, shardings=sh)
    state = state0
    losses = []
    for s in range(4):
        micro.maybe_snapshot(s, state)
        ns, m = step(state, bfn(s))
        assert canary.check_and_arm(s, state, ns) is None
        losses.append(float(m["loss"]))
        state = ns
    micro.maybe_snapshot(4, state)
    res["losses"] = losses
    truth = {leaf_key(p): t.clone() for p, t in flatten_with_path(state)}
    res["state"] = {k: t.numpy() for k, t in
                    ((leaf_key(p), t) for p, t in
                     flatten_with_path(gather_tree(state, sh)))}
    up = inp["up"]
    inject(state, InjectionPlan(up, 1000, 30, 0, "params"), shardings=sh)
    ptrs = {leaf_key(p): t.data_ptr() for p, t in flatten_with_path(state)}
    ns, m = step(state, bfn(4))
    rep = canary.check_and_arm(4, state, ns)
    res["injured"] = rep.shards["params/" + up]
    fixed, ev = runtime.recover(state, rep, 4)
    res["rung"] = ev.rung
    res["bytes_moved"] = ev.bytes_moved
    res["block_bytes"] = sh["params"]["groups"][0][0]["ffn"]["up"][
        "w"].nbytes_local
    healed = {leaf_key(p): t for p, t in flatten_with_path(fixed)}
    res["healed_exact"] = all(
        torch.equal(healed[k].view(-1).view(torch.uint8),
                    truth[k].view(-1).view(torch.uint8)) for k in truth)
    moved = {k for k in healed if healed[k].data_ptr() != ptrs[k]}
    res["moved_leaves"] = sorted(moved)
    state = fixed
    canary.refresh(state)
    inject(state, InjectionPlan(up, 1000, 30, 0, "params"), shardings=sh)
    ns, m = step(state, bfn(5))
    rep = canary.check_and_arm(5, state, ns)
    fixed2, ev2 = runtime.recover(state, rep, 5)
    res["rung2"] = ev2.rung
    res["attempted2"] = list(ev2.attempted)
    res.update(_port_modes(ctx, cfg, inp, toy, tsh, local))
    res["serve"] = _port_serve(ctx, inp)
    res["fam"] = _port_families(ctx, inp)
    res["x16"] = _port_x16(ctx, inp)
    res["moe_pipe"] = _port_moe_pipe(inp)
    res.update(_port_elastic(ctx, cfg, inp))
    everyone = coll.gather_objects(res, ctx.group(ctx.axis_names))
    return everyone if me == 0 else None


def _port_modes(ctx, cfg, inp, toy, tsh, local):
    """The oracle's training-mode scenarios on this rank."""
    import torch
    from repro_torch.bridge import state_from_numpy
    from repro_torch.core.detect import ChecksumCanary
    from repro_torch.core.faults import InjectionPlan, inject
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.parity import ParityStore
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import (P, gather_tree, local_tree,
                                                  shardings_for)
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.specs import bind_state
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import flatten_with_path, leaf_key, replace_leaves

    res = {}
    pipe = TokenPipeline(cfg.model.vocab_size, inp["S"], inp["B"], seed=0)

    def bound(donate):
        return bind_state(ctx, cfg, state_from_numpy(inp["state"]),
                          make_train_step(cfg, global_batch=inp["B"],
                                          donate=donate),
                          lambda s: pipe.batch_at(s))

    # donation and fused detection compose on the mesh
    K = inp["K"]
    plain, step, bfn, sh = bound(False)
    fstate, dstep, dbfn, _ = bound(True)
    factory = ChecksumCanary(fstate, n_slices=K, ctx=ctx).fuse_into_step(
        dstep, donate=True)
    for s in range(2 * K):
        if s == K:
            kd.STATS.reset()
        plain, _ = step(plain, bfn(s))
        fstate, _, rep = factory.step(s, fstate, dbfn(s))
        assert rep is None
    res["fused_stats"] = list(kd.STATS.snapshot())
    res["fused_exact"] = all(
        torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
        for (_, a), (_, b) in zip(flatten_with_path(fstate),
                                  flatten_with_path(plain)))
    res["fused_state"] = {leaf_key(p): t.numpy() for p, t in
                          flatten_with_path(gather_tree(fstate, sh))}

    # partial refresh of a sharded canary
    pcan = ChecksumCanary(local, n_slices=3, ctx=ctx)
    st, ok = local, True
    for s in range(3):
        pcan.arm_current(s, st)
        ok = ok and pcan.check(s, st) is None
    gen = pcan.generation
    st = dict(st, a=st["a"] * torch.tensor(1.5, dtype=torch.float32))
    pcan.refresh(st, keys=["a"])
    res["partial_gen_kept"] = pcan.generation == gen
    for s in range(3, 6):
        ok = ok and pcan.check(s, st) is None
        pcan.arm_current(s + 1, st)
    res["partial_ok"] = bool(ok)
    res["partial_table"] = kd.fetch(
        pcan.plan.gather_table(pcan.reference)).tolist()

    # the parity slice map
    tp = {}
    leaf = torch.arange(16 * 256, dtype=torch.float32).reshape(16, 256)
    wsh = shardings_for(ctx, {"w": P(None, "model")}, {"w": leaf})
    mine = local_tree({"w": leaf}, wsh)
    ps = ParityStore(mine, ctx=ctx, shardings=wsh)
    ps.build(mine, 0)
    tp["n_blocks"] = ps.plan.n_blocks["w"]
    tp["device_block"] = list(ps.plan.device_block["w"])
    tp["holders"] = list(ps.plan.block_devices("w", 1))
    tp["parity"] = ps.parity.reshape(-1)[:ps.plan.row_words].tolist()
    wiped = leaf.clone()
    wiped[:, 128:] = 0.0
    rec = ps.reconstruct_shard(wsh["w"].local(wiped), "w", 1)
    tp["rec_exact"] = torch.equal(rec, leaf[:, 128:])
    rleaf = torch.arange(512, dtype=torch.float32)
    rsh = shardings_for(ctx, {"w": P(None)}, {"w": rleaf})
    rps = ParityStore({"w": rleaf.clone()}, ctx=ctx, shardings=rsh)
    rps.build({"w": rleaf.clone()}, 0)
    tp["r_n_blocks"] = rps.plan.n_blocks["w"]
    rec = rps.reconstruct_shard(torch.zeros_like(rleaf), "w", 0)
    tp["r_rec_exact"] = torch.equal(rec, rleaf)
    res["tp"] = tp

    # a sharded parity build and three gated updates: this rank's row
    cur, _, _, _ = bound(False)
    ps = ParityStore(cur, ctx=ctx, shardings=sh)
    ps.build(cur, 0)
    rows = [ps.parity.reshape(-1)[:ps.plan.row_words].clone()]
    shk = {leaf_key(p): x for p, x in flatten_with_path(sh)}
    for new_np, flag in zip(inp["updates"], inp["flags"]):
        new = replace_leaves(cur, {
            k: shk[k].local(torch.from_numpy(v)) for k, v in new_np.items()})
        ps.plan.update_leaves(ps.parity, ps.plan.leaves(cur),
                              ps.plan.leaves(new), torch.tensor(flag))
        rows.append(ps.parity.reshape(-1)[:ps.plan.row_words].clone())
        if not flag:
            cur = new
    res["parity_rows"] = torch.stack(rows).numpy()

    # triage on the sharded canary: a bit-2 and a bit-30 opt/v flip
    tstate, _, _, _ = bound(False)
    tcan = ChecksumCanary(tstate, n_slices=1, ctx=ctx)
    tmicro = MicroCheckpointer(interval=1, ctx=ctx, shardings=sh)
    trt = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                          iv_registry=promote(cfg, inp["B"]), micro=tmicro,
                          shardings=sh, canary=tcan, triage=True)
    for s in range(2):
        ns, _ = step(tstate, bfn(s))
        assert tcan.check_and_arm(s, tstate, ns) is None
        tstate = ns
    tmicro.maybe_snapshot(2, tstate)
    vkey = "opt/v/" + inp["up"]
    tri = {}
    for name, (elem, bit) in inp["tri_flips"].items():
        inject(tstate, InjectionPlan("v/" + inp["up"], elem, bit, 0, "opt"),
               shardings=sh)
        ns, _ = step(tstate, bfn(2))
        rep = tcan.check_and_arm(2, tstate, ns)
        rep.resolve()
        mine = ctx.shard_id in rep.shards.get(vkey, ())
        loc = None
        if mine:
            vleaf = {leaf_key(p): x for p, x in
                     flatten_with_path(tstate)}[vkey]
            fbit, js, _, _ = trt._localise_flip(vkey, vleaf, shk[vkey])
            loc = (int(fbit), [int(j) for j in js])
        fixed, ev = trt.recover(tstate, rep, 2)
        tri[name] = {"loc": loc, "leaves": rep.leaves,
                     "shards": rep.shards, "rung": ev.rung,
                     "attempted": list(ev.attempted),
                     "bytes": int(ev.bytes_moved)}
        tstate = fixed
        tcan.refresh(tstate)
    res["triage"] = tri
    return res


def _port_serve(ctx, inp):
    """The oracle's mesh serving programs on this rank, over the
    reference's params (bridged): logs, counters, the first report, this
    rank's canary rows and parity row, the per-shard param refs, the
    scrub."""
    import random
    from repro_torch.bridge import state_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.kernels import digest as kd
    from repro_torch.serving import Request, ServingEngine

    out = {}
    for name, prog in inp["serve"].items():
        cfg = get_config(prog["arch"]).smoke()
        eng = ServingEngine(cfg, ctx=ctx, device="cpu", max_replays=10**6,
                            params=state_from_numpy(
                                inp["sparams"][prog["arch"]]),
                            **prog["eng"])
        first = {}

        def spy(report, *a, _h=eng.handle_fault, _f=first, **k):
            v = _h(report, *a, **k)
            if report is not None and not _f:
                _f["leaves"] = list(report.leaves)
                _f["shards"] = {q: [int(d) for d in w]
                                for q, w in report.shards.items()}
            return v
        eng.handle_fault = spy
        rng = random.Random(0)
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                        max_new_tokens=inp["serve_gen"])
                for i, p in enumerate(inp["serve_prompts"])]
        eng.warm()
        rep = eng.run(reqs, inject_every=prog["inject"], inject_rng=rng)
        sm = rep.summary()
        r = {"logs": {str(q): w["tokens"]
                      for q, w in rep.per_request.items()},
             "summary": {k: sm[k] for k in inp["serve_keys"]},
             "first": first,
             "keys": list(eng.canary.plan.keys),
             "table": kd.fetch(eng.canary.plan.gather_table(
                 eng.canary.reference)).tolist()}
        if prog["eng"].get("parity"):
            pst = eng.parity_store
            r["refs"] = {k: np.asarray(v).tolist()
                         for k, v in eng._param_refs.items()}
            r["parity"] = pst.parity.reshape(-1)[
                :pst.plan.row_words].tolist()
            r["memory_bytes"] = pst.memory_bytes
            r["flip"] = list(eng.corrupt_param(rng))
            r["scrub"] = eng.scrub_params()
        out[name] = json.loads(json.dumps(r))
    return out


def _port_families(ctx, inp):
    """The families' programs on this rank: two bound mesh steps from the
    reference's state (losses; the gathered state on shard 0) and the
    mesh engine's clean run over the reference's params (logs)."""
    import dataclasses
    import torch
    from repro_torch.bridge import state_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.specs import bind_state
    from repro_torch.launch.train import batch_for
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import flatten_with_path, leaf_key

    out = {}
    for arch, kw in inp["fam"].items():
        cfg = get_config(arch).smoke()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **kw))
        pipe = TokenPipeline(cfg.model.vocab_size, inp["S"], inp["B"],
                             seed=0)
        st, step, bfn, sh = bind_state(
            ctx, cfg, state_from_numpy(inp["fam_states"][arch]),
            make_train_step(cfg, global_batch=inp["B"]),
            lambda s, c=cfg, p=pipe: batch_for(c, p, s))
        losses = []
        for s in range(2):
            st, m = step(st, bfn(s))
            losses.append(float(m["loss"]))
        full = gather_tree(st, sh)
        r = {"losses": losses}
        if ctx.shard_id == 0:
            r["state"] = {leaf_key(p): t.numpy()
                          for p, t in flatten_with_path(full)}
        eng = ServingEngine(cfg, ctx=ctx, device="cpu",
                            params=state_from_numpy(inp["fam_params"][arch]),
                            **inp["fam_eng"])
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                        max_new_tokens=inp["serve_gen"],
                        features={k: torch.from_numpy(v) for k, v in
                                  inp["fam_features"][arch][i].items()})
                for i, p in enumerate(inp["serve_prompts"])]
        rep = eng.run(reqs)
        r["logs"] = {str(q): w["tokens"] for q, w in rep.per_request.items()}
        out[arch] = r
    return out


def _port_x16(ctx, inp):
    """The bf16 forward on this rank: the model axis's prefill and decode
    logits from the rank's blocks against one device's (whole params, no
    ``tp``), the largest distance of each."""
    import dataclasses
    import torch
    from repro_torch.bridge import state_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.sharding import gather_tree, local_tree
    from repro_torch.launch.specs import param_shardings
    from repro_torch.models.registry import get_model

    x16 = inp["x16"]
    cfg = get_config("xlstm-350m").smoke()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **x16["kw"]))
    model = get_model(cfg.model)
    params = state_from_numpy(x16["params"])
    psh, _ = param_shardings(ctx, cfg, params)
    read = gather_tree(local_tree(params, psh), psh, axes=ctx.batch_axes)

    def fwd(p, tp):
        lg, cache = model.prefill(p, cfg.model, {
            "tokens": torch.from_numpy(x16["tokens"])},
            max_len=x16["max_len"], tp=tp)
        d, _ = model.decode_step(p, cfg.model, cache,
                                 torch.from_numpy(x16["tok"]), tp=tp)
        return lg, d

    two = fwd(read, TP.for_model(ctx, cfg.model))
    one = fwd(params, None)
    return {k: float((a.float() - b.float()).abs().max())
            for k, a, b in zip(("prefill", "decode"), two, one)}


#: EP_PROG's schedules, capacities and token counts: its 32 tokens
#: (16 a data row: no expert passes the minimum capacity of 8, so 1.25
#: drops nothing there either) and 512, where 1.25 drops rows
MOE_IMPLS = ("ep_a2a", "ep_token_a2a", "tp_ragged")
MOE_CFS = (8.0, 1.25)
MOE_SIZES = (8, 128)           # sequence length of EP_PROG's (4, S, 16)
MOE_CASES = tuple((i, c, n) for i in MOE_IMPLS for c in MOE_CFS
                  for n in MOE_SIZES)


def _moe_prog(jax, jnp):
    """EP_PROG's params and tokens (PRNGKey(0)), and PIPE_PROG's (S 4,
    M 6, B 2, d 8) with its sequential truth."""
    from repro.configs.base import ModelConfig
    from repro.models import moe as M
    cfg = ModelConfig(family="moe", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=2, d_ff=32, vocab_size=64, n_experts=8,
                      top_k=2, moe_d_ff=32, param_dtype="float32",
                      compute_dtype="float32")
    key = jax.random.PRNGKey(0)
    p = jax.tree_util.tree_map(np.asarray, M.moe_init(key, cfg,
                                                      jnp.float32))
    x = {n: np.asarray(jax.random.normal(jax.random.fold_in(key, i + 1),
                                         (4, n, cfg.d_model)))
         for i, n in enumerate(MOE_SIZES)}
    S, Mb, Bp, d = 4, 6, 2, 8
    ks = jax.random.split(key, S)
    pp = {"w": np.asarray(jnp.stack([jax.random.normal(k, (d, d)) * 0.3
                                     for k in ks])),
          "b": np.asarray(jnp.stack([jax.random.normal(k, (d,)) * 0.1
                                     for k in ks]))}
    xs = np.asarray(jax.random.normal(jax.random.fold_in(key, 9),
                                      (Mb, Bp, d)))
    truth = xs
    for i in range(S):
        truth = np.tanh(truth @ pp["w"][i] + pp["b"][i])
    return {"moe_p": p, "moe_x": x, "moe_cases": MOE_CASES,
            "pipe_p": pp, "pipe_x": xs,
            "pipe_truth": truth.astype(np.float32)}


def _port_moe_pipe(inp):
    """EP_PROG on a 2 x 4 context made by the 8 ranks (fsdp: the expert
    blocks split over data too, gathered per call), each rank's data
    rows; PIPE_PROG over a 4-wide stage axis (two pipelines)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.bridge import state_from_numpy
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import P, LeafSharding
    from repro_torch.launch.mesh import make_context
    from repro_torch.models import moe as M

    ctx = make_context("2,4", torch.device("cpu"), fsdp=True)
    tp = TP.TensorParallel(ctx)
    row = ctx.coords(ctx.shard_id)["data"]
    p = state_from_numpy(inp["moe_p"])
    out = {"row": row}
    for impl, cf, size in MOE_CASES:
        x = torch.from_numpy(inp["moe_x"][size])[2 * row:2 * row + 2]
        cfg = ModelConfig(family="moe", n_layers=1, d_model=16,
                          n_heads=2, n_kv_heads=2, d_ff=32,
                          vocab_size=64, n_experts=8, top_k=2,
                          moe_d_ff=32, moe_impl=impl, moe_capacity=cf,
                          param_dtype="float32",
                          compute_dtype="float32")
        ep = M.use_ep(cfg, ctx)
        specs = {"gate": P("model", "data", None) if ep else
                 P(None, "data", "model"),
                 "down": P("model", None, "data") if ep else
                 P(None, "model", "data")}
        specs["up"] = specs["gate"]
        blocks = {"router": p["router"]}
        for k, sp in specs.items():
            blocks[k] = LeafSharding(ctx, sp, tuple(p[k].shape),
                                     p[k].dtype).local(p[k])
        with torch.no_grad():
            y, aux = M.moe_apply(blocks, cfg, x, tp=tp)
        out[f"{impl}/{cf}/{size}"] = {"ep": ep,
                                      "lb": float(aux["lb_loss"]),
                                      "y": y.reshape(-1, 16).numpy()}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "stage"))
    sctx = DistContext.for_mesh(mesh, torch.device("cpu"))
    out["pipe"] = pipeline_apply(
        lambda q, h: torch.tanh(h @ q["w"] + q["b"]),
        state_from_numpy(inp["pipe_p"]), torch.from_numpy(inp["pipe_x"]),
        sctx, axis="stage").numpy()
    return out


def _port_elastic(ctx, cfg, inp):
    """The oracle's elastic programs on this rank: the row-safe toy tree
    (every row's survivor parity and reconstructions, the dedup edge, the
    legacy refusals), the chaos drill, two drills in one process and the
    CLI drill.  A rank of a lost row poisons its blocks and skips to the
    next program (it takes no collective of the survivors)."""
    import dataclasses
    import torch
    from repro_torch.bridge import state_from_numpy
    from repro_torch.core.detect import ChecksumCanary, FaultReport
    from repro_torch.core.icp import promote
    from repro_torch.core.microcheckpoint import MicroCheckpointer
    from repro_torch.core.parity import ParityStore
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import (P, gather_tree, local_tree,
                                                  shardings_for)
    from repro_torch.kernels import digest as kd
    from repro_torch.launch.elastic import ElasticManager, _host_regather
    from repro_torch.launch.mesh import make_context
    from repro_torch.launch.specs import bind_state
    from repro_torch.launch.train import train
    from repro_torch.train.loop import make_train_step
    from repro_torch.tree import flatten_with_path, leaf_key, leaves

    def row_of(c):
        return c.coords(c.shard_id)[c.data_axis]

    def poison(state):
        for t in leaves(state):
            t.reshape(-1).view(torch.uint8).fill_(0x5A)

    def same_bits(a, b):
        return torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))

    res = {}
    # -- the row-safe toy tree ------------------------------------------------
    etoy = state_from_numpy(inp["etoy"])
    esh = shardings_for(ctx, {k: P(*v) for k, v in inp["etoy_specs"].items()},
                        etoy)
    elocal = local_tree(etoy, esh)
    eps = ParityStore(elocal, ctx=ctx, row_safe=True, shardings=esh)
    eps.build(elocal)
    plan = eps.plan
    el = {"keys": list(plan.keys),
          "groups": {k: [list(g) for g in plan.groups[k]] for k in plan.keys},
          "offsets": {k: int(plan.offsets[k]) for k in plan.keys},
          "stream_len": int(plan.stream_len),
          "buffer_shape": [plan.n_rows, plan.row_words],
          "pflats": {}, "recon_ok": {}}
    for row in range(ctx.shape["data"]):
        if row_of(ctx) == row:
            continue
        dead = set(ctx.row_devices(row))
        pflat = plan.host_parity_flat(eps.parity, dead)
        el["pflats"][row] = pflat.numpy()
        ok = True
        for key, leaf in elocal.items():
            if key in plan.key_set:
                blocks = plan.host_surviving_blocks(key, leaf, dead)
                full, missing = plan.assemble_blocks(key, blocks)
                uniq, _ = plan.slices[key]
                for b in missing:
                    full[tuple(slice(a, e) for a, e in uniq[b])] = \
                        plan.host_reconstruct_block(key, b, pflat, blocks)
            else:
                full = _host_regather(leaf, dead, esh[key])
            ok = ok and same_bits(full, etoy[key])
        el["recon_ok"][row] = ok
    if row_of(ctx) != 2:
        dead2 = set(ctx.row_devices(2))
        uniq, dmap = plan.slices["wdup"]
        blocks = plan.host_surviving_blocks("wdup", elocal["wdup"], dead2)
        el["wdup"] = [len(uniq), len(dmap), sorted(blocks),
                      plan.assemble_blocks("wdup", blocks)[1]]
    legacy = ParityStore(elocal, ctx=ctx, shardings=esh)
    legacy.build(elocal)
    for name, fn in (
            ("legacy", lambda: legacy.plan.host_parity_flat(
                legacy.parity, set(ctx.row_devices(1)))),
            ("legacy_on_loss", lambda: ElasticManager(ctx).on_loss(
                step=0, dead_rows=(1,), state=elocal, raw_step=None,
                cfg=None, batch_fn=None, pstore=legacy, shardings=esh))):
        try:
            fn()
            el[name] = "no error"
        except RuntimeError as e:
            el[name] = str(e)
    res["elastic_toy"] = el

    # -- the chaos drill -------------------------------------------------------
    fcfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, fsdp=True))
    EB, ES, KILL, STEPS = 12, 16, 3, 7
    pipe = TokenPipeline(fcfg.model.vocab_size, ES, EB, seed=0)

    def bound(c):
        st, step, bfn, sh = bind_state(
            c, fcfg, state_from_numpy(inp["state"]),
            make_train_step(fcfg, global_batch=EB), pipe.batch_at)
        can = ChecksumCanary(st, n_slices=1, ctx=c)
        ps = ParityStore(st, ctx=c, row_safe=True, shardings=sh)
        ps.build(st)
        can.attach_parity(ps)
        return st, step, bfn, sh, can, ps

    dctx = make_context("4,2", torch.device("cpu"))
    st, step, bfn, sh, can, ps = bound(dctx)
    emgr = ElasticManager(dctx)
    rt = RecoveryRuntime(
        step_fn=step, batch_fn=bfn, iv_registry=promote(fcfg, EB),
        micro=MicroCheckpointer(interval=2, ctx=dctx, shardings=sh),
        parity=ps, shardings=sh, canary=can,
        elastic=emgr.hook(raw_step=step, cfg=fcfg, batch_fn=pipe.batch_at,
                          canary=can, pstore=ps, shardings=sh))
    dr = {"covers": len(ps.plan.keys), "losses": []}
    for s in range(KILL):
        ns, m = step(st, bfn(s))
        assert can.check_and_arm(s, st, ns) is None
        dr["losses"].append(float(m["loss"]))
        st = ns
    oracle = gather_tree(st, sh)
    if row_of(dctx) == 3:
        poison(st)
        dr["dead"] = True
    else:
        st, ev = rt.recover(st, FaultReport(KILL, "external",
                                            lost_rows=(3,)), KILL)
        resume = rt.pending_remesh
        dr["rung"], dr["attempted"] = ev.rung, list(ev.attempted)
        dr["event"] = {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in resume.event.to_dict().items()}
        dr["new_dp"] = resume.ctx.shape["data"]
        full = gather_tree(resume.state, resume.shardings)
        want = {leaf_key(p): t for p, t in flatten_with_path(oracle)}
        dr["same"] = all(same_bits(t, want[leaf_key(p)])
                         for p, t in flatten_with_path(full))
        if resume.ctx.shard_id == 0:
            dr["state"] = {leaf_key(p): t.numpy()
                           for p, t in flatten_with_path(full)}
        after = []
        for s in range(KILL, STEPS):
            if s == STEPS - 2:
                kd.STATS.reset()
            ns, m = resume.step(st, resume.bfn(s))
            assert resume.canary.check_and_arm(s, st, ns) is None
            after.append(float(m["loss"]))
            st = ns
        dr["stats"] = kd.STATS.snapshot()
        dr["after"] = after
        ob, ostep, obfn, _ = bind_state(
            resume.ctx, fcfg, oracle, make_train_step(fcfg, global_batch=EB),
            pipe.batch_at)
        clean = []
        for s in range(KILL, STEPS):
            ob, m = ostep(ob, obfn(s))
            clean.append(float(m["loss"]))
        dr["clean"] = clean
    res["drill"] = dr

    # -- two drills in one process ---------------------------------------------
    tctx = make_context("4,2", torch.device("cpu"))
    st, step, bfn, sh, can, ps = bound(tctx)
    ns, _ = step(st, bfn(0))
    assert can.check_and_arm(0, st, ns) is None
    tmgr = ElasticManager(tctx)
    two = {"events": [], "shapes": []}
    for at, rows in ((1, (3,)), (2, (2,))):
        if row_of(tmgr.ctx) in rows:
            poison(ns)
            two["dead_at"] = at
            break
        r = tmgr.on_loss(step=at, dead_rows=rows, state=ns, raw_step=step,
                         cfg=fcfg, batch_fn=pipe.batch_at, canary=can,
                         pstore=ps, shardings=sh)
        two["events"].append({k: (list(v) if isinstance(v, tuple) else v)
                              for k, v in r.event.to_dict().items()})
        two["shapes"].append(r.ctx.shape)
        ns2, m = r.step(r.state, r.bfn(at))
        assert r.canary.check_and_arm(at, r.state, ns2) is None
        ns, step, sh, can, ps = ns2, r.step, r.shardings, r.canary, r.pstore
    two["dead"], two["slice_ids"] = sorted(tmgr.dead), list(tmgr.slice_ids)
    res["two"] = two

    # -- the CLI drill ---------------------------------------------------------
    res["cli"] = train(cfg, steps=6, global_batch=8, seq_len=16,
                       canary_slices=1, mesh="4,2", parity=True,
                       elastic=True, kill_row_at=3, device="cpu",
                       verbose=False)
    return res


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.train.loop import make_train_state
    from repro_torch.launch.mesh import spawn

    tmp = tmp_path_factory.mktemp("mesh_oracle")
    from repro.models.registry import get_model as jmodel

    cfg = get_config("iterpro-100m").smoke()
    state = jax.tree_util.tree_map(
        np.asarray, make_train_state(cfg, jax.random.PRNGKey(0),
                                     global_batch=B))
    sparams = {}
    for arch in sorted({p["arch"] for p in SERVE.values()}):
        m = get_config(arch).smoke().model
        sparams[arch] = jax.tree_util.tree_map(
            np.asarray, jmodel(m).init(m, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.model.vocab_size, size=8).astype(np.int32)
               for _ in range(4)]
    import dataclasses
    fam_states, fam_params, fam_features = {}, {}, {}
    for arch, kw in FAMILIES.items():
        c = get_config(arch).smoke()
        c = dataclasses.replace(c, model=dataclasses.replace(c.model, **kw))
        fam_states[arch] = jax.tree_util.tree_map(
            np.asarray, make_train_state(c, jax.random.PRNGKey(0),
                                         global_batch=B))
        fam_params[arch] = jax.tree_util.tree_map(
            np.asarray, jmodel(c.model).init(c.model, jax.random.PRNGKey(0)))
        fam_features[arch] = [
            {"src_embeds": rng.standard_normal(
                (1, FAM_ENG["max_len"], c.model.frontend_dim)).astype(
                    np.float32)} if c.model.n_enc_layers else {}
            for _ in prompts]
    xc = get_config("xlstm-350m").smoke()
    xc = dataclasses.replace(xc, model=dataclasses.replace(
        xc.model, **X16["kw"]))
    x16 = dict(X16, params=jax.tree_util.tree_map(
        np.asarray, jmodel(xc.model).init(xc.model, jax.random.PRNGKey(0))),
        tokens=rng.integers(0, xc.model.vocab_size, size=(2, 8)).astype(
            np.int32),
        tok=rng.integers(0, xc.model.vocab_size, size=(2,)).astype(np.int32))
    inp = {"state": state, "toy": _toy(jax, jnp), "toy_specs": TOY_SPECS,
           "B": B, "S": S, "up": UP, "K": FUSED_K,
           "updates": _updates(state), "flags": UPDATE_FLAGS,
           "tri_flips": TRI_FLIPS, "etoy": _etoy(jax, jnp),
           "etoy_specs": ETOY_SPECS, "serve": SERVE, "sparams": sparams,
           "serve_prompts": prompts, "serve_gen": SERVE_GEN,
           "serve_keys": SERVE_KEYS, "fam": FAMILIES,
           "fam_states": fam_states, "fam_params": fam_params,
           "fam_features": fam_features, "fam_eng": FAM_ENG, "x16": x16,
           **_moe_prog(jax, jnp)}
    src = str(tmp / "input.pkl")
    with open(src, "wb") as f:
        pickle.dump(inp, f)
    out = str(tmp / "oracle")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    children = [subprocess.Popen([sys.executable, "-c", code, src, out],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for code in (CHILD, CHILD_FAM)]
    try:
        ranks = spawn(_port_ranks, (4, 2), (src,), device="cpu")[0]
        errs = [c.communicate(timeout=600)[1] for c in children]
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
    for c, err in zip(children, errs):
        assert c.returncode == 0, err[-3000:]
    with open(out + ".json") as f:
        ref = json.load(f)
    with open(out + "_fam.json") as f:
        ref["fam"] = json.load(f)
    with np.load(out + ".npz") as z:
        truth = {k: z[k] for k in z.files}
    with np.load(out + "_fused.npz") as z:
        ref["fused_state"] = {k: z[k] for k in z.files}
    ref["parity_rows"] = np.load(out + "_parity.npy")
    ref["pflats"] = np.load(out + "_pflats.npy")
    with np.load(out + "_drill.npz") as z:
        ref["drill_state"] = {k: z[k] for k in z.files}
    with np.load(out + "_ys.npz") as z:
        ref["ys"] = {k: z[k] for k in z.files}
    ref["pipe_truth"] = inp["pipe_truth"]
    for arch in FAMILIES:
        with np.load(out + "_fam_" + arch + ".npz") as z:
            ref["fam"][arch]["state"] = {k: z[k] for k in z.files}
    return ref, truth, ranks


def test_shard_boxes_bitwise(both):
    ref, _, ranks = both
    assert ranks[0]["boxes"].keys() == ref["boxes"].keys()
    for k, want in ref["boxes"].items():
        got = [[list(p) for p in box] for box in ranks[0]["boxes"][k]]
        assert got == want, k


def test_sharded_digest_table_bitwise(both):
    ref, _, ranks = both
    assert ranks[0]["keys"] == ref["keys"]
    assert np.array_equal(np.asarray(ranks[0]["table"], np.int32),
                          np.asarray(ref["table"], np.int32))
    # every rank gathered the same table
    assert all(r["table"] == ranks[0]["table"] for r in ranks)


def test_sharded_prog_outcome(both):
    ref, _, ranks = both
    assert ref["toy_leaves"] == ["b"]
    assert ref["toy_shards"] == {"b": [1, 3, 5, 7]}
    assert ref["toy_stats"] == [1, 1, 0]
    for r in ranks:
        assert r["toy_keys"] == ref["toy_keys"]
        assert r["toy_table"] == ref["toy_table"]
        assert r["toy_oracle"] and ref["toy_oracle"]
        assert r["toy_clean"] and ref["toy_clean"]
        assert r["toy_leaves"] == ref["toy_leaves"]
        assert r["toy_shards"] == ref["toy_shards"]
        assert tuple(r["toy_stats"]) == (1, 1)


def test_bound_steps_losses_and_state(both):
    ref, truth, ranks = both
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"],
                               atol=F32_TOL, rtol=F32_TOL)
    _close_to(ranks[0]["state"], truth)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_families_bound_steps_and_serving_match_reference(both, arch):
    """xLSTM, Zamba2, the enc-dec and the VLM on 4 x 2, the port
    tensor-parallel from the rank's blocks, the reference under GSPMD:
    two bound steps from the same state, the losses on every rank and the
    gathered state within the f32 tolerance; the mesh engines' clean
    token logs over the same params, bitwise."""
    ref, _, ranks = both
    want = ref["fam"][arch]
    assert want["same_params"], arch
    for r in ranks:
        got = r["fam"][arch]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   atol=F32_TOL, rtol=F32_TOL)
        assert got["logs"] == want["logs"], (arch, r["shard_id"])
    _close_to(ranks[0]["fam"][arch]["state"], want["state"])


def test_xlstm_bf16_mesh_drift_within_reference(both):
    """The reference's bf16 xlstm drifts on a mesh as the port's does: a
    1 x 2 mesh's decode logits against one device's, each package against
    itself.  The port's distance is held at or under the reference's, or
    within the reference's bf16 tolerance."""
    ref, _, ranks = both
    want = ref["fam"]["x16"]
    print(f"[x16] mesh vs one device, bf16: reference {want}, port "
          f"{ranks[0]['x16']}")
    assert 0 < want["decode"] < BF16_TOL, want
    for r in ranks:
        got = r["x16"]
        assert got == ranks[0]["x16"]
        assert got["decode"] <= want["decode"] or \
            got["decode"] <= BF16_TOL, (got, want)


@pytest.mark.parametrize("size", MOE_SIZES)
@pytest.mark.parametrize("cf", MOE_CFS)
@pytest.mark.parametrize("impl", MOE_IMPLS)
def test_moe_mesh_schedules_match_reference(both, impl, cf, size):
    """``tests/test_moe.py``'s EP_PROG on a 2 x 4 mesh (fsdp) for every
    ``moe_impl``: each rank's rows of the port's mesh output within 2e-5
    of the reference's mesh output, its ``lb_loss`` (averaged over every
    axis) too, the same schedule (``use_ep``); at capacity 1.25 the same
    rows dropped (the rows whose output differs from capacity 8.0's),
    some of them at 512 tokens."""
    ref, _, ranks = both
    key = f"{impl}/{cf}/{size}"
    n = 2 * size                    # tokens a data row
    want = ref["ys"][key]
    assert ref["moe"][key]["ep"] == (impl != "tp_ragged")
    for r in ranks:
        got = r["moe_pipe"][key]
        row = r["moe_pipe"]["row"]
        rows = slice(n * row, n * row + n)
        assert got["ep"] == ref["moe"][key]["ep"], key
        np.testing.assert_allclose(got["y"], want[rows], atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=key)
        assert abs(got["lb"] - ref["moe"][key]["lb"]) <= F32_TOL, key
        if cf != 8.0:
            full = r["moe_pipe"][f"{impl}/8.0/{size}"]["y"]
            wfull = ref["ys"][f"{impl}/8.0/{size}"][rows]
            dropped = np.abs(got["y"] - full).max(axis=1) > 1e-5
            wdropped = np.abs(want[rows] - wfull).max(axis=1) > 1e-5
            assert np.array_equal(dropped, wdropped), key
    if cf != 8.0 and size == MOE_SIZES[-1]:
        assert (np.abs(want - ref["ys"][f"{impl}/8.0/{size}"]).max(axis=1)
                > 1e-5).any(), "capacity 1.25 drops nothing"


def test_pipeline_matches_reference_and_sequential_truth(both):
    """``tests/test_pipeline.py``'s PIPE_PROG (S 4, M 6, B 2, d 8): the
    port's ``pipeline_apply`` on every rank within 1e-5 of the
    sequential truth and of the reference's output."""
    ref, _, ranks = both
    truth = ref["pipe_truth"]
    assert np.abs(ref["ys"]["pipe"] - truth).max() < 1e-5
    for r in ranks:
        got = r["moe_pipe"]["pipe"]
        assert np.abs(got - truth).max() < 1e-5
        assert np.abs(got - ref["ys"]["pipe"]).max() < 1e-5


def test_shard_patch_matches_reference(both):
    ref, _, ranks = both
    assert ref["rung"] == "shard_patch" and ref["healed_exact"]
    for r in ranks:
        assert r["injured"] == ref["injured"]
        assert r["rung"] == ref["rung"]
        assert r["bytes_moved"] == ref["bytes_moved"]
        assert r["bytes_moved"] == r["block_bytes"] * len(r["injured"])
        # the healed state is its own pre-injection truth, bit for bit
        assert r["healed_exact"]
        # only an injured rank's block of the injured leaf was replaced
        want = ["params/" + UP] if r["shard_id"] in r["injured"] else []
        assert r["moved_leaves"] == want, r["shard_id"]


def test_version_mismatch_escalates_to_replay(both):
    ref, _, ranks = both
    assert ref["rung2"] == "replay" and "shard_patch" in ref["attempted2"]
    for r in ranks:
        assert r["rung2"] == ref["rung2"]
        assert "shard_patch" in r["attempted2"]


def _close_to(got, want):
    """Two states within the f32 tolerance (counters exact, the bias
    corrections within 1 ulp)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k.startswith("iv/") or k == "opt/t":
            assert int(got[k]) == int(w), k
        elif k in ("opt/bc1", "opt/bc2"):
            assert abs(int(got[k].view(np.int32))
                       - int(w.view(np.int32))) <= 1, k
        else:
            np.testing.assert_allclose(got[k], w, atol=F32_TOL,
                                       rtol=F32_TOL, err_msg=k)


def test_donation_and_fused_detect_compose_on_mesh(both):
    """The reference's program: the donated fused step at K=2 on the 4 x 2
    mesh is bitwise its plain sharded trajectory, with ``(K, K, 0)`` over
    K steady steps; the port's is bitwise its own functional mesh step on
    every rank, ``(K, K)``, and within the f32 tolerance of the
    reference's state."""
    ref, _, ranks = both
    assert ref["fused_stats"] == [FUSED_K, FUSED_K, 0] and ref["fused_exact"]
    for r in ranks:
        assert tuple(r["fused_stats"]) == (FUSED_K, FUSED_K), r["fused_stats"]
        assert r["fused_exact"], r["shard_id"]
    _close_to(ranks[0]["fused_state"], ref["fused_state"])


def test_partial_refresh_patches_without_generation_bump(both):
    """``refresh(keys=...)`` on a sharded canary patches each rank's rows
    in both generations with no bump; the donated pair keeps passing, and
    the tables are the reference's, bitwise."""
    ref, _, ranks = both
    assert ref["partial_gen_kept"] and ref["partial_ok"]
    for r in ranks:
        assert r["partial_gen_kept"] and r["partial_ok"], r["shard_id"]
        assert np.array_equal(np.asarray(r["partial_table"], np.int32),
                              np.asarray(ref["partial_table"], np.int32))


def test_tp_sharded_slice_map_regression(both):
    """A TP-sharded, DP-replicated leaf has 2 unique blocks, its replicas
    map onto them, a wiped block is rebuilt bitwise on every replica; a
    replicated leaf is one block, rebuilt from the parity alone; each
    rank's parity row is the reference's row of its device."""
    ref, _, ranks = both
    want = ref["tp"]
    assert want["n_blocks"] == 2 and set(want["device_block"]) == {0, 1}
    assert len(want["holders"]) == 4 and want["rec_exact"]
    assert want["r_n_blocks"] == 1 and want["r_rec_exact"]
    for r in ranks:
        got = r["tp"]
        for k in ("n_blocks", "device_block", "holders", "r_n_blocks"):
            assert got[k] == want[k], (k, r["shard_id"])
        assert got["rec_exact"] and got["r_rec_exact"], r["shard_id"]
        assert got["parity"] == want["parity"][r["shard_id"]], r["shard_id"]


def test_sharded_parity_rows_bitwise_after_build_and_gated_updates(both):
    """The mesh parity of the smoke state, built, then updated three times
    (the second's fault flag set: that delta is zeroed): every rank's row
    is bitwise the reference's addressable row on the same device after
    each."""
    ref, _, ranks = both
    rows = ref["parity_rows"]
    assert rows.shape[:2] == (1 + len(UPDATE_FLAGS), 8)
    assert rows.shape[2] == ref["parity_crow"]
    assert np.array_equal(rows[2], rows[1])        # the gated update
    assert not np.array_equal(rows[1], rows[0])
    for r in ranks:
        assert np.array_equal(r["parity_rows"], rows[:, r["shard_id"]]), \
            r["shard_id"]


def test_triage_on_sharded_canary_matches_reference(both):
    """Rung 0 on the mesh: a bit-2 ``opt/v`` flip is tolerated and a bit-30
    one escalates (to the version-matched shard_patch), as in the
    reference; the ranks holding the injured block solve the same bit and
    the same leaf-flat candidate words."""
    ref, _, ranks = both
    want = ref["triage"]
    assert want["b2"]["rung"] == "triage" and want["b2"]["bytes"] == 0
    assert want["b30"]["attempted"][0] == "triage"
    assert want["b30"]["rung"] == "shard_patch"
    for name, w in want.items():
        holders = w["shards"]["opt/v/" + UP]
        for r in ranks:
            got = r["triage"][name]
            for k in ("leaves", "shards", "rung", "attempted", "bytes"):
                assert got[k] == w[k], (name, k, r["shard_id"])
            if r["shard_id"] in holders:
                assert got["loc"] == (w["bit"], w["cands"]), (name, r)
            else:
                assert got["loc"] is None



# -- elastic hard loss (tests/test_elastic.py's programs) ------------------------

#: the event's counts, which the port must equal exactly
EVENT_COUNTS = ("lost_rows", "lost_slices", "old_dp", "new_dp",
                "bytes_reconstructed", "bytes_regathered",
                "blocks_reconstructed", "leaves_regathered",
                "certified_blocks", "uncertified_blocks", "disk_restores")


def _counts(ev):
    return {k: list(ev[k]) if isinstance(ev[k], (list, tuple)) else ev[k]
            for k in EVENT_COUNTS}


@pytest.mark.parametrize("name", sorted(SERVE))
def test_mesh_serving_matches_reference(both, name):
    """The reference's mesh engine (params sharded by its
    ``param_shardings``, the covered state replicated, the shard-local
    canary) and the port's 8 ranks over the same params: every request's
    tokens, the summary's counters, the first report's leaves and shard
    ids, bitwise; every device's canary read table: the same plan keys,
    every device's rows equal (replicas), paged, the ``pos`` rows bitwise
    the reference's — the K/V rows digest floats the port's decode
    computes within 2e-5 of the reference's, not bit for bit (its tokens
    are equal), and the reference's dense step advances a free lane's
    ``pos`` too (its vmapped decode runs every lane; the port's, and both
    paged steps, only the active lanes'); with parity the per-shard param refs, every device's parity
    row, ``memory_bytes`` and the scrub's stats after the same
    ``corrupt_param`` draw, bitwise."""
    ref, _, ranks = both
    want = ref["serve"][name]
    assert want["same_params"], name
    assert want["summary"]["faults"]["injected"] > 0, want["summary"]
    assert want["first"]["leaves"] and want["first"]["shards"], want
    wtab = np.asarray(want["table"])
    pos = [i for i, k in enumerate(want["keys"]) if k.endswith("/pos")
           and SERVE[name]["eng"].get("paged", True)]
    assert wtab.shape[0] == 8
    assert all(np.array_equal(wtab[d], wtab[0]) for d in range(8))
    for r in ranks:
        got = r["serve"][name]
        for k in ("logs", "summary", "first", "keys"):
            assert got[k] == want[k], (name, k, r["shard_id"])
        gtab = np.asarray(got["table"])
        assert gtab.shape == wtab.shape, name
        assert all(np.array_equal(gtab[d], gtab[0]) for d in range(8))
        assert np.array_equal(gtab[:, pos], wtab[:, pos]), name
        if SERVE[name]["eng"].get("parity"):
            assert got["refs"] == want["refs"], name
            assert got["parity"] == want["parity"][r["shard_id"]], \
                (name, r["shard_id"])
            assert got["memory_bytes"] == want["memory_bytes"], name
            assert got["flip"] == want["flip"], name
            assert got["scrub"] == want["scrub"], (name, got["scrub"],
                                                   want["scrub"])
    if name == "paged+parity":
        assert want["memory_bytes"] == 200_704
        assert want["scrub"]["checked"] == 11
        assert want["scrub"]["repaired"] == 1


def test_row_safe_plan_and_survivor_parity_bitwise(both):
    """``TestRowSafeReconstruction``: the row-safe plan's keys, fold
    groups and offsets, and for every lost row the parity stream the
    survivors assemble (``host_parity_flat``) bitwise the reference's;
    every leaf reconstructed bitwise; the dedup edge; the legacy
    placement refused with the reference's messages."""
    ref, _, ranks = both
    el = ref["elastic_toy"]
    assert el["keys"] == ["w0", "w3d", "wbf", "wdup"]
    assert el["recon_ok"] == [True] * 4
    for rank, r in enumerate(ranks):
        e = r["elastic_toy"]
        for k in ("keys", "groups", "offsets", "stream_len",
                  "buffer_shape", "legacy", "legacy_on_loss"):
            assert e[k] == el[k], (rank, k, e[k], el[k])
        assert sorted(e["pflats"]) == [w for w in range(4) if w != rank // 2]
        for row, flat in e["pflats"].items():
            assert np.array_equal(flat, ref["pflats"][row]), (rank, row)
        assert all(e["recon_ok"].values()), (rank, e["recon_ok"])
        if rank // 2 != 2:
            assert e["wdup"] == el["wdup"] == [4, 8, [0, 1, 3], [2]]


def test_chaos_drill_matches_reference(both):
    """``_DRILL`` (fsdp, row 3 lost before step 3): the rung, the event's
    counts and the new width exactly the reference's; the losses before
    and after within the f32 tolerance, the resumed state too; on the
    port the resumed state is bitwise its own oracle, the losses after
    the loss bitwise a clean 3 x 2 run's, STATS (2, 2) over two steps."""
    ref, _, ranks = both
    dr = ref["drill"]
    assert dr["rung"] == "remesh" and dr["attempted"] == ["remesh"]
    assert dr["same"] and dr["new_dp"] == 3 and dr["covers"] > 0
    for rank, r in enumerate(ranks):
        d = r["drill"]
        assert d["covers"] == dr["covers"]
        np.testing.assert_allclose(d["losses"], dr["losses"], atol=F32_TOL,
                                   rtol=F32_TOL)
        if rank // 2 == 3:
            assert d.get("dead"), rank
            continue
        assert (d["rung"], d["attempted"]) == (dr["rung"], dr["attempted"])
        assert _counts(d["event"]) == _counts(dr["event"]), rank
        assert d["new_dp"] == dr["new_dp"] and d["same"], rank
        np.testing.assert_allclose(d["after"], dr["after"], atol=F32_TOL,
                                   rtol=F32_TOL)
        assert d["after"] == d["clean"], rank
        assert tuple(d["stats"]) == (2, 2), d["stats"]
    _close_to(ranks[0]["drill"]["state"], ref["drill_state"])


def test_two_drills_match_reference(both):
    """4 x 2 -> 3 x 2 -> 2 x 2: each loss's counts and shape the
    reference's, the slice bookkeeping its original ids."""
    ref, _, ranks = both
    two = ref["two"]
    assert two["dead"] == [2, 3] and two["slice_ids"] == [0, 1]
    for rank, r in enumerate(ranks):
        t = r["two"]
        n = {3: 0, 2: 1}.get(rank // 2, 2)
        assert len(t["events"]) == n, (rank, t)
        assert t.get("dead_at") == (None if n == 2 else n + 1), rank
        for got, want in zip(t["events"], two["events"]):
            assert _counts(got) == _counts(want), rank
        assert t["shapes"] == two["shapes"][:n], rank
        if n == 2:
            assert (t["dead"], t["slice_ids"]) == (two["dead"],
                                                   two["slice_ids"])


def test_train_cli_drill_matches_reference(both):
    """``train(mesh="4,2", parity=True, elastic=True, kill_row_at=3)``
    (``test_train_cli_elastic_kill_row_smoke``): 6 steps, one remesh, the
    event's counts and the new shape the reference's."""
    ref, _, ranks = both
    want = ref["cli"]
    assert want["recovery"]["by_rung"] == {"remesh": 1}
    for rank, r in enumerate(ranks):
        got = r["cli"]
        if rank // 2 == 3:
            assert got["dead"], rank
            continue
        for k in ("steps", "faults_detected", "faults_recovered", "mesh"):
            assert got[k] == want[k], (rank, k)
        assert got["recovery"]["by_rung"] == want["recovery"]["by_rung"]
        [ev], [wev] = got["elastic_events"], want["elastic_events"]
        assert _counts(ev) == _counts(wev), rank
