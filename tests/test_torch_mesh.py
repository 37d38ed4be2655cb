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
* **1 x 2** (data width 1): the mesh trajectory equals the single-device
  trajectory bitwise.
* **The CLI**: ``train --mesh 4,2 --device cpu --smoke``.
* **The modes** (in the same spawn): the donated mesh step bitwise the
  functional one with every ``data_ptr`` kept (AdamW f32; Adafactor on
  kimi-k2-1t-a32b), the fused mesh step's ``(K, K)`` over K steady steps,
  storms == clean under ``--donate`` and ``--donate --fused-detect``,
  each with and without ``--parity``, a flip in one replica of a block
  escalating past triage, the CLI with every combination of the four
  mode flags.
* **Refusals**: the elastic modes raise naming their ROADMAP item.
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


def test_mesh_modes_of_later_slices_raise():
    from repro_torch.configs import get_config
    from repro_torch.core.recover import RecoveryRuntime
    from repro_torch.distributed.context import DistContext
    from repro_torch.launch.train import train

    cfg = get_config("iterpro-100m").smoke()
    for kw in ({"elastic": True}, {"kill_row_at": 2}):
        with pytest.raises(NotImplementedError, match="elastic"):
            train(cfg, steps=1, global_batch=8, seq_len=32, mesh="4,2",
                  device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="elastic"):
        RecoveryRuntime(step_fn=None, batch_fn=None, iv_registry=None,
                        micro=None, elastic=object())
    with pytest.raises(NotImplementedError, match="elastic"):
        DistContext.for_shape((4, 2), ("data", "model")).degrade([1])


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
    ns, _ = step(state, bfn(0))
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

    ckpt = CheckpointManager(ckpt_dir, interval=1, ctx=ctx, shardings=sh)
    ckpt.save(3, ns)
    back, at = ckpt.restore(ns)
    round_trip = at == 3 and _bitwise(back, ns)
    full = gather_tree(ns, sh)
    on_disk = load_checkpoint(ckpt_dir, full)[0]
    return {"steady": steady, "stats": stats, "partial": partial,
            "round_trip": round_trip, "on_disk": _bitwise(on_disk, full),
            "same": same, "summaries": summaries, "others": others,
            "modes": _mode_ranks(ctx, cfg, runs["clean"][1])}


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
    from repro_torch.launch.train import train
    out = {}
    for opt in sorted(OPTS):
        cfg = _with_opt(get_config("iterpro-100m").smoke(), opt)
        kw = dict(SMOKE, steps=2)
        mesh, local = train(cfg, mesh="1,2", **kw)
        out[opt] = (mesh, _full(cfg, "1,2", local)), train(cfg, **kw)
    return out


def test_data_width_one_equals_single_device_bitwise():
    """AdamW's elementwise update of the rank's blocks, and the whole-tree
    update of int8 moments and Adafactor, each bitwise one device's."""
    from repro_torch.launch.mesh import spawn
    runs = spawn(_one_by_two, (1, 2), device="cpu")[0]
    assert sorted(runs) == sorted(OPTS)
    for opt, ((mesh, ms), (single, ss)) in runs.items():
        assert mesh["mesh"]["devices"] == 2, opt
        assert mesh["final_loss"] == single["final_loss"], opt
        assert _bitwise(ms, ss), opt


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
