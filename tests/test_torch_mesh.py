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
* **Refusals**: the mesh modes of later slices raise naming their ROADMAP
  item.
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
    for flag in ("donate", "fused_detect", "triage", "parity"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            train(cfg, steps=1, global_batch=8, seq_len=32, mesh="4,2",
                  device="cpu", **{flag: True})
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
            "same": same, "summaries": summaries, "others": others}


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
