"""The port's training slice against the JAX package: data pipeline,
schedule, loss, the functional train step, disk checkpoints and the
resilient training loop (smoke config, B=2, S=32, on the CPU).

Tolerance for floating-point state: 2e-5, the reference's f32 tolerance
(tests/test_kernels.py:116).  Both sides compute in f32 on the CPU and
differ only in reduction order; after 5 AdamW steps the worst measured
difference is ~3e-8.  Integer state (the ``iv`` block, ``opt/t``) is
exact.  ``opt/bc1``/``opt/bc2`` are the f32 ``1 - beta**t``: XLA's and
torch's ``pow`` differ in the last place at a few ``t`` (b=0.95 at t=6,
b=0.9 at t=31 below 5000), so they are held to the reference within one
ulp and to the port's own ``derived_ivs`` recomputation bit for bit.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.data import pipeline as jpipe
from repro.kernels.ops import leaf_key as jleaf_key
from repro.models import layers as JL
from repro.optim import schedules as jsched
from repro_torch.bridge import state_from_numpy
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config
from repro_torch.core.icp import promote
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.optim import make_optimizer, schedules as tsched
from repro_torch.train.loop import make_train_state, make_train_step
from repro_torch.tree import flatten_with_path, leaf_key

F32_TOL = 2e-5
STEPS = 5


@pytest.fixture(scope="module")
def tcfg():
    return get_config("iterpro-100m").smoke()


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_np(tree):
    return {jleaf_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _tbatch(jbatch):
    return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


def _bitwise_equal(a, b):
    fa, fb = _flat_t(a), _flat_t(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (256, 32, 2, 0), (256, 32, 4, 3), (32000, 128, 8, 0), (1000, 17, 3, 7)])
def test_batch_at_is_bit_identical_to_reference(vocab, seq, batch, seed):
    j = jpipe.TokenPipeline(vocab, seq, batch, seed=seed)
    t = tpipe.TokenPipeline(vocab, seq, batch, seed=seed)
    for step in (0, 1, 9, 1234):
        jb, tb = j.batch_at(step), t.batch_at(step)
        for k in ("tokens", "targets"):
            assert tb[k].dtype == torch.int32
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), (step, k)


def test_shard_at_and_assignment_match_reference():
    j = jpipe.TokenPipeline(256, 32, 4, seed=5)
    t = tpipe.TokenPipeline(256, 32, 4, seed=5)
    for shard in range(4):
        assert np.array_equal(t.shard_at(3, shard, 4)["tokens"].numpy(),
                              np.asarray(j.shard_at(3, shard, 4)["tokens"]))
    for step in range(5):
        for dead in ((), (1,), (0, 2)):
            assert tpipe.shard_assignment(step, 4, dead) == \
                jpipe.shard_assignment(step, 4, dead)


def test_threefry_primitives_match_jax():
    key = jax.random.PRNGKey(11)
    ours = tpipe.prng_key(11)
    assert np.array_equal(ours, np.asarray(key))
    k = jax.random.fold_in(key, 42)
    tk = tpipe.fold_in(ours, np.uint32(42))
    assert np.array_equal(tk, np.asarray(k))
    assert np.array_equal(tpipe.split(tk, 3), np.asarray(jax.random.split(k, 3)))
    assert np.array_equal(tpipe.randint(tk, (50,), 5, 30000),
                          np.asarray(jax.random.randint(k, (50,), 5, 30000)))
    assert np.array_equal(tpipe.uniform(tk, (33,)),
                          np.asarray(jax.random.uniform(k, (33,))))


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def test_warmup_cosine_matches_reference():
    j = jsched.warmup_cosine(6e-4, 100, 1000)
    t = tsched.warmup_cosine(6e-4, 100, 1000)
    for s in (0, 1, 50, 99, 100, 101, 555, 999, 1000, 5000):
        ours = float(t(torch.tensor(s, dtype=torch.int32)))
        assert abs(ours - float(j(s))) <= 1e-12 + 1e-6 * abs(float(j(s))), s


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = float(JL.cross_entropy(logits, labels, m))
        got = float(TL.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     None if m is None
                                     else torch.from_numpy(m)))
        assert abs(got - want) <= F32_TOL


@pytest.fixture(scope="module")
def five_steps(tiny_setup, tcfg):
    """(reference states + metrics, port states + metrics) over 5 steps
    from the same bridged initial state on the reference's batches."""
    _, jstate0, jstep, jbfn = tiny_setup
    tstate = state_from_numpy(_host(jstate0))
    tstep = make_train_step(tcfg, global_batch=2)
    js, jm_all, tm_all = jstate0, [], []
    tinit = tstate
    for s in range(STEPS):
        b = jbfn(s)
        js, jm = jstep(js, b)
        tstate, tm = tstep(tstate, _tbatch(b))
        jm_all.append(jm)
        tm_all.append(tm)
    return jstate0, tinit, js, jm_all, tstate, tm_all


def test_train_state_tree_matches_reference(tiny_setup, tcfg):
    _, jstate0, _, _ = tiny_setup
    ours = make_train_state(tcfg, 0, global_batch=2)
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat_np(jstate0).items()}
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in _flat_t(ours).items()}
    assert got == want
    assert list(got) == list(want)          # same flatten order


def test_five_steps_match_reference(five_steps):
    _, _, js, jm_all, ts, tm_all = five_steps
    for jm, tm in zip(jm_all, tm_all):
        for name in ("loss", "grad_norm"):
            assert abs(float(tm[name]) - float(jm[name])) <= F32_TOL, name
        assert float(tm["lr"]) == float(jm["lr"])
    want, got = _flat_np(js), _flat_t(ts)
    assert want.keys() == got.keys()
    for k, a in want.items():
        b = got[k].numpy()
        if k.startswith(("params/", "opt/m/", "opt/v/")):
            np.testing.assert_allclose(b, a, atol=F32_TOL, rtol=F32_TOL,
                                       err_msg=k)
        elif k.startswith("iv/") or k == "opt/t":
            assert b.dtype == np.int32 and int(b) == int(a), k


def test_bias_corrections_within_one_ulp_and_exact_to_derived(five_steps,
                                                               tcfg):
    _, _, js, _, ts, _ = five_steps
    derived = make_optimizer(tcfg.train).derived_ivs
    n = int(ts["opt"]["t"])
    assert n == STEPS
    for name in ("bc1", "bc2"):
        ours = ts["opt"][name]
        ref = np.asarray(js["opt"][name])
        assert abs(int(ours.view(torch.int32)) -
                   int(ref.view(np.int32))) <= 1, name
        again = derived[name](n, ours.device)
        assert int(again.view(torch.int32)) == int(ours.view(torch.int32))


def test_step_is_functional(five_steps, tcfg):
    jstate0, tinit, *_ = five_steps
    snap = state_from_numpy(_host(jstate0))
    assert _bitwise_equal(tinit, snap)      # five steps wrote no input leaf


def test_remat_changes_nothing(tiny_setup, tcfg):
    import dataclasses
    _, jstate0, _, jbfn = tiny_setup
    state = state_from_numpy(_host(jstate0))
    remat_cfg = dataclasses.replace(
        tcfg, train=dataclasses.replace(tcfg.train, remat="layer"))
    a, ma = make_train_step(tcfg, global_batch=2)(state, _tbatch(jbfn(0)))
    b, mb = make_train_step(remat_cfg, global_batch=2)(state,
                                                       _tbatch(jbfn(0)))
    assert float(ma["loss"]) == float(mb["loss"])
    for k, t in _flat_t(a).items():
        torch.testing.assert_close(t, _flat_t(b)[k], atol=1e-7, rtol=1e-6)


def test_derived_ivs_are_registered(tcfg):
    reg = promote(tcfg, 2)
    assert set(reg.specs) == {"iv/step", "iv/data_offset", "iv/rng_counter",
                              "iv/sched_pos", "iv/micro_count", "opt/t"}
    assert set(reg.derived) == {"opt/bc1", "opt/bc2"}
    assert reg.specs["iv/data_offset"].step == 2


# ---------------------------------------------------------------------------
# disk checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_reference_format(tmp_path, tcfg,
                                                    tiny_setup):
    state = make_train_state(tcfg, 3, global_batch=2)
    tstore.save_checkpoint(str(tmp_path), state, 7, slot=1)
    like = make_train_state(tcfg, 4, global_batch=2)
    back, step = tstore.load_checkpoint(str(tmp_path), like)
    assert step == 7 and _bitwise_equal(back, state)
    # the reference reads the port's checkpoint and accepts its digests
    _, jstate0, _, _ = tiny_setup
    jback, jstep = jstore.load_checkpoint(str(tmp_path), jstate0)
    assert jstep == 7
    for k, a in _flat_np(jback).items():
        assert np.array_equal(a, _flat_t(state)[k].numpy()), k


def test_checkpoint_digest_mismatch_raises(tmp_path, tcfg):
    state = make_train_state(tcfg, 3, global_batch=2)
    tstore.save_checkpoint(str(tmp_path), state, 2)
    payload = tmp_path / "slot0.npz"
    with np.load(payload) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["params/embed/table"].reshape(-1)[5] += 1.0   # a valid zip,
    with open(payload, "wb") as f:                       # wrong bytes
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="digest mismatch"):
        tstore.load_checkpoint(str(tmp_path), state)


def test_checkpoint_manager_alternates_slots(tmp_path, tcfg):
    state = make_train_state(tcfg, 0, global_batch=2)
    mgr = tstore.CheckpointManager(str(tmp_path), interval=2)
    for s in range(5):
        mgr.maybe_save(s, state)
    mgr.wait()
    assert mgr.saves == 3
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "slot0.npz",
                                            "slot1.npz"]
    back, step = mgr.restore(state)
    assert step == 4 and _bitwise_equal(back, state)


# ---------------------------------------------------------------------------
# the resilient loop (torch twins of tests/test_system.py)
# ---------------------------------------------------------------------------

def _run(tcfg, tmp_path=None, **kw):
    args = dict(steps=20, global_batch=2, seq_len=32, seed=0,
                snapshot_interval=4, canary_slices=1, verbose=False,
                device="cpu", return_state=True)
    if tmp_path is not None:
        args.update(checkpoint_dir=str(tmp_path), checkpoint_interval=10)
    args.update(kw)
    return tlaunch.train(tcfg, **args)


@pytest.fixture(scope="module")
def clean_run(tcfg, tmp_path_factory):
    return _run(tcfg, tmp_path_factory.mktemp("clean"))


def test_training_with_faults_recovers_and_learns(tcfg, tmp_path, clean_run):
    out, state = _run(tcfg, tmp_path, inject_every=6)
    assert out["steps"] == 20
    assert out["faults_injected"] >= 2
    assert out["faults_detected"] == out["faults_injected"]
    assert out["faults_recovered"] == out["faults_detected"]
    assert out["recovery"]["recovery_rate"] == 1.0
    assert out["recovery"]["by_rung"] == {"replay": out["faults_detected"]}
    # exact-or-abort end to end: the storm ends where the clean run ends
    assert _bitwise_equal(state, clean_run[1])
    assert out["final_loss"] == clean_run[0]["final_loss"]


def test_training_iv_storm_recovers_through_eq1(tcfg, clean_run):
    out, state = _run(tcfg, inject_every=6, inject_target="iv")
    assert out["faults_detected"] == out["faults_injected"] >= 2
    assert out["recovery"]["by_rung"] == {"eq1": out["faults_detected"]}
    assert _bitwise_equal(state, clean_run[1])


def test_training_no_fault_no_recovery_activity(tcfg):
    out = tlaunch.train(tcfg, steps=8, global_batch=2, seq_len=32, seed=1,
                        snapshot_interval=4, inject_every=0, verbose=False,
                        device="cpu")
    assert out["faults_detected"] == 0
    assert out["recovery"]["events"] == 0
    assert out["steps"] == 8


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_train_cli_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--smoke", "--steps", "1", "--batch", "2", "--seq",
                      "8"])


# ``--mesh``, its modes and ``--elastic`` are ported
# (tests/test_torch_mesh.py): the elastic flags without what they need
# raise the reference's ValueErrors, before any rank is spawned
@pytest.mark.parametrize("flag", [["--elastic"],
                                  ["--mesh", "4,2", "--elastic"],
                                  ["--kill-row-at", "3"]])
def test_train_cli_unported_flags_raise(flag):
    want = {"--kill-row-at": "kill_row_at requires elastic=True",
            "--mesh": "elastic requires parity=True",
            "--elastic": "elastic requires mesh='dp,tp'"}[flag[0]]
    with pytest.raises(ValueError, match=re.escape(want)):
        tlaunch.main(["--smoke", "--device", "cpu", "--steps", "1"] + flag)


@pytest.mark.parametrize("flags", [["--donate", "--fused-detect", "--parity"],
                                   ["--fused-detect", "--fused-warm", "lazy",
                                    "--triage"],
                                   ["--donate", "--triage", "--parity"]],
                         ids=lambda f: " ".join(f))
def test_train_cli_mode_combinations_at_default_slices(flags):
    """The ported modes combined, at the default K=4 rotation: the final
    loss is the plain loop's, bit for bit, and the fused step builds K
    rotations."""
    base = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "16"]
    plain = tlaunch.main(base)
    out = tlaunch.main(base + flags)
    assert out["steps"] == 4 and out["faults_detected"] == 0
    assert out["final_loss"] == plain["final_loss"]
    if "--fused-detect" in flags:
        assert out["fused"]["builds"] == 4


def test_train_cli_runs_on_cpu_when_asked(capsys):
    out = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--json"])
    assert out["steps"] == 3 and out["faults_detected"] == 0
    assert '"steps": 3' in capsys.readouterr().out
