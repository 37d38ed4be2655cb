"""The donated (in-place) training step of the port, the donated canary
pair and the donated recovery ladder (smoke config, B=2, S=32, on the
CPU).

The in-place step must be bit-identical to the functional step with every
``data_ptr`` kept; the pair's digests are held against the JAX package's
per-leaf oracle; storms under every combination of ``--donate``,
``--fused-detect`` and ``--parity`` end bitwise equal to the clean run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary
from repro_torch.core.faults import InjectionPlan, flip_bit, inject
from repro_torch.core.icp import promote
from repro_torch.core.microcheckpoint import MicroCheckpointer
from repro_torch.core.parity import ParityStore
from repro_torch.core.recover import RecoveryRuntime
from repro_torch.core.recovery_table import RUNG_PARITY, RUNG_REPLAY
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as tdg
from repro_torch.launch import train as tlaunch
from repro_torch.train.loop import make_train_state, make_train_step
from repro_torch.tree import flatten_with_path, leaf_key, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs
    its files in parallel processes, where a pool of threads per process
    spends its time waiting on the others' cores (small ops ran ~4x
    slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _bitwise_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


def _ptrs(tree):
    return {k: t.data_ptr() for k, t in _flat(tree).items()}


def _tree(seed=7):
    """Mixed dtypes and shapes (multi-tile, sub-tile, 16-bit, int,
    scalar), as the reference's digest tests use."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": torch.from_numpy(rng.standard_normal((257, 129),
                                                      np.float32)),
            "b": torch.from_numpy(rng.standard_normal(33, np.float32))
            .to(torch.bfloat16),
        },
        "opt": {"m": torch.from_numpy(rng.standard_normal(40000,
                                                          np.float32))},
        "iv": {"step": torch.tensor(12, dtype=torch.int32),
               "pos": torch.tensor(7, dtype=torch.int32)},
        "tok": torch.from_numpy(rng.integers(-5, 5, (17, 3),
                                             dtype=np.int32)),
    }


def _toy_step_(tree):
    """In-place, structure- and dtype-preserving toy step."""
    for _, x in flatten_with_path(tree):
        if x.is_floating_point():
            x.mul_(torch.tensor(1.01, dtype=x.dtype))
        else:
            x.add_(1)
    return tree


def _oracle(x: torch.Tensor) -> np.ndarray:
    """The JAX package's per-leaf digest of ``x``'s bytes."""
    if x.dtype == torch.bfloat16:
        a = jnp.asarray(x.view(torch.uint16).numpy()).view(jnp.bfloat16)
    else:
        a = jnp.asarray(x.numpy())
    return np.asarray(jref.checksum_ref(a))


# ---------------------------------------------------------------------------
# the in-place step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tcfg():
    return get_config("iterpro-100m").smoke()


def test_inplace_step_is_bitwise_the_functional_step(tcfg):
    """5 donated steps equal 5 functional steps bit for bit (params,
    moments, t, bc1, bc2 and iv), the metrics are equal, the step returns
    its input tree and every leaf keeps its ``data_ptr``."""
    pipe = TokenPipeline(tcfg.model.vocab_size, 32, 2, seed=0)
    fun = make_train_state(tcfg, 0, global_batch=2)
    don = tree_map(torch.clone, fun)
    ptrs = _ptrs(don)
    fstep = make_train_step(tcfg, global_batch=2)
    dstep = make_train_step(tcfg, global_batch=2, donate=True)
    for s in range(5):
        fun, fm = fstep(fun, pipe.batch_at(s))
        out, dm = dstep(don, pipe.batch_at(s))
        assert out is don
        assert _bitwise_equal(fun, don), f"diverged at step {s}"
        assert {k: float(v) for k, v in fm.items()} == \
            {k: float(v) for k, v in dm.items()}
    assert _ptrs(don) == ptrs
    assert int(don["opt"]["t"]) == 5 and int(don["iv"]["step"]) == 5


# ---------------------------------------------------------------------------
# the donated pair (twins of tests/test_digest.py:266/:293/:323)
# ---------------------------------------------------------------------------

def test_donated_step_keeps_pointers_and_digests_survive():
    """After the in-place step overwrites the pre-step bytes (same
    pointers, new bits), the digests the pair armed at the bytes' last
    readable moment survive in the read table, bit-identical to the JAX
    package's per-leaf oracle of those bytes."""
    state = _tree()
    K = 2
    canary = ChecksumCanary(state, n_slices=K)
    ptrs = _ptrs(state)
    for s in range(2 * K):
        canary.arm_current(s, state)
        host = {k: v.clone() for k, v in _flat(state).items()}
        assert canary.check(s, state) is None
        state = _toy_step_(state)
        assert _ptrs(state) == ptrs
        assert not torch.equal(host["opt/m"], state["opt"]["m"])
        surviving = canary.reference_digests()
        for i in canary._slice_indices(s):
            key = canary._keys[i]
            assert np.array_equal(surviving[key], _oracle(host[key])), key


def test_donated_pair_hot_path_accounting(monkeypatch):
    """Steady state: arm = 1 launch + 0 fetches, check = 1 launch + 1
    scalar fetch (one ``row_checksums`` each), and the packing buffers
    keep their pointers."""
    calls = []
    real = tck.row_checksums
    monkeypatch.setattr(tck, "row_checksums",
                        lambda rows: calls.append(1) or real(rows))
    state = _tree()
    K = 4
    canary = ChecksumCanary(state, n_slices=K)
    for s in range(K):
        canary.arm_current(s, state)
        canary.check(s, state)
        state = _toy_step_(state)
    ptrs = canary.plan.buffer_pointers()
    n_leaves = canary.plan.n_leaves        # every slice's ring view
    assert {tuple(range(j, n_leaves, K)) for j in range(K)} <= set(ptrs)
    tdg.STATS.reset()
    calls.clear()
    n = 2 * K
    for s in range(K, K + n):
        canary.arm_current(s, state)
        assert canary.check(s, state) is None
        state = _toy_step_(state)
    assert tdg.STATS.snapshot() == (2 * n, n)
    assert len(calls) == 2 * n
    for idx, p in ptrs.items():
        assert canary.plan.buffer_pointer(idx) == p, idx


def test_donated_flip_between_arm_and_check_is_attributed():
    """A flip after the arm and before the step is caught by the check at
    the bytes' last readable moment, attributed to exactly that leaf,
    with live buffers (``consumed=False``)."""
    state = _tree()
    canary = ChecksumCanary(state, n_slices=1)
    reports = []
    for s in range(4):
        canary.arm_current(s, state)
        if s == 2:
            flip_bit(state["opt"]["m"], 11, 4)
        reports.append(canary.check(s, state))
        state = _toy_step_(state)
    hits = [r for r in reports if r is not None]
    assert len(hits) == 1 and reports[2] is hits[0]
    assert hits[0].leaves == ["opt/m"] and not hits[0].consumed


def test_check_leaves_tables_and_generation_alone():
    state = _tree()
    canary = ChecksumCanary(state, n_slices=3)
    canary.arm_current(0, state)
    g, tables = canary.generation, [t.clone() for t in canary._tables]
    ptrs = [t.data_ptr() for t in canary._tables]
    assert canary.check(0, state) is None
    assert canary.generation == g
    assert all(torch.equal(a, b) for a, b in zip(tables, canary._tables))
    canary.refresh(state)
    assert [t.data_ptr() for t in canary._tables] == ptrs


# ---------------------------------------------------------------------------
# the donated ladder
# ---------------------------------------------------------------------------

def _port(tcfg):
    pipe = TokenPipeline(tcfg.model.vocab_size, 32, 2, seed=0)
    return (make_train_state(tcfg, 0, global_batch=2),
            make_train_step(tcfg, global_batch=2, donate=True),
            pipe.batch_at)


def test_donated_replay_writes_into_the_live_tensors(tcfg):
    """The replay rung under donation copies the snapshot into the live
    tensors and replays there: the repaired state is the live tree
    (pointers kept) and bitwise the never-faulted state."""
    state, step, bfn = _port(tcfg)
    micro = MicroCheckpointer(interval=4)
    rt = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                         iv_registry=promote(tcfg, 2), micro=micro,
                         donated=True)
    for s in range(6):
        micro.maybe_snapshot(s, state)
        micro.record_iv(s, state["iv"])
        state, _ = step(state, bfn(s))
    clean = tree_map(torch.clone, state)
    ptrs = _ptrs(state)
    inject(state, InjectionPlan("embed/table", 5, 30, 6))
    inject(state, InjectionPlan("step", 0, 3, 6, "iv"))
    from repro_torch.core.detect import FaultReport
    fixed, ev = rt.recover(state, FaultReport(
        6, "checksum", leaves=["iv/step", "params/embed/table"]), 6)
    assert ev.rung == RUNG_REPLAY and ev.attempted == [RUNG_REPLAY]
    assert fixed is state and _ptrs(fixed) == ptrs
    assert _bitwise_equal(fixed, clean)


def test_donated_pair_parity_rung_repairs_in_place(tcfg):
    """With parity, a single embedding flip caught by the pair (live
    buffers, ``consumed=False``) is rebuilt by ``parity_xor`` into the
    live tensor: no snapshot, no replay, bitwise the clean state."""
    state, step, bfn = _port(tcfg)
    for s in range(3):
        state, _ = step(state, bfn(s))
    canary = ChecksumCanary(state, n_slices=1)
    store = ParityStore(state)
    store.build(state)
    canary.attach_parity(store)
    rt = RecoveryRuntime(step_fn=step, batch_fn=bfn,
                         iv_registry=promote(tcfg, 2),
                         micro=MicroCheckpointer(interval=4), parity=store,
                         canary=canary, donated=True)
    canary.arm_current(3, state)
    clean = tree_map(torch.clone, state)
    ptrs = _ptrs(state)
    inject(state, InjectionPlan("embed/table", 77, 2, 3))
    report = canary.check(3, state)
    assert report.leaves == ["params/embed/table"] and not report.consumed
    fixed, ev = rt.recover(state, report, 3)
    assert ev.rung == RUNG_PARITY and ev.steps_replayed == 0
    assert ev.bytes_moved > 0
    assert fixed is state and _ptrs(fixed) == ptrs
    assert _bitwise_equal(fixed, clean)


# ---------------------------------------------------------------------------
# the loop (twins of tests/test_faults_campaign.py:178/:192, and every mode)
# ---------------------------------------------------------------------------

def _run(cfg, **kw):
    return tlaunch.train(cfg, steps=10, global_batch=2, seq_len=32, seed=0,
                         snapshot_interval=4, canary_slices=1,
                         verbose=False, device="cpu", return_state=True,
                         **kw)


@pytest.fixture(scope="module")
def clean_run(tcfg):
    return _run(tcfg)


def test_donated_and_stock_loops_agree_bitwise(tcfg, clean_run):
    out, state = _run(tcfg, donate=True)
    assert out["faults_detected"] == 0
    assert _bitwise_equal(state, clean_run[1])
    assert out["final_loss"] == clean_run[0]["final_loss"]


@pytest.mark.parametrize("donate", [False, True])
def test_detector_free_loop_reaches_the_clean_state(tcfg, clean_run, donate):
    """``detectors=False``: no canary and no traps, the same trajectory
    (the canary only reads the state)."""
    out, state = _run(tcfg, detectors=False, donate=donate)
    assert out["steps"] == 10 and out["faults_detected"] == 0
    assert _bitwise_equal(state, clean_run[1])


@pytest.mark.parametrize("target", ["params", "opt", "iv"])
def test_donated_storm_recovers_via_replay_only(tcfg, clean_run, target):
    """Under donation every detection recovers through replay (never
    eq1, parity or triage), and the final state is the clean run's."""
    out, state = _run(tcfg, donate=True, inject_every=3,
                      inject_target=target)
    assert out["faults_detected"] == out["faults_injected"] >= 3
    assert out["recovery"]["by_rung"] == {RUNG_REPLAY:
                                          out["faults_detected"]}
    assert _bitwise_equal(state, clean_run[1])


MODES = [dict(donate=True, parity=True),
         dict(fused_detect=True),
         dict(fused_detect=True, parity=True),
         dict(fused_detect=True, donate=True),
         dict(fused_detect=True, donate=True, parity=True),
         dict(fused_detect=True, fused_warm="lazy", triage=True),
         dict(donate=True, triage=True, parity=True),
         dict(fused_detect=True, donate=True, triage=True)]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(sorted(m)))
def test_storm_equals_clean_in_every_mode(tcfg, clean_run, mode):
    """A params storm under each combination of donation, fused
    detection, parity and triage: detected == injected == recovered,
    only the rungs the mode allows, final state == clean, bitwise."""
    out, state = _run(tcfg, inject_every=3, **mode)
    assert out["faults_detected"] == out["faults_injected"] >= 3
    assert out["faults_recovered"] == out["faults_detected"]
    rungs = set(out["recovery"]["by_rung"])
    if mode.get("donate"):
        allowed = {RUNG_REPLAY}
        if mode.get("parity") and not mode.get("fused_detect"):
            allowed.add(RUNG_PARITY)
        assert rungs <= allowed, rungs
    assert _bitwise_equal(state, clean_run[1])
    if mode.get("fused_detect"):
        assert out["fused"]["builds"] == 1


FLAG_SETS = [["--donate"], ["--fused-detect"], ["--donate", "--fused-detect"],
             ["--parity", "--donate"]]


@pytest.mark.parametrize("flags", FLAG_SETS + [f + ["--triage"]
                                               for f in FLAG_SETS],
                         ids=lambda f: " ".join(f))
def test_train_cli_modes_recover_every_detection(flags):
    out = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "10",
                        "--batch", "2", "--seq", "32", "--inject", "4",
                        "--canary-slices", "1"] + flags)
    assert out["faults_detected"] == out["faults_injected"] > 0
    assert out["faults_recovered"] == out["faults_detected"]
    if flags == ["--donate"]:
        assert set(out["recovery"]["by_rung"]) == {RUNG_REPLAY}
