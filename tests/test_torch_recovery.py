"""The port's detection, fault injection and recovery ladder against the
JAX package (smoke config, B=2, S=32, on the CPU).

Digest tables, fault plans, attributions and rung choices are bitwise or
exact; every repair is checked bit for bit against the never-faulted
state.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.core import ChecksumCanary as JCanary
from repro.core import FaultReport as JReport
from repro.core import MicroCheckpointer as JMicro
from repro.core import RecoveryRuntime as JRuntime
from repro.core import inject as jinject
from repro.core import promote as jpromote
from repro.core import sample_plan as jsample_plan
from repro.core.induction import IVRegistry as JRegistry
from repro_torch.bridge import state_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary, FaultReport
from repro_torch.core.faults import InjectionPlan, inject, sample_plan
from repro_torch.core.icp import promote
from repro_torch.core.induction import IVRegistry
from repro_torch.core.microcheckpoint import MicroCheckpointer
from repro_torch.core.recover import RecoveryFailed, RecoveryRuntime
from repro_torch.core.recovery_table import (RUNG_EQ1, RUNG_OPT_IV,
                                             RUNG_REPLAY, RecoveryTable)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as tdg
from repro_torch.train.loop import make_train_step
from repro_torch.tree import flatten_with_path, leaf_key, tree_map


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clone(tree):
    return tree_map(torch.clone, tree)


def _bitwise_equal(a, b):
    fa = {leaf_key(p): t for p, t in flatten_with_path(a)}
    fb = {leaf_key(p): t for p, t in flatten_with_path(b)}
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


@pytest.fixture(scope="module")
def port(tiny_setup):
    """(cfg, bridged initial state, functional step, batch_fn)."""
    cfg = get_config("iterpro-100m").smoke()
    _, jstate0, _, _ = tiny_setup
    pipe = TokenPipeline(cfg.model.vocab_size, 32, 2, seed=0)
    return (cfg, state_from_numpy(_host(jstate0)),
            make_train_step(cfg, global_batch=2), pipe.batch_at)


def _advance(step, bfn, state, start, n, micro=None):
    for s in range(start, start + n):
        if micro is not None:
            micro.maybe_snapshot(s, state)
            micro.record_iv(s, state["iv"])
        state, _ = step(state, bfn(s))
    return state


def _runtime(port, **kw):
    cfg, _, step, bfn = port
    micro = MicroCheckpointer(interval=4)
    return RecoveryRuntime(step_fn=step, batch_fn=bfn,
                           iv_registry=promote(cfg, 2), micro=micro,
                           **kw), micro


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def test_check_and_arm_tables_match_reference(tiny_setup, monkeypatch):
    """On the same state sequence (the reference's states, bridged) the
    two canaries' reference tables agree bit for bit every step, and each
    steady step costs 1 row_checksums launch and 1 fetch."""
    _, jstate, jstep, jbfn = tiny_setup
    jcan = JCanary(jstate, n_slices=3)
    tcan = ChecksumCanary(state_from_numpy(_host(jstate)), n_slices=3)
    assert np.array_equal(tcan.reference.numpy(), np.asarray(jcan.reference))
    calls = []
    real = tck.row_checksums
    monkeypatch.setattr(tck, "row_checksums",
                        lambda rows: calls.append(1) or real(rows))
    for s in range(4):
        jnew, _ = jstep(jstate, jbfn(s))
        tdg.STATS.reset()
        calls.clear()
        assert jcan.check_and_arm(s, jstate, jnew) is None
        assert tcan.check_and_arm(s, state_from_numpy(_host(jstate)),
                                  state_from_numpy(_host(jnew))) is None
        assert (len(calls), tdg.STATS.syncs, tdg.STATS.launches) == (1, 1, 1)
        assert tcan.generation == jcan.generation
        assert np.array_equal(tcan.reference.numpy(),
                              np.asarray(jcan.reference))
        jstate = jnew


def test_check_full_and_fault_reference(port):
    _, state, _, _ = port
    can = ChecksumCanary(state, n_slices=4)
    assert can.check_full(0, state) is None
    bad = _clone(state)
    inject(bad, InjectionPlan("embed/table", 17, 3, 0))
    rep = can.check_full(0, bad)
    assert rep.detector == "checksum" and rep.leaves == ["params/embed/table"]
    ref = can.fault_reference_digests()
    assert np.array_equal(ref["params/embed/table"],
                          tdg.host_checksum(state["params"]["embed"]["table"]))
    assert ref.keys() == can.reference_digests().keys()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("target", ["params", "opt", "iv"])
def test_fault_plan_and_report_match_reference(tiny_setup, seed, target):
    """Seeded alike, both adversaries name the same leaf, element and bit;
    the flipped bytes are equal and both canaries attribute the same
    leaves."""
    _, jstate, _, _ = tiny_setup
    tstate = state_from_numpy(_host(jstate))
    jplan = jsample_plan(random.Random(seed), jstate, 1, target=target)
    tplan = sample_plan(random.Random(seed), tstate, 1, target=target)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    jbad = jinject(jstate, jplan)
    tcan = ChecksumCanary(tstate, n_slices=1)
    inject(tstate, tplan)                       # in place
    assert _bitwise_equal(tstate, state_from_numpy(_host(jbad)))
    jrep = JCanary(jstate, n_slices=1).check(0, jbad)
    trep = tcan.check_and_arm(0, tstate)
    assert jrep is not None and trep is not None
    assert trep.leaves == jrep.leaves == [f"{target}/{tplan.leaf}"]


def test_traps(port):
    from repro_torch.core.detect import (LOSS_WINDOW, trap_loss_spike,
                                         trap_nonfinite)
    assert trap_nonfinite(3, {"loss": 1.0, "grad_norm": 2.0}) is None
    assert trap_nonfinite(3, {"loss": float("nan")}).detector == "nonfinite"
    hist = [1.0] * LOSS_WINDOW
    assert trap_loss_spike(4, {"loss": 5.0}, hist) is None
    assert trap_loss_spike(4, {"loss": 50.0}, hist).detector == "loss_spike"
    assert trap_loss_spike(4, {"loss": 50.0}, hist[1:]) is None


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

def test_rung_selection_matches_reference(tiny_setup, port):
    jcfg, _, jstep, jbfn = tiny_setup
    jrt = JRuntime(step_fn=jstep, batch_fn=jbfn,
                   iv_registry=jpromote(jcfg, 2), micro=JMicro(4))
    trt, _ = _runtime(port)
    for leaves in (["iv/sched_pos"], ["iv/step", "iv/data_offset"],
                   ["opt/t"], ["opt/bc1"], ["opt/bc2"],
                   ["params/embed/table"], ["opt/m/embed/table"], []):
        for det in ("checksum", "nonfinite"):
            assert trt._ladder(FaultReport(5, det, leaves=list(leaves))) == \
                jrt._ladder(JReport(5, det, leaves=list(leaves))), leaves


def test_iv_corruption_recovers_via_eq1(port):
    cfg, state0, step, bfn = port
    rt, micro = _runtime(port)
    state = _advance(step, bfn, state0, 0, 6, micro)
    bad = dict(state, iv=dict(state["iv"],
                              sched_pos=torch.tensor(12345,
                                                     dtype=torch.int32)))
    fixed, ev = rt.recover(bad, FaultReport(6, "checksum",
                                            leaves=["iv/sched_pos"]), 6)
    assert ev.rung == RUNG_EQ1 and ev.steps_replayed == 0
    assert _bitwise_equal(fixed, state)


@pytest.mark.parametrize("leaf,bit", [("t", 3), ("bc1", 20), ("bc2", 30)])
def test_opt_induction_flip_recovers_via_opt_iv(port, leaf, bit):
    cfg, state0, step, bfn = port
    rt, micro = _runtime(port)
    state = _advance(step, bfn, state0, 0, 6, micro)
    bad = inject(_clone(state), InjectionPlan(leaf, 0, bit, 6, "opt"))
    fixed, ev = rt.recover(bad, FaultReport(6, "checksum",
                                            leaves=[f"opt/{leaf}"]), 6)
    assert ev.rung == RUNG_OPT_IV and ev.steps_replayed == 0
    assert _bitwise_equal(fixed, state)          # bc recomputed bit-exact


def test_param_corruption_replays_bit_exact_and_trajectory_is_clean(port):
    cfg, state0, step, bfn = port
    rt, micro = _runtime(port)
    clean = _advance(step, bfn, state0, 0, 10)
    state = _advance(step, bfn, state0, 0, 6, micro)
    plan = dataclasses.replace(
        sample_plan(random.Random(1), state, 1, target="params"), bit=27)
    bad = inject(_clone(state), plan)
    fixed, ev = rt.recover(bad, FaultReport(6, "checksum",
                                            leaves=["params/" + plan.leaf]),
                           6)
    assert ev.rung == RUNG_REPLAY and ev.steps_replayed == 2
    assert ev.attempted == ["eq1", "replica_vote", "parity_xor", "replay"]
    assert "parity_xor: no parity maintained" in ev.report.detail
    assert _bitwise_equal(fixed, state)
    assert _bitwise_equal(_advance(step, bfn, fixed, 6, 4), clean)


def test_reuse_state_replays_into_the_faulty_tensors(port):
    """``reuse_state``: the functional replay writes into the faulty
    state's tensors (every ``data_ptr`` kept, two state versions at most)
    and its result is bitwise the fresh-state replay's."""
    cfg, state0, step, bfn = port
    rt, micro = _runtime(port, reuse_state=True)
    state = _advance(step, bfn, state0, 0, 6, micro)
    plan = dataclasses.replace(
        sample_plan(random.Random(1), state, 1, target="params"), bit=27)
    bad = inject(_clone(state), plan)
    ptrs = [t.data_ptr() for _, t in flatten_with_path(bad)]
    fixed, ev = rt.recover(bad, FaultReport(6, "checksum",
                                            leaves=["params/" + plan.leaf]),
                           6)
    assert ev.rung == RUNG_REPLAY and ev.steps_replayed == 2
    assert fixed is bad
    assert [t.data_ptr() for _, t in flatten_with_path(fixed)] == ptrs
    assert _bitwise_equal(fixed, state)


def test_replica_vote_rung_repairs_bit_exactly(port):
    cfg, state0, step, bfn = port
    state = _advance(step, bfn, state0, 0, 3)
    rt, _ = _runtime(port, replicas=lambda s: [_clone(state), _clone(state)])
    plan = dataclasses.replace(
        sample_plan(random.Random(2), state, 1, target="params"), bit=30)
    bad = inject(_clone(state), plan)
    fixed, ev = rt.recover(bad, FaultReport(3, "checksum",
                                            leaves=["params/" + plan.leaf]),
                           3)
    assert ev.rung == "replica_vote" and ev.attempted == ["eq1",
                                                          "replica_vote"]
    assert _bitwise_equal(fixed, state)


def test_checkpoint_rung_restores_and_replays(port, tmp_path):
    cfg, state0, step, bfn = port
    mgr = CheckpointManager(str(tmp_path), interval=2)
    state = state0
    for s in range(5):
        mgr.maybe_save(s, state)
        state, _ = step(state, bfn(s))
    mgr.wait()
    rt, _ = _runtime(port, checkpoint=mgr.loader(state))
    bad = inject(_clone(state), InjectionPlan("final_norm/scale", 3, 30, 5))
    fixed, ev = rt.recover(bad, FaultReport(5, "external"), 5,
                           ladder=["checkpoint"])
    assert ev.rung == "checkpoint" and ev.steps_replayed == 1
    assert _bitwise_equal(fixed, state)


def test_rotted_snapshot_escalates(port):
    cfg, state0, step, bfn = port
    rt, micro = _runtime(port)
    state = _advance(step, bfn, state0, 0, 5, micro)
    inject(micro.latest().state, InjectionPlan("embed/table", 0, 5, 4))
    with pytest.raises(RecoveryFailed):
        rt.recover(state, FaultReport(5, "checksum",
                                      leaves=["params/embed/table"]), 5)
    assert "snapshot failed verification" in rt.events[-1].report.detail


def test_exhausted_ladder_raises(port):
    cfg, state0, step, bfn = port
    rt, _ = _runtime(port)
    state = _advance(step, bfn, state0, 0, 2)
    bad = dict(state, iv={k: v + 7 + i for i, (k, v)
                          in enumerate(state["iv"].items())})
    with pytest.raises(RecoveryFailed):
        rt.recover(bad, FaultReport(2, "checksum",
                                    leaves=[f"iv/{k}" for k in bad["iv"]]), 2)


def _mesh_shardings():
    from repro_torch.distributed.context import DistContext
    from repro_torch.distributed.sharding import LeafSharding, P
    ctx = DistContext.for_shape((4, 2), ("data", "model"))
    return {"params": {"w": LeafSharding(ctx, P(None, "model"), (4, 4),
                                         torch.float32)}}


# ``shardings`` (the mesh slice) and ``elastic`` (the elastic slice) are
# ported: the runtime keeps the hard-loss handler for its remesh rung
@pytest.mark.parametrize("kw", [{"shardings": _mesh_shardings(),
                                 "elastic": lambda *a: None},
                                {"elastic": lambda *a: None}])
def test_unported_runtime_arguments_raise(port, kw):
    rt, _ = _runtime(port, **kw)
    assert rt.elastic is kw["elastic"] and rt.pending_remesh is None
    assert (rt.ctx is not None) == ("shardings" in kw)


@pytest.mark.parametrize("kw", [{"triage": True}, {"donated": True},
                                {"donated": True, "triage": True}],
                         ids=lambda kw: "-".join(sorted(kw)))
def test_mode_rung_selection_matches_reference(tiny_setup, port, kw):
    """The triage gate and the donated pivot choose the reference's
    ladder for every detector, attribution and ``consumed`` flag."""
    jcfg, jstate0, jstep, jbfn = tiny_setup
    _, state0, _, _ = port
    jrt = JRuntime(step_fn=jstep, batch_fn=jbfn,
                   iv_registry=jpromote(jcfg, 2), micro=JMicro(4),
                   canary=JCanary(jstate0, n_slices=1), **kw)
    trt, _ = _runtime(port, canary=ChecksumCanary(state0, n_slices=1), **kw)
    for leaves in (["iv/step"], ["opt/t"], ["params/embed/table"],
                   ["opt/v/embed/table"], []):
        for det in ("checksum", "nonfinite", "external"):
            for consumed in (False, True):
                mine = FaultReport(5, det, leaves=list(leaves),
                                   consumed=consumed)
                theirs = JReport(5, det, leaves=list(leaves),
                                 consumed=consumed)
                assert trt._ladder(mine) == jrt._ladder(theirs), \
                    (leaves, det, consumed)


def test_recovery_table_round_trip_and_every_rung_handled(port):
    cfg, state0, _, _ = port
    reg = promote(cfg, 2)
    opt_ivs = tuple(sorted(k for k in set(reg.specs) | set(reg.derived)
                           if not k.startswith("iv/")))
    emittable = set()
    for flags in range(32):
        table = RecoveryTable.build(
            state0, replicated=bool(flags & 1), parity=bool(flags & 2),
            sharded=bool(flags & 4), triage=bool(flags & 8),
            elastic=bool(flags & 16), opt_ivs=opt_ivs)
        for entry in table.entries.values():
            emittable.update(entry.ladder)
    assert emittable == set(RecoveryRuntime._RUNGS)
    table = RecoveryTable.build(state0, replicated=True, opt_ivs=opt_ivs)
    assert RecoveryTable.from_json(table.to_json()).entries == table.entries
    assert len(table) == len(flatten_with_path(state0))
    assert table.lookup("opt/t").ladder[0] == RUNG_OPT_IV


def test_induction_diagnosis_matches_reference():
    specs = {"a": (0, 1), "b": (0, 8), "c": (3, 2), "d": (0, 1)}
    ours, theirs = IVRegistry(specs), JRegistry(specs)
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 1000))
        vals = {k: i + n * s for k, (i, s) in specs.items()}
        for k in rng.choice(list(specs), size=int(rng.integers(0, 3)),
                            replace=False):
            vals[k] += int(rng.integers(1, 50))
        assert ours.diagnose(vals) == theirs.diagnose(vals)
