"""Recovery rung 0 (triage) of the port against the JAX package: the
single-flip solver on seeded digest pairs, the rung on the smoke model's
state (tolerate, escalate, the dead-element boundary) and the training
loop under ``triage=True`` (smoke config, B=2, S=32, on the CPU).

Integer results (solver outputs, rung choices, digests) are exact; every
repair is checked bit for bit.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChecksumCanary as JCanary
from repro.core import InjectionPlan as JPlan
from repro.core import MicroCheckpointer as JMicro
from repro.core import RecoveryRuntime as JRuntime
from repro.core import inject as jinject
from repro.core import promote as jpromote
from repro.kernels import digest as jdg
from repro.optim.optimizers import QBLOCK as JQBLOCK
from repro.optim.optimizers import _q8
from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary
from repro_torch.core.faults import InjectionPlan, inject
from repro_torch.core.icp import promote
from repro_torch.core.microcheckpoint import MicroCheckpointer
from repro_torch.core.recover import QBLOCK, RecoveryRuntime
from repro_torch.core.recovery_table import RUNG_REPLAY, RUNG_TRIAGE
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import digest as tdg
from repro_torch.launch import train as tlaunch
from repro_torch.train.loop import make_train_step
from repro_torch.tree import flatten_with_path, leaf_key, tree_map

MOMENT = "m/groups/0/0/ffn/up/w"


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


# ---------------------------------------------------------------------------
# locate_single_flip
# ---------------------------------------------------------------------------

def _pair(words: np.ndarray) -> np.ndarray:
    return tdg.host_checksum(words.view(np.int32))


@pytest.mark.parametrize("bit", range(32))
def test_locate_single_flip_matches_reference(bit):
    """A seeded flip of ``bit`` in a 1,000-word leaf (one candidate for
    every bit below 23) and in a 2^20 + 5-word leaf (several candidates
    from bit 13 up): the port's solution equals the reference's and names
    the flipped word, its old bits and every word the pair cannot tell
    from it."""
    rng = np.random.default_rng(bit)
    for n in (1000, (1 << 20) + 5):
        words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        j = int(rng.integers(0, n))
        flipped = words.copy()
        flipped[j] ^= np.uint32(1 << bit)
        ref, cur = _pair(words), _pair(flipped)
        got = tdg.locate_single_flip(ref, cur, n)
        assert got == jdg.locate_single_flip(ref, cur, n)
        b, delta, cands = got
        assert b == bit and j in cands
        assert (int(flipped[j]) - delta) & 0xFFFFFFFF == int(words[j])
        # every word at a multiple of 2^(32-bit) from j fits the pair
        period = 1 << (32 - bit)
        assert cands == list(range(j % period, n, period))
        if bit >= 13 and n > 1000:
            assert len(cands) > 1


def test_locate_single_flip_refuses_what_no_single_flip_explains():
    """No flip, two flips in different words, two bits of one word and
    random pairs: the port agrees with the reference case for case, and
    the consistent-looking ones it does solve are the reference's too."""
    rng = np.random.default_rng(7)
    n = 4096
    words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ref = _pair(words)
    assert tdg.locate_single_flip(ref, ref, n) is None
    assert jdg.locate_single_flip(ref, ref, n) is None
    nones = 0
    for t in range(200):
        two = words.copy()
        i, j = rng.choice(n, 2, replace=False)
        two[i] ^= np.uint32(1 << int(rng.integers(0, 32)))
        if t % 2:
            two[j] ^= np.uint32(1 << int(rng.integers(0, 32)))
        else:                                # two bits of one word
            b1, b2 = rng.choice(32, 2, replace=False)
            two[i] ^= np.uint32((1 << int(b1)) | (1 << int(b2)))
        cur = _pair(two)
        got = tdg.locate_single_flip(ref, cur, n)
        assert got == jdg.locate_single_flip(ref, cur, n)
        nones += got is None
        pair = np.array([rng.integers(0, 2**32), rng.integers(0, 2**32)],
                        np.uint32).view(np.int32)
        assert tdg.locate_single_flip(ref, pair, n) == \
            jdg.locate_single_flip(ref, pair, n)
    assert nones > 150        # damage beyond one bit is refused


def test_inverse_of_odd_words():
    for w in (1, 3, 0xFFFFFFFF, 0x12345679, (1 << 31) + 1):
        assert (w * tdg._inv_odd_u32(w)) & 0xFFFFFFFF == 1
        assert tdg._inv_odd_u32(w) == jdg._inv_odd_u32(w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_word_values_match_reference(dtype):
    """The certificate's decoder, on packed words with the high half set
    as ``cur - delta`` leaves it, value for value the reference's
    ``_word_value`` (NaN where it gives NaN)."""
    from repro.core.recover import _word_value as jword_value
    from repro_torch.core.recover import _word_values
    gen = np.random.default_rng(5)
    words = gen.integers(0, 2**32, size=64, dtype=np.uint64).astype(
        np.uint32)
    words[:4] = [0, 0x7F800000, 0x80000001, 0xFFFF3F80]
    mine = _word_values(getattr(torch, dtype), words)
    theirs = np.array([jword_value(getattr(jnp, dtype), int(w))
                       for w in words])
    assert np.array_equal(mine, theirs, equal_nan=True)


# ---------------------------------------------------------------------------
# the rung on the smoke model (twins of tests/test_recovery.py)
# ---------------------------------------------------------------------------

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


def _reference_triage(tiny_setup, bit):
    """The reference's rung on the same scenario: (rung, detail)."""
    cfg, state0, step, bfn = tiny_setup
    micro = JMicro(interval=4)
    rt = JRuntime(step_fn=step, batch_fn=bfn, iv_registry=jpromote(cfg, 2),
                  micro=micro, triage=True)
    state = state0
    for s in range(6):
        micro.maybe_snapshot(s, state)
        micro.record_iv(s, state["iv"])
        state, _ = step(state, bfn(s))
    rt.canary = JCanary(state, n_slices=1)
    bad = jinject(state, JPlan(MOMENT, 1000, bit, 6, "opt"))
    report = rt.canary.check(6, bad)
    _, ev = rt.recover(bad, report, 6)
    return ev.rung, ev.report.detail


def test_triage_tolerates_sub_epsilon_moment_flip(port, tiny_setup):
    """Twin of test_recovery.py:268.  A mantissa-tail flip in an EMA
    moment is tolerated in place (state untouched, 0 bytes, 0 steps) and
    the re-armed digest row keeps the next check quiet; the reference
    takes the same rung on the same bits."""
    _, state0, step, bfn = port
    state = _advance(step, bfn, state0, 0, 6)
    canary = ChecksumCanary(state, n_slices=1)
    rt, _ = _runtime(port, canary=canary, triage=True)

    bad = inject(_clone(state), InjectionPlan(MOMENT, 1000, 1, 6, "opt"))
    report = canary.check(6, bad)
    assert report is not None and report.detector == "checksum"
    assert report.leaves == ["opt/" + MOMENT] and not report.consumed

    fixed, ev = rt.recover(bad, report, 6)
    assert ev.rung == RUNG_TRIAGE
    assert ev.steps_replayed == 0 and ev.bytes_moved == 0
    assert "sub-epsilon moment perturbation (bit 1" in ev.report.detail
    assert _bitwise_equal(fixed, bad)          # tolerate never alters state
    assert canary.check(7, fixed) is None     # re-armed
    rung, detail = _reference_triage(tiny_setup, 1)
    assert rung == RUNG_TRIAGE and "(bit 1," in detail


def test_triage_escalates_uncertifiable_flip(port, tiny_setup):
    """Twin of test_recovery.py:296.  An exponent-scale flip in the same
    moment fails the epsilon certificate and escalates to replay, which
    restores the clean state bit for bit."""
    _, state0, step, bfn = port
    rt, micro = _runtime(port, triage=True)
    state = _advance(step, bfn, state0, 0, 6, micro)
    rt.canary = ChecksumCanary(state, n_slices=1)

    bad = inject(_clone(state), InjectionPlan(MOMENT, 1000, 30, 6, "opt"))
    report = rt.canary.check(6, bad)
    assert report is not None

    fixed, ev = rt.recover(bad, report, 6)
    assert ev.rung == RUNG_REPLAY and ev.attempted[0] == RUNG_TRIAGE
    assert "escalate" in ev.report.detail
    assert _bitwise_equal(fixed, state)
    assert _reference_triage(tiny_setup, 30)[0] == RUNG_REPLAY


def test_triage_escalates_param_flip(port):
    """A params leaf has no tolerance certificate: a low-mantissa flip
    there escalates (to replay) all the same."""
    _, state0, step, bfn = port
    rt, micro = _runtime(port, triage=True)
    state = _advance(step, bfn, state0, 0, 5, micro)
    rt.canary = ChecksumCanary(state, n_slices=1)
    bad = inject(_clone(state), InjectionPlan("embed/table", 99, 0, 5))
    report = rt.canary.check(5, bad)
    fixed, ev = rt.recover(bad, report, 5)
    assert ev.attempted[0] == RUNG_TRIAGE and ev.rung != RUNG_TRIAGE
    assert "not an EMA moment" in ev.report.detail
    assert _bitwise_equal(fixed, state)


def _q8_state(tensors: bool):
    """The hand-built int8-moment state of test_recovery.py:319/:341:
    a 300-element param whose quantised moment pads to 2 x QBLOCK."""
    p = jnp.arange(300, dtype=jnp.float32) / 7.0
    jstate = {"params": {"w": p}, "opt": {"m": {"w": _q8(p)}},
              "iv": {"step": jnp.int32(4)}}
    return state_from_numpy(_host(jstate)) if tensors else jstate


def test_triage_dead_element_boundary(port, tiny_setup):
    """Twin of test_recovery.py:341 on hand-built ``/q`` and ``/scale``
    leaves: the dead-element predicate draws the line at the logical
    param size, element for element as the reference does."""
    assert QBLOCK == JQBLOCK
    rt, _ = _runtime(port)
    jrt = JRuntime(step_fn=None, batch_fn=None,
                   iv_registry=jpromote(tiny_setup[0], 2), micro=JMicro(4))
    state, jstate = _q8_state(True), _q8_state(False)
    assert rt._dead_element(state, "opt/m/w/q", 300)       # first pad elt
    assert rt._dead_element(state, "opt/m/w/q", 511)       # last pad elt
    assert not rt._dead_element(state, "opt/m/w/q", 299)   # last live elt
    assert not rt._dead_element(state, "opt/m/w/scale", 0)
    assert not rt._dead_element(state, "opt/m/w/scale", 1)
    assert rt._dead_element(state, "opt/m/w/scale", 2)     # all-pad block
    assert not rt._dead_element(state, "params/w", 500)
    for key in ("opt/m/w/q", "opt/m/w/scale", "params/w", "iv/step"):
        for j in (0, 1, 2, 255, 256, 299, 300, 511):
            assert rt._dead_element(state, key, j) == \
                jrt._dead_element(jstate, key, j), (key, j)


def test_triage_tolerates_int8_pad_tail_flip(port):
    """Twin of test_recovery.py:319 on the hand-built leaves: a flip in
    the quantised moment's pad tail is tolerated as a dead region."""
    state = _q8_state(True)
    canary = ChecksumCanary(state, n_slices=1)
    rt, _ = _runtime(port, canary=canary, triage=True)
    bad = inject(_clone(state), InjectionPlan("m/w/q", 310, 6, 4, "opt"))
    report = canary.check(4, bad)
    assert report is not None and report.leaves == ["opt/m/w/q"]
    fixed, ev = rt.recover(bad, report, 4)
    assert ev.rung == RUNG_TRIAGE and "dead-region" in ev.report.detail
    assert _bitwise_equal(fixed, bad)
    assert canary.check(5, fixed) is None


def test_triage_gate_follows_the_reference(port):
    """Rung 0 applies only to a checksum report with live buffers and a
    leaf attribution, with triage on and a canary attached."""
    from repro_torch.core.detect import FaultReport
    _, state, _, _ = port
    can = ChecksumCanary(state, n_slices=1)
    rt, _ = _runtime(port, canary=can, triage=True)
    live = FaultReport(3, "checksum", leaves=["opt/v/embed/table"])
    assert rt._ladder(live)[0] == RUNG_TRIAGE
    for rep in (FaultReport(3, "nonfinite"),
                FaultReport(3, "checksum", leaves=["opt/v/embed/table"],
                            consumed=True),
                FaultReport(3, "checksum")):
        assert RUNG_TRIAGE not in rt._ladder(rep)
    off, _ = _runtime(port, canary=can)
    assert RUNG_TRIAGE not in off._ladder(live)
    don, _ = _runtime(port, canary=can, triage=True, donated=True)
    assert don._ladder(live) == [RUNG_TRIAGE, RUNG_REPLAY, "checkpoint"]


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tcfg():
    return get_config("iterpro-100m").smoke()


def _run(cfg, **kw):
    return tlaunch.train(cfg, steps=10, global_batch=2, seq_len=32, seed=0,
                         snapshot_interval=4, canary_slices=1,
                         verbose=False, device="cpu", return_state=True,
                         **kw)


def test_train_triage_storms_recover(tcfg):
    """``train(triage=True)`` at --smoke: an optimizer-state storm and a
    params storm are detected and recovered one for one; params flips
    never stop at rung 0, so that storm's final state is the clean
    run's, bit for bit."""
    _, clean = _run(tcfg)
    for target in ("opt", "params"):
        out, state = _run(tcfg, inject_every=3, inject_target=target,
                          triage=True)
        assert out["faults_detected"] == out["faults_injected"] >= 3
        assert out["faults_recovered"] == out["faults_detected"]
        if target == "params":
            assert RUNG_TRIAGE not in out["recovery"]["by_rung"]
            assert _bitwise_equal(state, clean)


def test_train_triage_requires_a_canary(tcfg):
    with pytest.raises(ValueError, match="triage requires detectors"):
        _run(tcfg, detectors=False, triage=True)
    with pytest.raises(ValueError, match="fused_detect requires detectors"):
        _run(tcfg, detectors=False, fused_detect=True)
