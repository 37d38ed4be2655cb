"""In-step fused detection of the port (``core/fused_step.py`` through
``ChecksumCanary.fuse_into_step``) on the CPU: twins of
tests/test_fused_step.py.

A CUDA graph cannot run here; the capture path is held on the card by
``chip_smoke.py``.  These tests hold the eager path, which runs the same
phases with the same digests: its trajectory and tables are bitwise the
unfused protocols' (and the JAX package's fused factory's), a steady step
is 1 logical launch and 1 fetch, and a flip is attributed through the
deferred resolver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.detect import ChecksumCanary as JCanary
from repro_torch.core.detect import ChecksumCanary, FaultReport
from repro_torch.core.faults import flip_bit
from repro_torch.core.parity import ParityStore
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import digest as tdg
from repro_torch.tree import flatten_with_path, leaf_key, tree_map

BATCH = torch.ones(8, dtype=torch.float32)


def _flat(tree):
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _bitwise_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].reshape(-1).view(torch.uint8),
                    fb[k].reshape(-1).view(torch.uint8)) for k in fa)


def _np_tree(seed=11):
    """Mixed dtypes and shapes (multi-tile, sub-tile, 16-bit, int,
    scalar), as numpy arrays (bf16 as f32 values rounded later)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((257, 129), np.float32),
                   "b": rng.standard_normal(33, np.float32)},
        "opt": {"m": rng.standard_normal(40000, np.float32)},
        "iv": {"step": np.int32(12), "pos": np.int32(7)},
        "tok": rng.integers(-5, 5, (17, 3), dtype=np.int32),
    }


def _tree():
    t = tree_map(lambda a: torch.from_numpy(np.array(a)), _np_tree())
    t["params"]["b"] = t["params"]["b"].to(torch.bfloat16)
    return t


def _jtree():
    t = jax.tree_util.tree_map(jnp.asarray, _np_tree())
    t["params"]["b"] = t["params"]["b"].astype(jnp.bfloat16)
    return t


def _upd(x):
    if x.is_floating_point():
        return x * torch.tensor(1.01, dtype=x.dtype)
    return x + 1


def _raw_step(t, batch):
    """Functional, structure- and dtype-preserving step (+aux)."""
    return tree_map(_upd, t), {"loss": batch.sum()}


def _raw_step_(t, batch):
    """The same step in place (the donated form)."""
    for _, x in flatten_with_path(t):
        if x.is_floating_point():
            x.mul_(torch.tensor(1.01, dtype=x.dtype))
        else:
            x.add_(1)
    return t, {"loss": batch.sum()}


def _jraw_step(t, batch):
    def upd(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return (x * jnp.asarray(1.01, x.dtype)).astype(x.dtype)
        return x + jnp.ones((), x.dtype)
    return jax.tree_util.tree_map(upd, t), {"loss": batch.sum()}


# ---------------------------------------------------------------------------
# bit-exact conformance with the unfused protocols
# ---------------------------------------------------------------------------

def test_fused_matches_check_and_arm_bitwise_nondonated():
    """Fused (donate=False) against ``check_and_arm``: the same protocol
    timing, so trajectories, tables and generations match at every step
    — and the tables equal the JAX package's fused factory's."""
    K = 3
    state_f = _tree()
    can_f = ChecksumCanary(state_f, n_slices=K)
    fac = can_f.fuse_into_step(_raw_step, donate=False)
    state_r = _tree()
    can_r = ChecksumCanary(state_r, n_slices=K)
    jstate = _jtree()
    jcan = JCanary(jstate, n_slices=K)
    jfac = jcan.fuse_into_step(_jraw_step, donate=False)
    jbatch = jnp.ones((8,), jnp.float32)
    for s in range(2 * K):
        state_f, _, rep = fac.step(s, state_f, BATCH)
        assert rep is None
        new_r, _ = _raw_step(state_r, BATCH)
        assert can_r.check_and_arm(s, state_r, new_r) is None
        state_r = new_r
        jstate, _, jrep = jfac.step(s, jstate, jbatch)
        assert jrep is None
        assert _bitwise_equal(state_f, state_r), f"trajectory at {s}"
        assert torch.equal(can_f.reference, can_r.reference), s
        assert np.array_equal(can_f.reference.numpy(),
                              np.asarray(jcan.reference)), s
        assert can_f.generation == can_r.generation == jcan.generation


def test_fused_matches_donated_pair_bitwise():
    """Fused (donate=True, in-place step) against the donated pair: the
    same trajectory bit for bit, pointers kept, and the slice each fused
    step checked was armed with the oracle digests of its input."""
    K = 2
    state_f = _tree()
    can_f = ChecksumCanary(state_f, n_slices=K)
    fac = can_f.fuse_into_step(_raw_step_, donate=True)
    state_r = _tree()
    can_r = ChecksumCanary(state_r, n_slices=K)
    ptrs = {k: t.data_ptr() for k, t in _flat(state_f).items()}
    for s in range(2 * K):
        oracle = {k: tdg.host_checksum(v)
                  for k, v in zip(can_f._keys, can_f.plan.leaves(state_f))}
        state_f, _, rep = fac.step(s, state_f, BATCH)
        assert rep is None
        assert {k: t.data_ptr() for k, t in _flat(state_f).items()} == ptrs
        surviving = can_f._tables[(can_f._gen - 1) & 1].numpy()
        for i in can_f._slice_indices(s):
            assert np.array_equal(surviving[i], oracle[can_f._keys[i]]), s
        can_r.arm_current(s, state_r)
        assert can_r.check(s, state_r) is None
        state_r, _ = _raw_step_(state_r, BATCH)
        assert _bitwise_equal(state_f, state_r), f"trajectory at {s}"


@pytest.mark.parametrize("donate", [False, True])
def test_fused_parity_matches_check_and_arm(donate):
    """With a parity attached the fused step keeps it as
    ``check_and_arm`` does (the in-place step takes the old leaves into
    the delta before it writes them): both parities stay bitwise equal
    to each other and to a fresh build."""
    K = 1
    state_f, state_r = _tree(), _tree()
    can_f = ChecksumCanary(state_f, n_slices=K)
    can_r = ChecksumCanary(state_r, n_slices=K)
    stores = []
    for can, st in ((can_f, state_f), (can_r, state_r)):
        store = ParityStore(st)
        store.build(st)
        can.attach_parity(store)
        stores.append(store)
    ptr = stores[0].parity.data_ptr()
    fac = can_f.fuse_into_step(_raw_step_ if donate else _raw_step,
                               donate=donate)
    for s in range(3):
        state_f, _, rep = fac.step(s, state_f, BATCH)
        assert rep is None
        new_r, _ = _raw_step(state_r, BATCH)
        assert can_r.check_and_arm(s, state_r, new_r) is None
        state_r = new_r
        assert torch.equal(stores[0].parity, stores[1].parity), s
        assert stores[0].version == stores[1].version == s + 1
    fresh = ParityStore(state_f)
    fresh.build(state_f)
    assert torch.equal(fresh.parity, stores[0].parity)
    assert stores[0].parity.data_ptr() == ptr


def test_fused_host_metrics_ride_the_one_fetch():
    can = ChecksumCanary(_tree(), n_slices=1)
    fac = can.fuse_into_step(_raw_step, host_metrics=("loss",))
    state = _tree()
    tdg.STATS.reset()
    state, aux, rep = fac.step(0, state, BATCH * 3)
    assert rep is None and aux["loss"] == 24.0
    assert isinstance(aux["loss"], float)
    assert tdg.STATS.snapshot() == (1, 1)


# ---------------------------------------------------------------------------
# hot-path accounting and the rotation builds
# ---------------------------------------------------------------------------

def test_fused_steady_state_one_launch_one_sync(monkeypatch):
    calls = []
    real = tck.row_checksums
    monkeypatch.setattr(tck, "row_checksums",
                        lambda rows: calls.append(1) or real(rows))
    state = _tree()
    K = 4
    can = ChecksumCanary(state, n_slices=K)
    fac = can.fuse_into_step(_raw_step_, donate=True)
    for s in range(K):                        # lazy: one full rotation
        state, _, rep = fac.step(s, state, BATCH)
        assert rep is None
    assert fac.n_compiles == K
    ptrs = can.plan.buffer_pointers()
    n_leaves = can.plan.n_leaves        # every rotation's ring view
    assert {tuple(range(j, n_leaves, K)) + tuple(range((j + 1) % K,
                                                      n_leaves, K))
            for j in range(K)} <= set(ptrs)
    tables = [t.data_ptr() for t in can._tables]
    tdg.STATS.reset()
    calls.clear()
    n = 2 * K
    for s in range(K, K + n):
        state, _, rep = fac.step(s, state, BATCH)
        assert rep is None
    assert tdg.STATS.snapshot() == (n, n)     # 1 launch + 1 fetch a step
    assert len(calls) == n                    # 1 row_checksums a step
    assert fac.n_compiles == K                # nothing rebuilt
    for idx, p in ptrs.items():
        assert can.plan.buffer_pointer(idx) == p
    assert [t.data_ptr() for t in can._tables] == tables


def test_eager_warm_builds_all_k_without_stepping():
    state = _tree()
    K = 3
    can = ChecksumCanary(state, n_slices=K)
    fac = can.fuse_into_step(_raw_step_, donate=True, warm="eager")
    wall = fac.warm(state, BATCH)
    assert fac.n_compiles == K and wall > 0.0
    assert fac.compile_seconds > 0.0
    assert fac.warm(state, BATCH) == 0.0      # idempotent
    assert can.generation == 0                # warm ran no step
    assert _bitwise_equal(state, _tree())
    for s in range(2 * K):
        state, _, rep = fac.step(s, state, BATCH)
        assert rep is None
    assert fac.n_compiles == K


# ---------------------------------------------------------------------------
# fault path: deferred attribution
# ---------------------------------------------------------------------------

def test_fused_flip_attributed_to_exact_leaf_via_resolver():
    state = _tree()
    can = ChecksumCanary(state, n_slices=1)
    fac = can.fuse_into_step(_raw_step, donate=False)
    state, _, rep = fac.step(0, state, BATCH)
    assert rep is None
    bad = dict(state, opt={"m": flip_bit(state["opt"]["m"].clone(), 11, 4)})
    _, _, rep = fac.step(1, bad, BATCH)
    assert isinstance(rep, FaultReport) and rep.detector == "checksum"
    assert not rep.consumed
    assert rep.leaves == []                   # hot path: flag only
    assert rep.resolve() == ["opt/m"]         # fault path: exact leaf
    assert rep.leaves == ["opt/m"]
    assert rep.resolve() == ["opt/m"]         # idempotent
    # the rows the check compared against, for certification
    assert np.array_equal(can.fault_reference_digest("opt/m"),
                          tdg.host_checksum(state["opt"]["m"]))


def test_fused_donated_flip_detected_and_recovery_refresh_resumes():
    """Donated fused loop: a flip is detected in-step (``consumed``);
    after a (mock) recovery installs a clean state, ``refresh`` bumps the
    generation and the loop resumes without spurious faults — and still
    catches the next real flip."""
    state = _tree()
    K = 2
    can = ChecksumCanary(state, n_slices=K)
    fac = can.fuse_into_step(_raw_step_, donate=True)
    restore = tree_map(torch.clone, state)
    for s in range(2 * K):
        state, _, rep = fac.step(s, state, BATCH)
        assert rep is None

    def advance_to_rotation(state, s, idx):
        while s % K != idx % K:
            state, _, rep = fac.step(s, state, BATCH)
            assert rep is None
            s += 1
        return state, s

    i = can.plan.index_of("opt/m")
    state, s = advance_to_rotation(state, 2 * K, i)
    flip_bit(state["opt"]["m"], 3, 7)
    _, _, rep = fac.step(s, state, BATCH)
    assert rep is not None and rep.consumed
    assert rep.resolve() == ["opt/m"]

    g0 = can.generation
    state = restore
    can.refresh(state)
    assert can.generation > g0
    for s in range(2 * K):
        state, _, rep = fac.step(s, state, BATCH)
        assert rep is None                    # no spurious post-restore trap

    j = can.plan.index_of("tok")
    state, s = advance_to_rotation(state, 2 * K, j)
    flip_bit(state["tok"], 1, 0)
    _, _, rep = fac.step(s, state, BATCH)
    assert rep is not None and rep.resolve() == ["tok"]


def test_degenerate_rotations_more_slices_than_leaves():
    """K > n_leaves: empty rotations run the plain step (no digest, no
    generation bump) and the populated rotations still guard their
    leaf."""
    tree = {"a": torch.arange(8, dtype=torch.int32),
            "b": torch.ones(5, dtype=torch.float32)}
    K = 4
    can = ChecksumCanary(tree, n_slices=K)
    fac = can.fuse_into_step(_raw_step, donate=False)
    state = tree
    gens = []
    for s in range(2 * K):
        state, _, rep = fac.step(s, state, BATCH)
        assert rep is None
        gens.append(can.generation)
    assert gens[-1] < 2 * K                    # empty rotations: no bump
    bad = dict(state, a=flip_bit(state["a"].clone(), 2, 1))
    _, _, rep = fac.step(2 * K, bad, BATCH)
    assert rep is not None and rep.resolve() == ["a"]


def test_fuse_into_step_rejects_bad_warm_knob():
    can = ChecksumCanary(_tree(), n_slices=2)
    with pytest.raises(ValueError):
        can.fuse_into_step(_raw_step, warm="sometimes")
