"""The digest plan's packing ring (``kernels/digest.py``: ``PackRing``):
one allocation for a K-slice canary's rotating slices, which every taker
of a rotation's packing buffer shares — the eager canary's
``check_and_arm`` (a check slice and the next arm slice, two neighbouring
ring slots), the donated pair's ``arm_current`` / ``check`` (one slot)
and the fused step (either).

Held here: at K = 1, 2 and 4, on the iterpro-100m smoke train state and
on the same state with int8 AdamW moments (1-byte ``/q`` leaves), every
rotation's check and armed tables out of the ring equal those of the
rotation's own union buffer (the layout before the ring) and the JAX
package's digests, bit for bit, with the rotations run in turn over
changing state versions so that neighbours overwrite the slots they
share; the ring's size; every pointer kept across steps; and the K=4
fused storms equal to their clean runs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import digest as jdg
from repro_torch.configs import get_config
from repro_torch.core.detect import ChecksumCanary
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import digest as tdg
from repro_torch.kernels.checksum import LANES, TILE_ROWS
from repro_torch.launch.train import train
from repro_torch.train.loop import make_train_state
from repro_torch.train.loop import make_train_step
from repro_torch.tree import flatten_with_path, leaf_key, tree_map

B, SEQ = 2, 16


def _cfg(tree):
    c = get_config("iterpro-100m").smoke()
    if tree == "int8":
        c = dataclasses.replace(c, train=dataclasses.replace(
            c.train, moment_dtype="int8"))
    return c


def _versions(tree, n):
    """``n`` successive train states (functional steps) of the smoke."""
    cfg = _cfg(tree)
    pipe = TokenPipeline(cfg.model.vocab_size, SEQ, B, seed=0)
    step = make_train_step(cfg, global_batch=B)
    state = make_train_state(cfg, 0, global_batch=B)
    out = [state]
    for s in range(n - 1):
        state, _ = step(state, {k: torch.from_numpy(np.asarray(v))
                                for k, v in pipe.batch_at(s).items()})
        out.append(state)
    return out


def _jax_tree(state):
    return {leaf_key(p): jnp.asarray(t.numpy())
            for p, t in flatten_with_path(state)}


def _jax_subset(state, idx):
    """The JAX package's digests of leaves ``idx`` (the port's plan order,
    which is the reference's: sorted leaf paths)."""
    jt = _jax_tree(state)
    plan = jdg.plan_for(jt)
    return np.asarray(plan.digest_subset(jt, list(idx)))


@pytest.fixture(scope="module", params=["f32", "int8"])
def states(request):
    vs = _versions(request.param, 3)
    if request.param == "int8":
        flat = {leaf_key(p): t for p, t in flatten_with_path(vs[0])}
        assert any(t.dtype == torch.int8 for t in flat.values())
    return vs


@pytest.mark.parametrize("K", [1, 2, 4])
def test_ring_tables_match_union_buffers_and_reference(states, K):
    """Each rotation r (check slice r of version s, arm slice r+1 of
    version s+1), run in turn for 2K steps over 3 rotating versions:
    the ring core's flag, mismatch mask and armed rows equal the
    union-buffer core's and the JAX digests', bitwise (a check of a
    later version against version 0's table fires on the leaves that
    changed)."""
    plan = tdg.plan_for(states[0])
    ref = plan.digest_table(states[0])
    fired = 0
    for s in range(2 * K):
        a, b = states[s % 3], states[(s + 1) % 3]
        chk = list(range(s % K, plan.n_leaves, K))
        arm = list(range((s + 1) % K, plan.n_leaves, K))
        out = []
        for n_slices in (K, 0):
            core, union = tdg.check_arm_subcomputation(plan, chk, arm,
                                                       n_slices=n_slices)
            buf = core.buffer()
            write = ref.clone()
            la, lb = plan.leaves(a), plan.leaves(b)
            core.pack_check(buf, [la[i] for i in chk])
            core.pack_arm(buf, [lb[i] for i in arm])
            flag, bad = core.finish(buf, ref, write)
            out.append((bool(flag), bad.clone(), write[arm].clone()))
        (f1, bad1, w1), (f0, bad0, w0) = out
        assert f1 == f0 and torch.equal(bad1, bad0) and torch.equal(w1, w0)
        assert np.array_equal(w1.numpy(), _jax_subset(b, arm))
        theirs = _jax_subset(a, chk)
        assert np.array_equal(
            bad1.numpy(), (theirs != ref[chk].numpy()).any(axis=1))
        assert f1 == bool((theirs != ref[chk].numpy()).any())
        fired += f1
    assert fired > 0
    # the ring core's layout pads the check slice to whole tiles
    core, _ = tdg.check_arm_subcomputation(plan, chk, arm, n_slices=K)
    nc_rows = sum(plan.specs[i].n_rows for i in chk)
    assert core.layout.starts[len(chk)] == \
        -(-nc_rows // TILE_ROWS) * TILE_ROWS * LANES


@pytest.mark.parametrize("K", [1, 2, 4])
def test_ring_holds_each_word_at_most_k_plus_1_over_k(states, K):
    """The ring is the K slices, each padded to whole tiles, plus the
    smallest once more: (K+1)/K of the slices' words at most, so with
    every taker on the plan (the eager canary, the donated pair and the
    fused step) its packing buffers are the ring alone."""
    state = tree_map(torch.clone, states[0])
    plan = tdg.plan_for(state)
    slots = [plan.layout(range(j, plan.n_leaves, K)).padded_rows * LANES
             for j in range(K)]
    ring = plan.ring(K)
    assert ring.buf.numel() == sum(slots) + min(slots)
    assert ring.buf.numel() * K <= sum(slots) * (K + 1)
    before = dict(plan._pack_bufs)
    can = ChecksumCanary(state, n_slices=K)
    for s in range(K):
        can.check_and_arm(s, state)
        can.arm_current(s, state)
        can.check(s, state)
    assert plan._pack_bufs == before        # no union buffer taken
    lo, hi = ring.buf.data_ptr(), ring.buf.data_ptr() + 4 * ring.buf.numel()
    sl = [tuple(range(j, plan.n_leaves, K)) for j in range(K)]
    taken = sl + [sl[j] + sl[(j + 1) % K] for j in range(K)]
    for idx in taken:
        assert lo <= plan.buffer_pointer(idx) < hi


def test_ring_pointers_stable_across_steps():
    """Eager check_and_arm and the fused donated step at K=4 on one
    plan: after a warm rotation every packing pointer and both tables
    stay put for 2K more steps."""
    cfg = _cfg("f32")
    pipe = TokenPipeline(cfg.model.vocab_size, SEQ, B, seed=0)
    batch = lambda s: {k: torch.from_numpy(np.asarray(v))
                       for k, v in pipe.batch_at(s).items()}
    K = 4
    state = make_train_state(cfg, 0, global_batch=B)
    step = make_train_step(cfg, global_batch=B, donate=True)
    can = ChecksumCanary(state, n_slices=K)
    fac = can.fuse_into_step(step, donate=True)
    for s in range(K):
        state, _, rep = fac.step(s, state, batch(s))
        assert rep is None
        can.check(s + 1, state)
    ptrs = can.plan.buffer_pointers()
    tables = [t.data_ptr() for t in can._tables]
    for s in range(K, 3 * K):
        state, _, rep = fac.step(s, state, batch(s))
        assert rep is None
    assert can.plan.buffer_pointers() == ptrs
    assert [t.data_ptr() for t in can._tables] == tables


@pytest.mark.parametrize("mode", [dict(fused_detect=True),
                                  dict(donate=True, fused_detect=True)],
                         ids=["fused", "donate-fused"])
def test_k4_fused_storm_equals_clean(mode):
    """K=4 fused runs (rotations packing into the ring) under flips in
    the slice checked at their step: detected == injected == recovered,
    the final state bitwise the clean run's."""
    cfg = _cfg("f32")
    kw = dict(steps=10, global_batch=B, seq_len=SEQ, snapshot_interval=4,
              canary_slices=4, verbose=False, device="cpu",
              return_state=True, **mode)
    _, clean = train(cfg, **kw)
    storm, state = train(cfg, inject_every=3, inject_armed_only=True, **kw)
    f = storm["faults_injected"]
    assert f > 0 and storm["faults_detected"] == f
    assert storm["faults_recovered"] == f
    fa = {leaf_key(p): t for p, t in flatten_with_path(state)}
    fb = {leaf_key(p): t for p, t in flatten_with_path(clean)}
    assert fa.keys() == fb.keys()
    assert all(torch.equal(fa[k].view(-1).view(torch.uint8),
                           fb[k].view(-1).view(torch.uint8)) for k in fa)
