"""The port's digest engine and canary against the JAX package's, bit for
bit, plus the canary's table discipline.

The geometry is the serving slice's: a paged KV pool of 85 blocks of 16
positions (4 slots, max_len 336) at smoke width, viewed as 2x85 (leaf,
block) units plus 4 per-slot ``pos`` units — 174 digest units.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import digest as jdg
from repro.serving.paged import paged_canary_view as j_view
from repro_torch.core.detect import ChecksumCanary
from repro_torch.kernels import digest as tdg
from repro_torch.serving.paged import paged_canary_view as t_view

N_BLOCKS, S = 85, 4
LEAF = (N_BLOCKS, 16, 2, 2, 32)          # (blocks, bs, count, KV, Dh)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    k, v = (rng.integers(-2**31, 2**31, LEAF, dtype=np.int64)
            .astype(np.int32).view(np.float32) for _ in range(2))
    pos = np.array([5, 0, -2**31, 2**31 - 1], np.int32)
    return k, v, pos


def _views(k, v, pos):
    jv = j_view({"groups": [[{"k": jnp.asarray(k), "v": jnp.asarray(v)}]]},
                jnp.asarray(pos), N_BLOCKS, S)
    tv = t_view({"groups": [[{"k": torch.from_numpy(k.copy()),
                              "v": torch.from_numpy(v.copy())}]]},
                torch.from_numpy(pos.copy()), N_BLOCKS, S)
    return jv, tv


@pytest.fixture(scope="module")
def views():
    return _views(*_state())


def test_plan_keys_and_layout_match_reference(views):
    jv, tv = views
    jp, tp = jdg.plan_for(jv), tdg.plan_for(tv)
    assert tp.keys == jp.keys
    assert tp.n_leaves == 174
    assert tp.keys[0] == "block0000/groups/0/0/k"
    assert tp.keys[-1] == "slot003/pos"
    assert [s.n_rows for s in tp.specs] == [s.n_rows for s in jp.specs]
    assert tp.n_rows == jp.n_rows
    assert tdg.plan_for(tv) is tp            # cached per structure


def test_digest_table_matches_reference(views):
    jv, tv = views
    theirs = np.asarray(jdg.plan_for(jv).digest_table(jv))
    ours = tdg.plan_for(tv).digest_table(tv)
    assert ours.dtype == torch.int32 and ours.shape == (174, 2)
    assert np.array_equal(ours.numpy(), theirs)
    # and each row is the host digest of that leaf's bytes
    tp = tdg.plan_for(tv)
    for i in (0, 1, 100, 173):
        leaf = tp.leaves(tv)[i].numpy()
        assert np.array_equal(ours[i].numpy(), tdg.host_checksum(leaf))


def test_digest_subset_matches_reference(views):
    jv, tv = views
    idx = list(range(1, 174, 4)) + [172, 173]
    theirs = np.asarray(jdg.plan_for(jv).digest_subset(jv, idx))
    assert np.array_equal(tdg.plan_for(tv).digest_subset(tv, idx).numpy(),
                          theirs)


def test_check_arm_matches_reference_on_a_flip():
    """One rotation's check+arm on two state versions: the check slice
    reads the old bytes (one flipped word), the arm slice the new ones."""
    k, v, pos = _state(1)
    jv, tv = _views(k, v, pos)
    jp, tp = jdg.plan_for(jv), tdg.plan_for(tv)
    ref = tp.digest_table(tv)
    chk, arm = list(range(0, 174, 4)), list(range(1, 174, 4))
    k2 = k.copy()
    k2.view(np.int32)[6, 3, 1, 0, 7] ^= 1 << 13     # block 6, leaf k
    jv2, tv2 = _views(k2, v, pos)
    jfn, junion = jdg.check_arm_subcomputation(jp, chk, arm)
    core, union = tdg.check_arm_subcomputation(tp, chk, arm)
    assert union == junion
    jl = jp.leaves(jv2)
    _, jflag, jbad, jwrite = jfn(
        jp.take_buffer(junion), [jl[i] for i in chk] + [jl[i] for i in arm],
        jnp.asarray(ref.numpy()), jnp.asarray(ref.numpy()))
    tl2, tl = tp.leaves(tv2), tp.leaves(tv)
    buf = tp.take_buffer(union)
    ptr = buf.data_ptr()
    write = ref.clone()
    core.pack_check(buf, [tl2[i] for i in chk])
    core.pack_arm(buf, [tl[i] for i in arm])
    flag, bad = core.finish(buf, ref, write)
    assert bool(flag) and bool(jflag)
    assert np.array_equal(bad.numpy(), np.asarray(jbad))
    assert [tp.keys[i] for i, b in zip(chk, bad.numpy()) if b] == \
        ["block0006/groups/0/0/k"]
    # armed rows: the new (unflipped) bytes, identical to the reference's
    assert np.array_equal(write.numpy(), np.asarray(jwrite))
    assert buf.data_ptr() == ptr == tp.buffer_pointer(union)


def test_digest_counts_launches_and_syncs(views):
    _, tv = views
    tp = tdg.plan_for(tv)
    tdg.STATS.reset()
    table = tp.digest_table(tv)
    assert tdg.STATS.snapshot() == (1, 0)
    host = tdg.fetch(table)
    assert tdg.STATS.snapshot() == (1, 1) and host.shape == (174, 2)
    tdg.STATS.reset()
    tp.digest_subset(tv, [tp.index_of("slot000/pos")])
    assert tdg.STATS.snapshot() == (1, 0)


def test_plan_rejects_another_structure(views):
    _, tv = views
    tp = tdg.plan_for(tv)
    bad = dict(tv)
    bad["slot009"] = bad.pop("slot003")
    with pytest.raises(ValueError):
        tp.leaves(bad)


def _canary_tree():
    return {"a": torch.arange(300, dtype=torch.float32),
            "b": torch.arange(7, dtype=torch.int32),
            "c": torch.ones(130)}


def test_canary_full_refresh_bumps_generation():
    tree = _canary_tree()
    can = ChecksumCanary(tree, n_slices=2)
    g0 = can.generation
    tree["a"][3] = 42.0
    can.refresh(tree)
    assert can.generation == g0 + 1
    assert np.array_equal(tdg.fetch(can.reference),
                          tdg.fetch(can.plan.digest_table(tree)))


def test_canary_partial_refresh_patches_both_generations_no_bump():
    tree = _canary_tree()
    can = ChecksumCanary(tree, n_slices=2)
    read, write = can.begin_update()
    stale_b = read[1].clone()
    tree["a"][0] = -1.0
    tree["b"][2] = 9
    can.refresh(tree, keys=["a"])
    assert can.generation == 0
    fresh = can.plan.digest_table(tree)
    for t in can.begin_update():
        assert torch.equal(t[0], fresh[0])     # patched in both tables
        assert torch.equal(t[1], stale_b)      # other rows untouched
    can.commit_update(write)
    assert can.generation == 1


def test_canary_attribution_fetches_the_mask_once():
    tree = _canary_tree()
    can = ChecksumCanary(tree, n_slices=1)
    tdg.STATS.reset()
    leaves = can._attribute([0, 1, 2], torch.tensor([False, True, True]))
    assert leaves == ["b", "c"]
    assert tdg.STATS.syncs == 1


def test_host_checksum_rejects_unported_dtypes():
    with pytest.raises(TypeError):
        tdg.host_checksum(np.zeros(3, np.complex64))
