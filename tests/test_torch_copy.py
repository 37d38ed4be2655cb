"""The copy engine behind ``pack_rows`` and ``gather_blocks``
(``csrc/copy.cuh``), held on the CPU.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
bitwise against their plain versions.  Here the host-side schedule
(``checksum.pack_schedule``, ``checksum.chunk_count``) is held to its
contract, and a numpy replay of the kernels' chunk lookups (chunk →
(leaf, byte range) by binary search over ``first_chunk``; chunk →
(pair, byte offset) by division) is run over fake device memory and
compared with ``ref.pack_rows_ref`` / ``ref.gather_blocks_ref`` and with
the reference's Pallas kernels (interpret mode).
"""

import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.kernels import checksum as jck
from repro.kernels import paged_kv as jpk
from repro_torch.kernels import _build
from repro_torch.kernels import checksum as tck
from repro_torch.kernels import ref as tref

BASE = 1 << 20          # fake device address of word 0 of the fake memory
CHUNK = tck.CHUNK_BYTES
Q = CHUNK // 4          # words per chunk


def _bits(rng, n):
    return rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(
        np.int32)


# -- numpy replay of copy.cuh ------------------------------------------------

def chunk_span(k, n):
    """``copy_engine::chunk_span``: byte range of chunk ``k`` of a run of
    ``n`` bytes (arrays broadcast)."""
    k, n = np.asarray(k, np.int64), np.asarray(n, np.int64)
    body = n & ~15
    off = k * CHUNK
    in_body = off < body
    length = np.where(in_body, np.minimum(CHUNK, body - off), n - body)
    return np.where(in_body, off, body), length


def bulk_ok(src, dst, length):
    """``copy_engine::bulk_ok`` (``src`` < 0 stands for a null source)."""
    return (src >= 0) & (((src | dst | length) & 15) == 0)


def pack_chunks(table, n_chunks, buf_ptr):
    """The ``pack_rows`` kernel's lookup for every chunk: (leaf, byte
    offset in the leaf, length, source address, destination address)."""
    c = np.arange(n_chunks, dtype=np.int64)
    leaf = np.searchsorted(table[:, 3], c, side="right") - 1
    off, length = chunk_span(c - table[leaf, 3], 4 * table[leaf, 1])
    src = table[leaf, 0] + off
    dst = buf_ptr + 4 * table[leaf, 2] + off
    return leaf, off, length, src, dst


def pack_chunks_wide(table, n_chunks, buf_ptr):
    """``pack_chunks`` with the element size of each leaf: a 2-byte
    leaf's chunk reads from half its destination offset and widens."""
    leaf, off, length, _, dst = pack_chunks(table, n_chunks, buf_ptr)
    widen = table[leaf, 4] == 2
    src = table[leaf, 0] + np.where(widen, off // 2, off)
    return leaf, off, length, src, dst, widen


def replay_wide(mem, src, dst, length, widen):
    """``replay`` where a widening chunk zero-extends ``length / 4``
    2-byte source values into the destination words."""
    half = mem.view(np.uint16)
    for s, d, n, w in zip(src.tolist(), dst.tolist(), length.tolist(),
                          widen.tolist()):
        dw = (d - BASE) // 4
        if w:
            h = (s - BASE) // 2
            mem[dw:dw + n // 4] = half[h:h + n // 4].astype(np.int32)
        else:
            sw = (s - BASE) // 4
            mem[dw:dw + n // 4] = mem[sw:sw + n // 4]


def gather_chunks(bt, n_blocks, block_bytes, pool_ptr, out_ptr):
    """The ``gather_blocks`` kernel's lookup for every chunk: (pair, byte
    offset in the block, length, source address or -1, destination)."""
    per_pair = tck.chunk_count(block_bytes)
    c = np.arange(bt.size * per_pair, dtype=np.int64)
    pair = c // per_pair
    off, length = chunk_span(c - pair * per_pair, block_bytes)
    b = bt.reshape(-1)[pair].astype(np.int64)
    live = (b >= 0) & (b < n_blocks)
    src = np.where(live, pool_ptr + b * block_bytes + off, -1)
    return pair, off, length, src, out_ptr + pair * block_bytes + off


def replay(mem, src, dst, length):
    """Run the chunks over fake memory ``mem`` (int32 words at address
    ``BASE``), bulk or word by word alike: a copy, or zeros where the
    source is null."""
    for s, d, n in zip(src.tolist(), dst.tolist(), length.tolist()):
        w, dw = (s - BASE) // 4, (d - BASE) // 4
        mem[dw:dw + n // 4] = mem[w:w + n // 4] if s >= 0 else 0


def _layout(sizes, gaps):
    """Row-aligned starts (the digest layout, with extra gap rows)."""
    starts, r = [], 0
    for n, g in zip(sizes, gaps):
        r += g
        starts.append(r * tck.LANES)
        r += max(1, -(-n // tck.LANES))
    return starts, r * tck.LANES


# -- chunk_count -------------------------------------------------------------

@pytest.mark.parametrize("whole,extra,body_chunks,tail", [
    # n_words = whole * Q + extra (Q words per chunk)
    (0, 0, 0, 0), (0, 1, 0, 1), (0, 2, 0, 1), (0, 3, 0, 1), (0, 4, 1, 0),
    (0, 5, 1, 1), (0, 21, 1, 1), (0, Q - 1, 1, 1), (0, Q, 1, 0),
    (1, 0, 1, 0), (1, 1, 1, 1), (1, 4, 2, 0), (1, Q - 1, 2, 1),
    (2, 2, 2, 1), (3, 3, 3, 1), (5, 4, 6, 0)])
def test_chunk_count_splits_body_and_tail(whole, extra, body_chunks, tail):
    n = 4 * (whole * Q + extra)
    assert tck.chunk_count(n) == body_chunks + tail
    off, length = chunk_span(np.arange(body_chunks + tail), n)
    assert length.sum() == n and np.all(length > 0)
    assert np.all(off[:-1] + length[:-1] == off[1:])
    assert np.all(length[:body_chunks] % 16 == 0)
    assert np.all(length <= CHUNK)


# -- the pack schedule -------------------------------------------------------

_leaf = st.tuples(st.one_of(st.integers(0, 40),           # words
                            st.integers(0, 3 * Q + 40)),
                  st.integers(0, 3),         # source misalignment (words)
                  st.integers(0, 2))         # gap rows before its start


@settings(max_examples=60, deadline=None)
@given(leaves=st.lists(_leaf, min_size=1, max_size=12),
       src_base=st.integers(0, 1 << 12))
def test_pack_schedule_covers_every_word_once(leaves, src_base):
    sizes = [n for n, _, _ in leaves]
    starts, _ = _layout(sizes, [g for _, _, g in leaves])
    # fake, non-overlapping sources: 16-byte aligned plus the misalignment
    ptrs, p = [], BASE + 16 * src_base
    for n, mis, _ in leaves:
        ptrs.append(p + 4 * mis)
        p += 16 * (-(-(4 * n + 16) // 16))
    table, n_chunks = tck.pack_schedule(ptrs, sizes, starts)
    assert table.dtype == np.int64 and table.shape == (len(leaves), 5)
    assert n_chunks == sum(tck.chunk_count(4 * n) for n in sizes)
    assert np.array_equal(table[:, :3], np.array(
        [ptrs, sizes, starts], np.int64).T)
    leaf, off, length, src, dst = pack_chunks(table, n_chunks, buf_ptr=BASE)
    # no chunk crosses a leaf; none is empty or longer than the chunk size
    n_bytes = 4 * np.asarray(sizes, np.int64)
    assert np.all((length > 0) & (length <= CHUNK))
    assert np.all((off >= 0) & (off + length <= n_bytes[leaf]))
    # every word of every leaf is covered exactly once
    for i, n in enumerate(sizes):
        mine = leaf == i
        cover = np.zeros(n + 1, np.int64)
        np.add.at(cover, off[mine] // 4, 1)
        np.add.at(cover, (off[mine] + length[mine]) // 4, -1)
        assert np.all(np.cumsum(cover)[:n] == 1), (i, n)
    # bulk path iff source, destination and size are 16-byte multiples:
    # an aligned leaf moves all but its < 16-byte tail in bulk, a
    # misaligned one moves nothing in bulk
    bulk = bulk_ok(src, dst, length)
    assert np.array_equal(bulk, ((src % 16 == 0) & (dst % 16 == 0)
                                 & (length % 16 == 0)))
    for i, (n, mis, _) in enumerate(leaves):
        words = length[(leaf == i) & ~bulk].sum()
        assert words == (4 * n if mis else 4 * n % 16)


def test_pack_schedule_of_no_leaves_and_empty_leaves():
    table, n = tck.pack_schedule([], [], [])
    assert table.shape == (0, 5) and n == 0
    table, n = tck.pack_schedule([BASE, BASE, BASE + 64], [0, 0, 5],
                                 [0, 128, 256])
    assert n == 2 and table[:, 3].tolist() == [0, 0, 0]
    leaf, *_ = pack_chunks(table, n, BASE)
    assert leaf.tolist() == [2, 2]       # zero-word leaves are never picked


@pytest.mark.parametrize("seed,mis", [
    (0, [0, 1, 2, 3, 0, 0, 1, 0, 2]),      # unaligned short leaves
    (1, [3, 0, 0, 1, 0, 2, 0, 3, 0]),      # unaligned chunked leaves
    (2, [0] * 9),                          # every source aligned
])
def test_pack_replay_equals_plain_and_pallas(seed, mis):
    """The kernel's chunk → (leaf, range) lookup, replayed over fake
    memory, packs what ``pack_rows_ref`` and the Pallas kernel pack:
    leaves of 1, 3 and 5 words, unaligned sources, leaves with chunk
    boundaries inside them, a zero-word leaf and int32 extremes."""
    rng = np.random.default_rng(seed)
    sizes = [1, 3, 5, 129, 0, 2 * Q + 7, Q, 3 * Q + 1, 21]
    starts, total = _layout(sizes, [1, 0, 2, 0, 0, 1, 0, 0, 1])
    # fake memory: the packing buffer first, then the leaves
    mem_words = total + sum(n + 8 for n in sizes) + 8
    mem = np.zeros(mem_words, np.int32)
    mem[:total] = _bits(rng, total)          # other words stay untouched
    flats, ptrs, w = [], [], total
    for n, m in zip(sizes, mis):
        w = -(-w // 4) * 4 + m
        mem[w:w + n] = _bits(rng, n)
        flats.append(mem[w:w + n].copy())
        ptrs.append(BASE + 4 * w)
        w += n
    mem[ptrs[0] // 4 - BASE // 4] = 2**31 - 1
    flats[0][0] = 2**31 - 1
    before = mem[:total].copy()
    table, n_chunks = tck.pack_schedule(ptrs, sizes, starts)
    _, _, length, src, dst = pack_chunks(table, n_chunks, BASE)
    assert np.any(bulk_ok(src, dst, length))
    assert np.any(~bulk_ok(src, dst, length))
    replay(mem, src, dst, length)
    want = tref.pack_rows_ref(torch.from_numpy(before.copy()),
                              [torch.from_numpy(f) for f in flats], starts)
    assert np.array_equal(mem[:total], want.numpy())
    theirs = np.asarray(jck.pack_rows(
        jnp.asarray(before), [jnp.asarray(f) for f in flats if f.size],
        [s for s, f in zip(starts, flats) if f.size], interpret=True))
    assert np.array_equal(mem[:total], theirs)


_wide_leaf = st.tuples(st.one_of(st.integers(0, 40),
                                 st.integers(0, 2 * Q + 40)),
                       st.sampled_from([2, 4]),      # element bytes
                       st.integers(0, 7),            # misalignment (2 B)
                       st.integers(0, 2))            # gap rows


@settings(max_examples=60, deadline=None)
@given(leaves=st.lists(_wide_leaf, min_size=1, max_size=10),
       seed=st.integers(0, 2**16))
def test_widened_pack_schedule_covers_every_word_once(leaves, seed):
    """Mixed 2- and 4-byte leaves, at any 2-byte (4-byte) source offset:
    the schedule's chunks, replayed over fake memory with the kernel's
    widening (``copy.cuh:widen_path``), write every destination word of
    every leaf exactly once, never a chunk across a leaf, and the buffer
    equals ``pack_rows_ref``: each
    leaf's ``to_i32`` words, the 2-byte values zero-extended, every other
    word untouched."""
    rng = np.random.default_rng(seed)
    sizes = [n for n, *_ in leaves]
    starts, total = _layout(sizes, [g for *_, g in leaves])
    src_bytes = sum(e * n + 32 for n, e, _, _ in leaves)
    mem = np.zeros(total + src_bytes // 4 + 8, np.int32)
    mem[:total] = _bits(rng, total)
    ptrs, tensors, at = [], [], 4 * total      # byte offset in mem
    for n, e, mis, _ in leaves:
        at = -(-at // 16) * 16 + (2 * mis if e == 2 else 4 * (mis % 4))
        raw = rng.integers(0, 256, size=e * n, dtype=np.uint8)
        mem.view(np.uint8)[at:at + e * n] = raw
        dt = np.uint16 if e == 2 else np.int32
        t = torch.from_numpy(raw.view(dt).astype(
            np.int16 if e == 2 else np.int32))
        tensors.append(t.view(torch.bfloat16) if e == 2 else
                       t.view(torch.float32))
        ptrs.append(BASE + at)
        at += e * n
    table, n_chunks = tck.pack_schedule(ptrs, sizes, starts,
                                        [e for _, e, _, _ in leaves])
    assert table.shape == (len(leaves), 5)
    assert table[:, 4].tolist() == [e for _, e, _, _ in leaves]
    assert n_chunks == sum(tck.chunk_count(4 * n) for n in sizes)
    leaf, off, length, src, dst, widen = pack_chunks_wide(table, n_chunks,
                                                          BASE)
    assert np.all((length > 0) & (length <= CHUNK) & (length % 4 == 0))
    assert np.all(off + length <= 4 * np.asarray(sizes, np.int64)[leaf])
    for i, n in enumerate(sizes):
        mine = leaf == i
        cover = np.zeros(n + 1, np.int64)
        np.add.at(cover, off[mine] // 4, 1)
        np.add.at(cover, (off[mine] + length[mine]) // 4, -1)
        assert np.all(np.cumsum(cover)[:n] == 1), (i, n)
    before = mem[:total].copy()
    replay_wide(mem, src, dst, length, widen)
    want = tref.pack_rows_ref(torch.from_numpy(before.copy()), tensors,
                              starts)
    assert np.array_equal(mem[:total], want.numpy())


def test_pack_rows_takes_2_byte_leaves_as_to_i32():
    """On the CPU the wrapper packs bf16 and f32 leaves as they are: the
    words are ``to_i32`` of each, the bf16 values zero-extended."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal(131).astype(np.float32))
    b = a[:77].to(torch.bfloat16)
    b.view(torch.int16)[:2] = torch.tensor([-1, -32768], dtype=torch.int16)
    buf = torch.full((4 * tck.LANES,), 7, dtype=torch.int32)
    tck.pack_rows(buf, [b, a], [0, 2 * tck.LANES])
    assert torch.equal(buf[:77], tref.to_i32(b))
    assert buf[:2].tolist() == [0xFFFF, 0x8000]
    assert torch.equal(buf[77:2 * tck.LANES], torch.full((179,), 7,
                                                         dtype=torch.int32))
    assert torch.equal(buf[2 * tck.LANES:2 * tck.LANES + 131], tref.to_i32(a))


def test_digest_packs_the_leaves_themselves(monkeypatch):
    """The digest hands ``pack_rows`` the state's own tensors (no
    ``to_i32`` temporary of a bf16 leaf), so the schedule records their
    ``data_ptr`` and element size, and a captured graph reads only
    storage that lives as long as the state."""
    from repro_torch.kernels import digest as tdg
    state = {"w": torch.randn(300).to(torch.bfloat16),
             "m": torch.randn(300), "t": torch.zeros((), dtype=torch.int32)}
    plan = tdg.plan_for(state)
    seen = []
    real = tck.pack_rows

    def spy(buf, leaves, starts, *, desc=None):
        seen.append(list(leaves))
        return real(buf, leaves, starts, desc=desc)
    monkeypatch.setattr(tck, "pack_rows", spy)
    table = plan.digest_table(state)
    assert [x.data_ptr() for x in seen[0]] == \
        [x.data_ptr() for x in plan.leaves(state)]
    assert [x.dtype for x in seen[0]] == [torch.float32, torch.int32,
                                          torch.bfloat16]
    desc = tck.pack_descriptors(seen[0], plan.layout((0, 1, 2)).starts,
                                "cpu")
    assert desc.table[:, 0].tolist() == [x.data_ptr() for x in seen[0]]
    assert desc.table[:, 4].tolist() == [4, 4, 2]
    ref = [tdg.host_checksum(x) for x in plan.leaves(state)]
    assert np.array_equal(table.numpy(), np.stack(ref))


def test_large_digests_split_into_bounded_transient_buffers(monkeypatch):
    """An off-hot-path digest larger than ``TRANSIENT_WORDS`` packs runs
    of leaves into bounded transient buffers (a larger leaf alone): the
    table is the unsplit one's, bit for bit, and every leaf's host
    digest."""
    from repro_torch.kernels import digest as tdg
    g = torch.Generator().manual_seed(0)
    state = {f"l{i:02d}": torch.randn(n, generator=g).to(dt)
             for i, (n, dt) in enumerate([(700, torch.float32),
                                          (3, torch.bfloat16),
                                          (2000, torch.bfloat16),
                                          (129, torch.float32),
                                          (1, torch.int32),
                                          (400, torch.float32)])}
    plan = tdg.DigestPlan(tuple(sorted(state)),
                          tuple(x.numel() for _, x in sorted(state.items())),
                          torch.device("cpu"))
    whole = plan.digest_table(state)
    monkeypatch.setattr(tdg, "TRANSIENT_WORDS", 4 * tck.LANES)
    idx = tuple(range(plan.n_leaves))
    assert plan._groups(idx) == [(0, 1), (1, 2), (2, 3), (3, 5), (5, 6)]
    split = plan.digest_table(state)
    assert torch.equal(split, whole)
    assert np.array_equal(split.numpy(), np.stack(
        [tdg.host_checksum(x) for _, x in sorted(state.items())]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_host_digest_across_its_chunks(dtype):
    """The host digest, taken ``HOST_CHUNK`` words at a time, equals the
    plain digest of the whole leaf (weights continue across chunks)."""
    from repro_torch.kernels import digest as tdg
    n = 3 * tdg.HOST_CHUNK + 7
    x = torch.randn(n, generator=torch.Generator().manual_seed(1)) * 1e3
    x = x.to(dtype)
    assert np.array_equal(tdg.host_checksum(x),
                          tref.checksum_ref(x).numpy())


def test_pack_descriptors_upload_the_schedule():
    flats = [torch.arange(n, dtype=torch.int32) for n in (3, 5000, 1)]
    starts = [0, 128, 128 * 41]
    desc = tck.pack_descriptors(flats, starts, "cpu")
    table, n = tck.pack_schedule([f.data_ptr() for f in flats],
                                 [3, 5000, 1], starts)
    assert desc.n_chunks == n == 3       # one chunk a leaf
    assert desc.table.dtype == torch.int64
    assert np.array_equal(desc.table.numpy(), table)


# -- the gather ---------------------------------------------------------------

@pytest.mark.parametrize("pool_shape,S,mb", [
    ((5, 3, 7), 2, 2),                     # 21-word blocks
    ((6, 16, 12, 4, 8), 3, 4),             # 24,576 B: one chunk a block
    ((6, 16, 12, 4, 64), 3, 4),            # 196,608 B (serving): 6 chunks
    ((9, 2, 2, 2049), 2, 3),               # 32,784 B: 32 KiB + 16 B
    ((7, 8195), 3, 2),                     # 32,780 B: 32 KiB + 12-B tail
    ((50, 4), 300, 220),                   # 66,000 pairs of 4-word blocks
])
def test_gather_replay_equals_plain(pool_shape, S, mb):
    """The kernel's chunk → (pair, offset) lookup, replayed over fake
    memory, gathers what ``gather_blocks_ref`` gathers; table entries of
    0 read the scratch block, entries outside the pool give zeros."""
    rng = np.random.default_rng(sum(pool_shape) + S * mb)
    n_blocks = pool_shape[0]
    bw = int(np.prod(pool_shape[1:]))
    pool = _bits(rng, n_blocks * bw)
    bt = rng.integers(0, n_blocks, size=(S, mb)).astype(np.int32)
    bt[0, -1] = 0
    bt[-1, 0] = n_blocks                   # out of the pool: zeros
    out_w = -(-(n_blocks * bw) // 4) * 4
    mem = np.zeros(out_w + S * mb * bw, np.int32)
    mem[:n_blocks * bw] = pool
    mem[out_w:] = _bits(rng, S * mb * bw)  # torch.empty: any bits
    _, _, length, src, dst = gather_chunks(bt, n_blocks, 4 * bw,
                                           BASE, BASE + 4 * out_w)
    assert len(length) == S * mb * tck.chunk_count(4 * bw)
    replay(mem, src, dst, length)
    live = np.where(bt < n_blocks, bt, 0)
    want = tref.gather_blocks_ref(
        torch.from_numpy(pool).view(pool_shape),
        torch.from_numpy(live)).numpy().reshape(S * mb, bw)
    want[(bt >= n_blocks).reshape(-1)] = 0
    assert np.array_equal(mem[out_w:].reshape(S * mb, bw), want)
    if S * mb <= 16:
        theirs = np.asarray(jpk.gather_blocks(
            jnp.asarray(pool.view(np.float32).reshape(pool_shape)),
            jnp.asarray(live), interpret=True)).view(np.int32)
        theirs = theirs.reshape(S * mb, bw).copy()
        theirs[(bt >= n_blocks).reshape(-1)] = 0
        assert np.array_equal(mem[out_w:].reshape(S * mb, bw), theirs)


def test_gather_replay_of_a_bf16_pool():
    """A bf16 KV pool (gemma3's (n_blocks, 16, count, 1, 256) layout, cut
    down) gathers as whole 4-byte words: the wrapper hands the kernel
    the block's bytes / 4 words, and the replay of those chunks equals
    ``gather_blocks_ref`` bit for bit."""
    rng = np.random.default_rng(5)
    shape = (7, 16, 2, 1, 8)
    half = rng.integers(0, 2**16, size=int(np.prod(shape)),
                        dtype=np.uint16)
    pool = torch.from_numpy(half.view(np.int16)).view(torch.bfloat16)
    pool = pool.view(shape)
    bt = rng.integers(0, shape[0], size=(3, 4)).astype(np.int32)
    block_bytes = int(np.prod(shape[1:])) * 2
    assert block_bytes % 4 == 0
    out_w = half.size // 2
    mem = np.zeros(out_w + bt.size * block_bytes // 4, np.int32)
    mem[:out_w] = half.view(np.int32)
    _, _, length, src, dst = gather_chunks(bt, shape[0], block_bytes,
                                           BASE, BASE + 4 * out_w)
    replay(mem, src, dst, length)
    want = tref.gather_blocks_ref(pool, torch.from_numpy(bt))
    assert np.array_equal(mem[out_w:].view(np.int16),
                          want.view(torch.int16).numpy().reshape(-1))


# -- the sources and their build ----------------------------------------------

def _constant(name, file):
    text = (_build.CSRC / file).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


@pytest.mark.parametrize("name,file,value", [
    ("kChunk", "copy.cuh", tck.CHUNK_BYTES),
    ("kMaxLeaves", "checksum.cu", tck.MAX_PACK_LEAVES)])
def test_kernel_constants_match_the_schedule(name, file, value):
    """The schedule is built with the kernels' own chunk size, and the
    wrapper refuses what the kernel cannot stage."""
    assert _constant(name, file) == value
    for src in ("checksum.cu", "paged_kv.cu"):
        assert '#include "copy.cuh"' in (_build.CSRC / src).read_text()


def test_pack_shared_memory_fits_the_card():
    """The ring, its barriers and a full first_chunk column fit in one
    CTA's dynamic shared memory on the H100 (227 KiB)."""
    ring = (_constant("kStages", "copy.cuh") * tck.CHUNK_BYTES
            + _constant("kBarBytes", "copy.cuh"))
    assert ring + 8 * tck.MAX_PACK_LEAVES <= 227 * 1024


def test_header_edit_changes_the_build_hash(monkeypatch, tmp_path):
    assert [p.name for p in _build.headers()] == ["copy.cuh"]
    assert all(p.suffix == ".cu" for p in _build.sources())
    for p in _build.sources() + _build.headers():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    h0 = _build.source_hash()
    hdr = tmp_path / "copy.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    h1 = _build.source_hash()
    assert h1 != h0 and len(h1) == 16
    assert [p.name for p in _build.sources()] == [
        "checksum.cu", "flash_attention.cu", "paged_kv.cu", "parity.cu",
        "vote.cu"]


# -- 1-byte leaves (int8 moments) ----------------------------------------------

_SHIFT = {4: 0, 2: 1, 1: 2}     # copy.cuh's Span.widen by element size


def pack_chunks_bytes(table, n_chunks, buf_ptr):
    """``pack_chunks`` with every element size the kernel takes: a 2-byte
    (1-byte) leaf's chunk reads from half (a quarter of) its destination
    offset and widens."""
    leaf, off, length, _, dst = pack_chunks(table, n_chunks, buf_ptr)
    shift = np.vectorize(_SHIFT.get)(table[leaf, 4]) if len(leaf) else \
        np.zeros(0, np.int64)
    src = table[leaf, 0] + (off >> shift)
    return leaf, off, length, src, dst, shift


def replay_bytes(mem, src, dst, length, shift):
    """The kernel's copies over fake memory: ``length / 4`` values of
    ``4 >> shift`` bytes each zero-extended into a destination word."""
    raw = mem.view(np.uint8)
    for s, d, n, k in zip(src.tolist(), dst.tolist(), length.tolist(),
                          shift.tolist()):
        dw, nv, at = (d - BASE) // 4, n // 4, s - BASE
        vals = raw[at:at + nv * (4 >> k)]
        mem[dw:dw + nv] = vals.view({0: np.int32, 1: np.uint16,
                                     2: np.uint8}[k]).astype(np.int32) \
            if k else vals.view(np.int32)


_byte_leaf = st.tuples(st.one_of(st.integers(0, 300),
                                 st.integers(0, 2 * Q + 40)),
                       st.sampled_from([1, 1, 2, 4]),   # element bytes
                       st.integers(0, 15),              # byte misalignment
                       st.integers(0, 2))               # gap rows


@settings(max_examples=60, deadline=None)
@given(leaves=st.lists(_byte_leaf, min_size=1, max_size=10),
       seed=st.integers(0, 2**16))
def test_byte_pack_schedule_covers_every_word_once(leaves, seed):
    """Mixed 1-, 2- and 4-byte leaves, a 1-byte one at any byte address
    and of any length (not a multiple of 4 bytes): the schedule records
    each leaf's element size, its chunks replayed with the kernel's
    widening (``copy.cuh:widen_bytes``) write every destination word of
    every leaf exactly once, never a chunk across a leaf, and the buffer
    equals ``pack_rows_ref``: the int8 / uint8 values zero-extended,
    every other word untouched."""
    rng = np.random.default_rng(seed)
    sizes = [n for n, *_ in leaves]
    starts, total = _layout(sizes, [g for *_, g in leaves])
    src_bytes = sum(e * n + 48 for n, e, _, _ in leaves)
    mem = np.zeros(total + src_bytes // 4 + 8, np.int32)
    mem[:total] = _bits(rng, total)
    ptrs, tensors, at = [], [], 4 * total      # byte offset in mem
    for i, (n, e, mis, _) in enumerate(leaves):
        at = -(-at // 16) * 16 + (mis if e == 1 else
                                   2 * (mis % 8) if e == 2 else
                                   4 * (mis % 4))
        raw = rng.integers(0, 256, size=e * n, dtype=np.uint8)
        mem.view(np.uint8)[at:at + e * n] = raw
        dt = (torch.int8 if i % 2 else torch.uint8) if e == 1 else \
            torch.bfloat16 if e == 2 else torch.float32
        tensors.append(torch.from_numpy(raw.copy()).view(dt) if n else
                       torch.zeros(0, dtype=dt))
        ptrs.append(BASE + at)
        at += e * n
    table, n_chunks = tck.pack_schedule(ptrs, sizes, starts,
                                        [e for _, e, _, _ in leaves])
    assert table[:, 4].tolist() == [e for _, e, _, _ in leaves]
    assert n_chunks == sum(tck.chunk_count(4 * n) for n in sizes)
    leaf, off, length, src, dst, shift = pack_chunks_bytes(table, n_chunks,
                                                           BASE)
    assert np.all((length > 0) & (length <= CHUNK) & (length % 4 == 0))
    assert np.all(off + length <= 4 * np.asarray(sizes, np.int64)[leaf])
    for i, n in enumerate(sizes):
        mine = leaf == i
        cover = np.zeros(n + 1, np.int64)
        np.add.at(cover, off[mine] // 4, 1)
        np.add.at(cover, (off[mine] + length[mine]) // 4, -1)
        assert np.all(np.cumsum(cover)[:n] == 1), (i, n)
        # a 1-byte leaf's chunks read inside its own bytes
        if leaves[i][1] == 1 and mine.any():
            lo = src[mine] - ptrs[i]
            assert lo.min() >= 0 and (lo + length[mine] // 4).max() <= n
    before = mem[:total].copy()
    replay_bytes(mem, src, dst, length, shift)
    want = tref.pack_rows_ref(torch.from_numpy(before.copy()), tensors,
                              starts)
    assert np.array_equal(mem[:total], want.numpy())


@pytest.mark.parametrize("n", [0, 1, 3, 5, 7, 255, 256, 257])
@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_pack_rows_ref_of_bytes_is_the_reference_to_i32(n, dtype):
    """``ref.pack_rows_ref`` (and the CPU wrapper) of an int8 / uint8
    leaf writes the reference's ``to_i32`` words, each byte
    zero-extended, with the words around it untouched."""
    raw = np.random.default_rng(n).integers(0, 256, n + 3, dtype=np.uint8)
    raw[:2] = [0x80, 0xFF]
    x = raw[3:].view(dtype) if n else raw[:0].view(dtype)
    buf = torch.full((4 * tck.LANES,), -7, dtype=torch.int32)
    got = tck.pack_rows(buf.clone(), [torch.from_numpy(x.copy())],
                        [tck.LANES])
    plain = tref.pack_rows_ref(buf.clone(), [torch.from_numpy(x.copy())],
                               [tck.LANES])
    assert torch.equal(got, plain)
    theirs = np.asarray(tref_jax_to_i32(x))
    assert np.array_equal(got[tck.LANES:tck.LANES + n].numpy(), theirs)
    assert (got[:tck.LANES] == -7).all()
    assert (got[tck.LANES + n:] == -7).all()
    assert (theirs >= 0).all() and (theirs <= 255).all()


def tref_jax_to_i32(x):
    from repro.kernels import ref as jref
    return jref.to_i32(jnp.asarray(x))
