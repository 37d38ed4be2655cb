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
    assert table.dtype == np.int64 and table.shape == (len(leaves), 4)
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
    assert table.shape == (0, 4) and n == 0
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
