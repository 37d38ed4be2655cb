"""Wrappers of the digest kernels: ``pack_rows``, ``row_checksums`` and
``checksum_tiles``.

Counterparts of ``repro/kernels/checksum.py``.  Dispatch is by the
tensor's device: a CPU tensor takes the plain version (``kernels/ref.py``);
a CUDA tensor launches the hand-written kernel (``csrc/checksum.cu``; pack
through the copy engine of ``csrc/copy.cuh``) or raises — there is no
fallback.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LANES = _ref.LANES
TILE_ROWS = _ref.TILE_ROWS
TILE = _ref.TILE

# The copy engine's chunk size, ``kChunk`` of ``csrc/copy.cuh``.
CHUNK_BYTES = 32768
# Leaves per ``pack_rows`` launch: ``kMaxLeaves`` of ``csrc/checksum.cu``
# (the kernel stages their ``first_chunk`` column in shared memory).
MAX_PACK_LEAVES = 8192


def chunk_count(n_bytes: int) -> int:
    """Chunks of a run of ``n_bytes`` in the copy engine: its 16-byte
    body in ``CHUNK_BYTES`` pieces, then one tail chunk of the ragged
    bytes when there are any (0 for an empty run)."""
    body = n_bytes & ~15
    return -(-body // CHUNK_BYTES) + (n_bytes != body)


def pack_schedule(ptrs: Sequence[int], n_words: Sequence[int],
                  starts: Sequence[int]) -> Tuple[np.ndarray, int]:
    """The ``pack_rows`` kernel's schedule: an ``(n_leaves, 4)`` int64
    table of ``(src_ptr, n_words, dst_start, first_chunk)`` and the total
    chunk count.  ``first_chunk`` is the prefix sum of the leaves' chunk
    counts (``chunk_count`` of ``4 * n_words`` bytes), so chunk ``c``
    belongs to the last leaf whose ``first_chunk <= c``."""
    counts = [chunk_count(4 * int(n)) for n in n_words]
    first = np.zeros(len(counts), np.int64)
    if counts:
        first[1:] = np.cumsum(counts[:-1])
    table = np.array([(int(p), int(n), int(s), int(f)) for p, n, s, f
                      in zip(ptrs, n_words, starts, first)],
                     dtype=np.int64).reshape(-1, 4)
    return table, int(sum(counts))


class PackDescriptors(NamedTuple):
    """A ``pack_schedule`` uploaded to the device (``table``), with its
    chunk count."""
    table: torch.Tensor
    n_chunks: int


def pack_descriptors(flats: Sequence[torch.Tensor], starts: Sequence[int],
                     device) -> PackDescriptors:
    """The kernel's schedule of ``flats`` on ``device``.  Valid only while
    every flat keeps its storage; callers cache it keyed by the
    pointers."""
    table, n_chunks = pack_schedule([f.data_ptr() for f in flats],
                                    [f.numel() for f in flats], starts)
    return PackDescriptors(torch.from_numpy(table).to(device), n_chunks)


def pack_rows(buf: torch.Tensor, flats: Sequence[torch.Tensor],
              starts: Sequence[int], *,
              desc: Optional[PackDescriptors] = None) -> torch.Tensor:
    """In-place scatter of flat int32 leaves into the packing buffer at the
    given element offsets (row aligned); other words are untouched.

    buf   : flat int32 packing buffer, written in place and returned.
    flats : flat int32 contiguous leaves (``ref.to_i32`` views).
    desc  : optional pre-built ``pack_descriptors(flats, starts)`` (CUDA
            only), so a steady-state caller uploads nothing.
    """
    if buf.device.type == "cpu":
        return _ref.pack_rows_ref(buf, flats, starts)
    if buf.device.type != "cuda":
        raise ValueError(f"pack_rows: unsupported device {buf.device}")
    if buf.dtype != torch.int32:
        raise TypeError("pack_rows: buf must be int32")
    for f, s in zip(flats, starts):
        if f.dtype != torch.int32 or not f.is_contiguous():
            raise ValueError("pack_rows: leaves must be contiguous int32")
        if f.device != buf.device:
            raise ValueError("pack_rows: leaf on another device")
        if s % LANES or s + f.numel() > buf.numel():
            raise ValueError(f"pack_rows: bad start {s} for {f.numel()} words")
    if len(flats) > MAX_PACK_LEAVES:
        raise ValueError(f"pack_rows: {len(flats)} leaves, at most "
                         f"{MAX_PACK_LEAVES} per launch")
    _build.require_cuda("pack_rows", buf)
    if desc is None:
        desc = pack_descriptors(flats, starts, buf.device)
    if desc.n_chunks:                     # else every leaf is empty
        rc = _build.lib().repro_pack_rows(
            buf.data_ptr(), desc.table.data_ptr(), len(flats),
            desc.n_chunks, _build.stream_of(buf))
        _build.check(rc, "pack_rows")
        _build.LAUNCHES["pack_rows"] += 1
    return buf


def row_checksums(rows: torch.Tensor) -> torch.Tensor:
    """Per-row Fletcher partials of a ``(n_rows, LANES)`` int32 tensor:
    ``(n_rows, 2)`` int32 with ``s1 = Σ x`` and ``s2 = Σ (lane+1)·x``
    (mod 2^32).  Any leading shape ``(..., LANES)`` is accepted."""
    if rows.device.type == "cpu":
        return _ref.row_checksums_ref(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"row_checksums: unsupported device {rows.device}")
    if rows.dtype != torch.int32 or rows.shape[-1] != LANES:
        raise ValueError("row_checksums: need int32 (..., 128) rows")
    _build.require_cuda("row_checksums", rows)
    lead = rows.shape[:-1]
    n_rows = rows.numel() // LANES
    out = torch.empty(lead + (2,), dtype=torch.int32, device=rows.device)
    rc = _build.lib().repro_row_checksums(rows.data_ptr(), out.data_ptr(),
                                          n_rows, _build.stream_of(rows))
    _build.check(rc, "row_checksums")
    _build.LAUNCHES["row_checksums"] += 1
    return out


def checksum_tiles(flat: torch.Tensor) -> torch.Tensor:
    """Per-tile Fletcher pairs of a flat int32 vector: ``(nt, 2)`` int32,
    ``nt = max(1, ceil(n / TILE))``, ``s1 = Σ x`` and ``s2 = Σ (i+1)·x``
    over each ``TILE``-word tile with tile-local ``i`` (mod 2^32); the
    ragged last tile counts as zero-padded.  ``ops.checksum`` combines
    the tiles into one digest.

    flat : contiguous 1-D int32 (a ``ref.to_i32`` view); any base
           alignment (an unaligned base takes the kernel's scalar path).
    """
    if flat.device.type == "cpu":
        return _ref.checksum_tiles_ref(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"checksum_tiles: unsupported device {flat.device}")
    if flat.dtype != torch.int32 or flat.dim() != 1:
        raise ValueError("checksum_tiles: need a 1-D int32 tensor")
    _build.require_cuda("checksum_tiles", flat, aligned=False)
    n = flat.numel()
    nt = max(1, -(-n // TILE))
    out = torch.empty((nt, 2), dtype=torch.int32, device=flat.device)
    rc = _build.lib().repro_checksum_tiles(flat.data_ptr(), n,
                                           out.data_ptr(), nt,
                                           _build.stream_of(flat))
    _build.check(rc, "checksum_tiles")
    _build.LAUNCHES["checksum_tiles"] += 1
    return out
