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
# 1-byte dtypes ``ref.to_i32`` zero-extends (a bool or an 8-bit float
# does not take that path)
_BYTE_INTS = (torch.int8, torch.uint8)


def chunk_count(n_bytes: int) -> int:
    """Chunks of a run of ``n_bytes`` in the copy engine: its 16-byte
    body in ``CHUNK_BYTES`` pieces, then one tail chunk of the ragged
    bytes when there are any (0 for an empty run)."""
    body = n_bytes & ~15
    return -(-body // CHUNK_BYTES) + (n_bytes != body)


def pack_schedule(ptrs: Sequence[int], n_words: Sequence[int],
                  starts: Sequence[int],
                  elem_bytes: Optional[Sequence[int]] = None
                  ) -> Tuple[np.ndarray, int]:
    """The ``pack_rows`` kernel's schedule: an ``(n_leaves, 5)`` int64
    table of ``(src_ptr, n_words, dst_start, first_chunk, elem_bytes)``
    and the total chunk count.  ``n_words`` is the words a leaf fills
    (its element count); ``elem_bytes`` its element size, 4 (copied as
    is), 2 or 1 (each value zero-extended to a word; 4 when not given).
    ``first_chunk`` is the prefix sum of the leaves' chunk counts
    (``chunk_count`` of the ``4 * n_words`` bytes each writes), so chunk
    ``c`` belongs to the last leaf whose ``first_chunk <= c``."""
    if elem_bytes is None:
        elem_bytes = [4] * len(ptrs)
    counts = [chunk_count(4 * int(n)) for n in n_words]
    first = np.zeros(len(counts), np.int64)
    if counts:
        first[1:] = np.cumsum(counts[:-1])
    table = np.array([(int(p), int(n), int(s), int(f), int(e)) for p, n, s, f, e
                      in zip(ptrs, n_words, starts, first, elem_bytes)],
                     dtype=np.int64).reshape(-1, 5)
    return table, int(sum(counts))


class PackDescriptors(NamedTuple):
    """A ``pack_schedule`` uploaded to the device (``table``), with its
    chunk count."""
    table: torch.Tensor
    n_chunks: int


def pack_descriptors(leaves: Sequence[torch.Tensor], starts: Sequence[int],
                     device) -> PackDescriptors:
    """The kernel's schedule of ``leaves`` on ``device``: each leaf's own
    ``data_ptr`` and element size.  Valid only while every leaf keeps its
    storage; callers cache it keyed by the pointers."""
    table, n_chunks = pack_schedule([x.data_ptr() for x in leaves],
                                    [x.numel() for x in leaves], starts,
                                    [x.element_size() for x in leaves])
    return PackDescriptors(torch.from_numpy(table).to(device), n_chunks)


def pack_rows(buf: torch.Tensor, leaves: Sequence[torch.Tensor],
              starts: Sequence[int], *,
              desc: Optional[PackDescriptors] = None) -> torch.Tensor:
    """In-place scatter of the leaves' ``ref.to_i32`` words into the
    packing buffer at the given element offsets (row aligned); other
    words are untouched.

    buf    : flat int32 packing buffer, written in place and returned.
    leaves : contiguous tensors, read in place: 4-byte elements are
             copied as they are, 2-byte ones (bf16, f16, int16) and
             1-byte integers (int8, uint8: quantised moments)
             zero-extended into words by the kernel itself, from any
             byte address.
    desc   : optional pre-built ``pack_descriptors(leaves, starts)`` (CUDA
             only), so a steady-state caller uploads nothing.
    """
    if buf.device.type == "cpu":
        return _ref.pack_rows_ref(buf, leaves, starts)
    if buf.device.type != "cuda":
        raise ValueError(f"pack_rows: unsupported device {buf.device}")
    if buf.dtype != torch.int32:
        raise TypeError("pack_rows: buf must be int32")
    for x, s in zip(leaves, starts):
        if x.element_size() not in (1, 2, 4) or x.is_complex() \
                or not x.is_contiguous() or (x.element_size() == 1 and
                                             x.dtype not in _BYTE_INTS):
            raise ValueError("pack_rows: leaves must be contiguous, of "
                             "4- or 2-byte elements or 1-byte integers")
        if x.device != buf.device:
            raise ValueError("pack_rows: leaf on another device")
        if s % LANES or s + x.numel() > buf.numel():
            raise ValueError(f"pack_rows: bad start {s} for {x.numel()} words")
    if len(leaves) > MAX_PACK_LEAVES:
        raise ValueError(f"pack_rows: {len(leaves)} leaves, at most "
                         f"{MAX_PACK_LEAVES} per launch")
    _build.require_cuda("pack_rows", buf)
    if desc is None:
        desc = pack_descriptors(leaves, starts, buf.device)
    if desc.n_chunks:                     # else every leaf is empty
        rc = _build.lib().repro_pack_rows(
            buf.data_ptr(), desc.table.data_ptr(), len(leaves),
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
