"""Wrappers of the digest kernels: ``pack_rows``, ``row_checksums`` and
``checksum_tiles``.

Counterparts of ``repro/kernels/checksum.py``.  Dispatch is by the
tensor's device: a CPU tensor takes the plain version (``kernels/ref.py``);
a CUDA tensor launches the hand-written kernel (``csrc/checksum.cu``) or
raises — there is no fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LANES = _ref.LANES
TILE_ROWS = _ref.TILE_ROWS
TILE = _ref.TILE


def pack_descriptors(flats: Sequence[torch.Tensor], starts: Sequence[int],
                     device) -> torch.Tensor:
    """Device table ``(n_leaves, 3)`` int64 of ``(src_ptr, n_words,
    dst_start)`` — the kernel's per-leaf descriptors.  Valid only while
    every flat keeps its storage; callers cache it keyed by the pointers."""
    table = np.array([(f.data_ptr(), f.numel(), int(s))
                      for f, s in zip(flats, starts)],
                     dtype=np.int64).reshape(-1, 3)
    return torch.from_numpy(table).to(device)


def pack_rows(buf: torch.Tensor, flats: Sequence[torch.Tensor],
              starts: Sequence[int], *,
              desc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-place scatter of flat int32 leaves into the packing buffer at the
    given element offsets (row aligned); other words are untouched.

    buf   : flat int32 packing buffer, written in place and returned.
    flats : flat int32 contiguous leaves (``ref.to_i32`` views).
    desc  : optional pre-built ``pack_descriptors(flats, starts)`` table
            (CUDA only), so a steady-state caller uploads nothing.
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
    if len(flats) > 65535:
        raise ValueError("pack_rows: at most 65535 leaves per launch")
    _build.require_cuda("pack_rows", buf)
    if desc is None:
        desc = pack_descriptors(flats, starts, buf.device)
    max_words = max((f.numel() for f in flats), default=0)
    rc = _build.lib().repro_pack_rows(buf.data_ptr(), desc.data_ptr(),
                                      len(flats), max_words,
                                      _build.stream_of(buf))
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
