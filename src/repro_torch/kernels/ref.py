"""Plain PyTorch versions of the ported kernels.

They define the semantics the CUDA kernels must match bit for bit (the
algorithms are integer or pure copies, so tests assert equality, never
closeness).  The wrappers in ``checksum.py`` and ``paged_kv.py`` run these
for tensors that lie on the CPU; ``chip_smoke.py`` holds each kernel
against them on the card.

Pitfall carried over from the reference: ``torch.sum`` of int32 returns
int64, so every mod-2^32 reduction below is taken in int64 and wrapped
back to int32 explicitly (``wrap_i32``).
"""

from __future__ import annotations

from typing import Sequence

import torch

LANES = 128
TILE_ROWS = 256

_MASK32 = 0xFFFFFFFF


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Flat int32 view of the raw bits of a 4-byte tensor (the checksum
    domain; the reference's ``ref.to_i32`` 4-byte branches).  Other dtypes
    raise until a configuration that uses them is ported."""
    if x.dtype == torch.int32:
        return x.reshape(-1)
    if x.dtype in (torch.float32, torch.uint32):
        return x.contiguous().view(torch.int32).reshape(-1)
    raise TypeError(f"to_i32: dtype {x.dtype} is not ported "
                    f"(4-byte dtypes only)")


def from_i32(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_i32`` for the 4-byte dtypes."""
    if like.dtype == torch.int32:
        return flat.reshape(like.shape)
    if like.dtype in (torch.float32, torch.uint32):
        return flat.contiguous().view(like.dtype).reshape(like.shape)
    raise TypeError(f"from_i32: dtype {like.dtype} is not ported")


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), exactly."""
    v = v & _MASK32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def pack_rows_ref(buf: torch.Tensor, flats: Sequence[torch.Tensor],
                  starts: Sequence[int]) -> torch.Tensor:
    """Write each flat int32 leaf into ``buf`` at its element offset, in
    place; every other word of ``buf`` is left untouched."""
    for flat, s in zip(flats, starts):
        buf[s:s + flat.numel()].copy_(flat.reshape(-1))
    return buf


def row_checksums_ref(rows: torch.Tensor) -> torch.Tensor:
    """Per 128-lane row ``s1 = Σ x`` and ``s2 = Σ (lane+1)·x`` mod 2^32.

    rows : (..., LANES) int32.  Returns (..., 2) int32."""
    x = rows.to(torch.int64)
    lane = torch.arange(1, LANES + 1, dtype=torch.int64, device=rows.device)
    s1 = x.sum(-1)
    s2 = (x * lane).sum(-1)
    return torch.stack([wrap_i32(s1), wrap_i32(s2)], dim=-1)


def gather_blocks_ref(pool: torch.Tensor,
                      block_tables: torch.Tensor) -> torch.Tensor:
    """``out[s, j] = pool[block_tables[s, j]]`` — (S, max_blocks, ...)."""
    return pool[block_tables.to(torch.int64)]
