"""Wrapper of the paged-KV block gather — counterpart of
``repro/kernels/paged_kv.py``.

The paged serving engine keeps every decode-cache leaf as a shared block
pool ``(n_blocks, block_size, ...)`` plus per-slot block tables
``(S, max_blocks)``; the decode step needs each slot's owned blocks as one
contiguous per-slot view.  That gather must be a pure copy: the decode
then runs unmodified on the gathered view, which is what makes the paged
engine bit-exact.

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/paged_kv.cu`` (the copy engine of ``csrc/copy.cuh``) or raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref


def gather_blocks(pool_leaf: torch.Tensor,
                  block_tables: torch.Tensor) -> torch.Tensor:
    """``out[s, j] = pool_leaf[block_tables[s, j]]``.

    pool_leaf    : (n_blocks, block_size, *feat), elements of any size
                   whose block is whole 4-byte words (a bf16 KV pool
                   moves as the words of its element pairs)
    block_tables : (S, max_blocks) int32; unallocated entries point at the
                   scratch block 0 (the caller masks those rows)
    Returns (S, max_blocks, block_size, *feat).
    """
    if pool_leaf.device.type == "cpu":
        return _ref.gather_blocks_ref(pool_leaf, block_tables)
    if pool_leaf.device.type != "cuda":
        raise ValueError(f"gather_blocks: unsupported device "
                         f"{pool_leaf.device}")
    block_bytes = math.prod(pool_leaf.shape[1:]) * pool_leaf.element_size()
    if block_bytes % 4:
        raise TypeError("gather_blocks: a pool block must be whole 4-byte "
                        f"words, got {block_bytes} bytes")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2:
        raise ValueError("gather_blocks: block_tables must be (S, mb) int32")
    _build.require_cuda("gather_blocks", pool_leaf, block_tables)
    n_blocks = pool_leaf.shape[0]
    S, mb = block_tables.shape
    out = torch.empty((S, mb) + tuple(pool_leaf.shape[1:]),
                      dtype=pool_leaf.dtype, device=pool_leaf.device)
    if out.numel():                       # else there is nothing to copy
        rc = _build.lib().repro_gather_blocks(
            pool_leaf.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
            n_blocks, S * mb, block_bytes // 4, _build.stream_of(pool_leaf))
        _build.check(rc, "gather_blocks")
        _build.LAUNCHES["gather_blocks"] += 1
    return out
