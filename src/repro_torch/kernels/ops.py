"""Public kernel-level helpers — counterpart of ``repro/kernels/ops.py``:
whole-leaf digests through the ``checksum_tiles`` kernel, the TMR vote
through ``vote3_tiles``, the XOR parity of equal-shaped arrays through
``xor_fold_tiles``, model-layout flash attention through
``flash_attention_bhsd``, the pytree digests over the fused
``DigestPlan`` and the rotating-canary schedule.

Unlike the reference the digest, vote and attention kernels take no
padded copy: the digest and vote kernels take the flat int32 view and its
length and mask the ragged tail, the attention kernel bounds-checks Sq
and Sk itself.  The XOR fold takes tiles, as in the reference, so its
operands are stacked into one zero-padded ``(R, nt, 256, 128)`` buffer.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.kernels import checksum as _ck
from repro_torch.kernels import digest as _dg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import parity as _pk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import vote as _vk

TILE = _ck.TILE  # int32 words per checksum tile


def combine_tiles(d: torch.Tensor) -> torch.Tensor:
    """Exact combine of ``(nt, 2)`` tile digests into one int32[2]:
    ``s1 = Σ_t s1_t`` and ``s2 = Σ_t (s2_t + offset_t · s1_t)`` mod 2^32,
    ``offset_t = t · TILE`` — in int64 masked to 32 bits, since
    ``torch.sum`` of int32 widens to int64."""
    s1 = d[:, 0].to(torch.int64)
    offsets = torch.arange(d.shape[0], dtype=torch.int64,
                           device=d.device) * TILE
    # |offset·s1| < 2^62 for any leaf below 2^31 tiles: exact in int64
    s2 = (d[:, 1].to(torch.int64) + ((offsets * s1) & 0xFFFFFFFF)).sum()
    return _ref.wrap_i32(torch.stack([s1.sum(), s2]))


def checksum(x: torch.Tensor) -> torch.Tensor:
    """Two-term Fletcher digest int32[2] of the raw bits of ``x`` (one
    ``checksum_tiles`` launch on the card), equal to ``ref.checksum_ref``
    and to the reference's ``ops.checksum`` of the same bytes."""
    return combine_tiles(_ck.checksum_tiles(_ref.to_i32(x)))


def blocked_checksum(x: torch.Tensor) -> torch.Tensor:
    """Per-tile digests int32[nt, 2] (localisation granularity: one
    ``TILE`` = 32,768 words = 128 KiB)."""
    return _ck.checksum_tiles(_ref.to_i32(x))


def vote3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Bitwise majority of three equal-shaped tensors, ``a``'s dtype out."""
    if not (a.shape == b.shape == c.shape and a.dtype == b.dtype == c.dtype):
        raise ValueError("vote3: copies differ in shape or dtype")
    out = _vk.vote3_tiles(_ref.to_i32(a), _ref.to_i32(b), _ref.to_i32(c))
    return _ref.from_i32(out, a)


def xor_fold(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Parity of equal-shaped tensors of one dtype (the first one's dtype
    out): one ``xor_fold_tiles`` launch over their stacked int32 views."""
    first = arrays[0]
    if any(a.shape != first.shape or a.dtype != first.dtype
           for a in arrays):
        raise ValueError("xor_fold: arrays differ in shape or dtype")
    n = first.numel()
    nt = max(1, -(-n // TILE))
    tiles = torch.zeros((len(arrays), nt * TILE), dtype=torch.int32,
                        device=first.device)
    for row, a in zip(tiles, arrays):
        row[:n] = _ref.to_i32(a)
    out = _pk.xor_fold_tiles(tiles.view(len(arrays), nt, _ck.TILE_ROWS,
                                        _ck.LANES))
    return _ref.from_i32(out.view(-1)[:n], first)


def xor_reconstruct(parity: torch.Tensor,
                    others: Sequence[torch.Tensor]) -> torch.Tensor:
    """The missing shard from the parity and the surviving shards."""
    return xor_fold(list(others) + [parity])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = 0,
                    block_k: int = 0) -> torch.Tensor:
    """Model-layout flash attention: q ``(B, Sq, H, D)``, k/v ``(B, Sk,
    KV, D)`` -> ``(B, Sq, H, D)`` in q's dtype.

    Flattens q head-major per batch, ``(B·H, Sq, D)``, the layout the
    kernel's GQA index ``b // G`` assumes, and k/v to ``(B·KV, Sk, D)``.
    Nothing is padded and q is not rescaled: the kernel masks ragged Sq
    and Sk against their true lengths and scales by the true ``D``.
    ``block_q``/``block_k`` are accepted for the reference's signature
    only; the card's tiling is the kernel's own, and the result does not
    depend on them.  (The reference's does: its zero-padded keys are
    attended to when ``causal`` is off and Sk is ragged.)"""
    del block_q, block_k
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, Sq, D)
    kf = k.transpose(1, 2).reshape(B * KV, Sk, D)
    vf = v.transpose(1, 2).reshape(B * KV, Sk, D)
    # at B == 1 the reshapes are strided views; the kernel reads dense rows
    o = _fa.flash_attention_bhsd(qf.contiguous(), kf.contiguous(),
                                 vf.contiguous(), causal=causal,
                                 window=window, softcap=softcap)
    return o.reshape(B, H, Sq, D).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Pytree-level digests — thin wrappers over the fused DigestPlan (one
# pack_rows + one row_checksums launch and one host transfer per call)
# ---------------------------------------------------------------------------

def tree_checksums(tree) -> Dict[str, np.ndarray]:
    """Digest per leaf, keyed by path string (the Recovery Table's key)."""
    return _dg.plan_for(tree).digest_dict(tree)


def subtree_checksums(tree, keys) -> Dict[str, np.ndarray]:
    """Digests of the named leaves only (the rotating canary's slice): one
    launch over the subset's rows and one ``fetch``."""
    plan = _dg.plan_for(tree)
    kset = set(keys)
    want = [k for k in plan.keys if k in kset]
    idx = [plan.index_of(k) for k in want]
    table = _dg.fetch(plan.digest_subset(tree, idx)) if idx \
        else np.zeros((0, 2), np.int32)
    return {k: table[i] for i, k in enumerate(want)}


def verify_tree(tree, reference: Dict[str, np.ndarray]) -> List[str]:
    """Leaf paths whose digest no longer matches ``reference``."""
    return _dg.plan_for(tree).verify(tree, reference)


def rotating_slice(step: int, n_slices: int, n_leaves: int) -> List[int]:
    """Indices of the leaves checked at ``step`` under the rotating-canary
    schedule (full coverage every n_slices steps at 1/n_slices the cost)."""
    return [i for i in range(n_leaves) if i % n_slices == step % n_slices]
