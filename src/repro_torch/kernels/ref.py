"""Plain PyTorch versions of the ported kernels.

They define the semantics the CUDA kernels must match: bit for bit for
the integer and copy kernels (tests assert equality, never closeness),
within the reference's floating-point tolerance for flash attention.  The
wrappers in ``checksum.py``, ``vote.py``, ``parity.py``, ``paged_kv.py``
and ``flash_attention.py`` run these for tensors that lie on the CPU;
``chip_smoke.py`` holds each kernel against them on the card.
``flash_attention_3xtf32`` is not a plain version but the flash kernel's
tensor-core arithmetic (3xTF32) written out, for the tests and
``chip_smoke.py``; no wrapper calls it.

Pitfall carried over from the reference: ``torch.sum`` of int32 returns
int64, so every mod-2^32 reduction below is taken in int64 and wrapped
back to int32 explicitly (``wrap_i32``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

LANES = 128
TILE_ROWS = 256
TILE = TILE_ROWS * LANES        # int32 words per checksum tile (128 KiB)
CHECKSUM_BLOCK = 4096           # words per block of ``blocked_checksum_ref``
NEG_INF = -2.0 ** 30            # the flash kernel's mask value

_MASK32 = 0xFFFFFFFF
_TWO_BYTE = (torch.bfloat16, torch.float16, torch.int16, torch.uint16)
_FOUR_BYTE = (torch.float32, torch.uint32)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Flat int32 vector of the raw bits of ``x`` — the reference's
    ``ref.to_i32``: 4-byte dtypes are bit views, 2- and 1-byte dtypes are
    zero-extended, int64 is truncated, any other real dtype goes through
    float32."""
    if x.dtype == torch.int32:
        return x.reshape(-1)
    if x.dtype in _FOUR_BYTE:
        return x.contiguous().view(torch.int32).reshape(-1)
    if x.dtype in _TWO_BYTE:
        i16 = x.contiguous().view(torch.int16).reshape(-1)
        return i16.to(torch.int32) & 0xFFFF
    if x.dtype in (torch.int8, torch.uint8):
        return x.reshape(-1).to(torch.int32) & 0xFF
    if x.dtype == torch.int64:
        return x.reshape(-1).to(torch.int32)
    if x.is_complex():
        raise TypeError(f"to_i32: complex dtype {x.dtype} has no int32 view")
    return x.to(torch.float32).contiguous().view(torch.int32).reshape(-1)


def from_i32(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_i32`` for the dtypes of state trees."""
    if like.dtype == torch.int32:
        return flat.reshape(like.shape)
    if like.dtype in _FOUR_BYTE:
        return flat.contiguous().view(like.dtype).reshape(like.shape)
    if like.dtype in _TWO_BYTE:
        return flat.to(torch.int16).view(like.dtype).reshape(like.shape)
    if like.dtype in (torch.int8, torch.uint8):
        return flat.to(like.dtype).reshape(like.shape)
    raise TypeError(f"from_i32: unsupported dtype {like.dtype}")


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), exactly."""
    v = v & _MASK32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _fletcher(words: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` int32 -> ``(..., 2)`` int32: ``s1 = Σ x`` and
    ``s2 = Σ (i+1)·x`` along the last axis, mod 2^32.  Each product is
    masked to 32 bits before the sum, so the int64 sum cannot overflow."""
    x = words.to(torch.int64)
    idx = torch.arange(1, x.shape[-1] + 1, dtype=torch.int64,
                       device=x.device)
    s1 = x.sum(-1)
    s2 = ((x * idx) & _MASK32).sum(-1)
    return torch.stack([wrap_i32(s1), wrap_i32(s2)], dim=-1)


def checksum_ref(x: torch.Tensor) -> torch.Tensor:
    """Two-term Fletcher digest int32[2] of the raw bits of ``x``:
    ``s1 = Σ x_i`` and ``s2 = Σ (i+1)·x_i`` mod 2^32."""
    return _fletcher(to_i32(x))


def blocked_checksum_ref(x: torch.Tensor,
                         block: int = CHECKSUM_BLOCK) -> torch.Tensor:
    """Per-block digests int32[nb, 2] with block-local weights, the tail
    block zero-padded."""
    flat = to_i32(x)
    nb = -(-flat.numel() // block)
    flat = torch.nn.functional.pad(flat, (0, nb * block - flat.numel()))
    return _fletcher(flat.view(nb, block))


def checksum_tiles_ref(flat: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``checksum_tiles`` kernel: per ``TILE``-word
    tile of a flat int32 vector, ``(s1, s2)`` with tile-local weights
    1..TILE; the ragged last tile counts as zero-padded.  Returns
    ``(max(1, ceil(n / TILE)), 2)`` int32."""
    nt = max(1, -(-flat.numel() // TILE))
    padded = torch.nn.functional.pad(flat, (0, nt * TILE - flat.numel()))
    return _fletcher(padded.view(nt, TILE))


def vote3_tiles_ref(a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``vote3_tiles`` kernel: bitwise majority of
    three flat int32 vectors."""
    return (a & b) | (a & c) | (b & c)


def vote3_ref(a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Bitwise triple-modular-redundancy majority in ``a``'s dtype."""
    return from_i32(vote3_tiles_ref(to_i32(a), to_i32(b), to_i32(c)), a)


def xor_fold_tiles_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``xor_fold_tiles`` kernel: XOR over axis 0 of
    ``(R, nt, TILE_ROWS, LANES)`` int32, as a new ``(nt, TILE_ROWS,
    LANES)`` tensor."""
    acc = x[0].clone()
    for r in range(1, x.shape[0]):
        acc.bitwise_xor_(x[r])
    return acc


def xor_update_tiles_ref(x: torch.Tensor, parity: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of the ``xor_update_tiles`` kernel: ``parity ^=
    XOR_d x[d]`` in place (``x``: ``(D, nt, TILE_ROWS, LANES)``,
    ``parity``: ``(nt, TILE_ROWS, LANES)``, int32); returns ``parity``."""
    for d in range(x.shape[0]):
        parity.bitwise_xor_(x[d])
    return parity


def xor_fold_ref(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """XOR fold of equal-shaped tensors (parity construction), in the
    first one's dtype."""
    acc = to_i32(arrays[0]).clone()
    for a in arrays[1:]:
        acc.bitwise_xor_(to_i32(a))
    return from_i32(acc, arrays[0])


def xor_reconstruct_ref(parity: torch.Tensor,
                        others: Sequence[torch.Tensor]) -> torch.Tensor:
    """The missing shard: ``parity ^ XOR(others)``."""
    return xor_fold_ref([parity, *others])


def pack_rows_ref(buf: torch.Tensor, leaves: Sequence[torch.Tensor],
                  starts: Sequence[int]) -> torch.Tensor:
    """Write each leaf's ``to_i32`` words into ``buf`` at its element
    offset, in place (a 2- or 1-byte leaf zero-extended, as the reference
    packs ``to_i32`` flats); every other word of ``buf`` is left
    untouched."""
    for x, s in zip(leaves, starts):
        buf[s:s + x.numel()].copy_(to_i32(x))
    return buf


def row_checksums_ref(rows: torch.Tensor) -> torch.Tensor:
    """Per 128-lane row ``s1 = Σ x`` and ``s2 = Σ (lane+1)·x`` mod 2^32.

    rows : (..., LANES) int32.  Returns (..., 2) int32."""
    return _fletcher(rows)


def gather_blocks_ref(pool: torch.Tensor,
                      block_tables: torch.Tensor) -> torch.Tensor:
    """``out[s, j] = pool[block_tables[s, j]]`` — (S, max_blocks, ...)."""
    return pool[block_tables.to(torch.int64)]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Dense-softmax plain version of the flash kernel.

    q ``(BH, Sq, D)``, k/v ``(BKV, Sk, D)``, BH a multiple of BKV (q row
    ``b`` reads kv row ``b // G``, G = BH // BKV).  f32 scores scaled by
    ``1/sqrt(D)``, ``tanh(s/cap)·cap`` when ``softcap`` is set (before the
    mask), causal and window masks top-left aligned (positions from 0),
    masked scores ``-2^30``, f32 softmax; the output in q's dtype."""
    BH, _, D = q.shape
    G = BH // k.shape[0]
    kr = k.repeat_interleave(G, dim=0).to(torch.float32)
    vr = v.repeat_interleave(G, dim=0).to(torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), kr) / math.sqrt(D)
    p = torch.softmax(_cap_and_mask(s, causal, window, softcap), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vr).to(q.dtype)


def _cap_and_mask(s: torch.Tensor, causal: bool, window: int,
                  softcap: float) -> torch.Tensor:
    """Scores ``(BH, Sq, Sk)``: ``tanh(s/cap)·cap`` when ``softcap`` is
    set, then the causal and window masks (top-left aligned) at
    ``NEG_INF``."""
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    Sq, Sk = s.shape[-2:]
    qp = torch.arange(Sq, device=s.device)[:, None]
    kp = torch.arange(Sk, device=s.device)[None, :]
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=s.device)
    if causal:
        live &= qp >= kp
    if window:
        live &= (qp - kp) < window
    return torch.where(live[None], s, torch.full((), NEG_INF, device=s.device))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as the card's ``cvt.rna.tf32.f32``: half a TF32 ulp added to the
    magnitude's bits (a carry runs into the exponent), the low 13 bits
    cleared.  NaN stays NaN."""
    x = x.to(torch.float32)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    sign = bits & 0x80000000
    # TF32 keeps the top 10 of f32's 23 mantissa bits: 13 are dropped
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = wrap_i32(sign | mag).view(torch.float32).reshape(x.shape)
    return torch.where(torch.isnan(x), x, out)


def tf32_split(x: torch.Tensor):
    """``(big, small)`` with ``big = tf32_round(x)`` and ``small =
    tf32_round(x - big)``: ``big + small`` is within 2^-22·|x| of x."""
    big = tf32_round(x)
    return big, tf32_round(x.to(torch.float32) - big)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int):
    """``a @ b`` from TF32 parts, f32 accumulation: with ``passes == 3``
    ``a_s·b_b + a_b·b_s + a_b·b_b`` (small products first), with
    ``passes == 1`` ``a_b·b_b`` alone.  Each product of two TF32 values is
    exact in f32."""
    ab, a_s = tf32_split(a)
    bb, b_s = tf32_split(b)
    if passes == 1:
        return ab @ bb
    if passes != 3:
        raise ValueError(f"passes {passes}: 1 or 3")
    return a_s @ bb + ab @ b_s + ab @ bb


def flash_attention_3xtf32(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0,
                           passes: int = 3) -> torch.Tensor:
    """The flash kernel's arithmetic on the tensor cores, densely: the
    semantics of ``flash_attention_ref`` with both products taken in
    ``passes`` TF32 products (``_tf32_matmul``), the unnormalised weights
    ``exp(s - max)`` split the same way, and the division by their sum
    (clamped at 1e-37) last.  The kernel differs from it only in the
    order of its f32 sums (tensor-core accumulation, the online softmax).
    ``passes=1`` is a single TF32 pass, which misses the reference's f32
    tolerance."""
    BH, _, D = q.shape
    G = BH // k.shape[0]
    kr = k.repeat_interleave(G, dim=0).to(torch.float32)
    vr = v.repeat_interleave(G, dim=0).to(torch.float32)
    s = _tf32_matmul(q.to(torch.float32), kr.transpose(1, 2), passes)
    s = _cap_and_mask(s * (1.0 / math.sqrt(D)), causal, window, softcap)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = _tf32_matmul(p, vr, passes) / p.sum(-1, keepdim=True).clamp_min(1e-37)
    return o.to(q.dtype)


def _smem_word(rows: int, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Word of element (r, c) of a ``rows``-row operand in the no-swizzle
    K-major core-matrix layout the tensor cores read (``Smem::word`` of
    ``csrc/flash_attention.cu``)."""
    return (c >> 2) * (4 * rows) + (r >> 3) * 32 + (r & 7) * 4 + (c & 3)


def flash_layout_kv_ref(k: torch.Tensor, v: torch.Tensor, seq_k: int,
                        tile_keys: int) -> torch.Tensor:
    """The records ``flash_layout_kv`` writes: for each kv row and each
    tile of ``tile_keys`` keys (the last one zero-padded past ``seq_k``),
    ``[K big | K small | V^T big | V^T small]`` (bf16 inputs: no small
    parts), the TF32 parts of ``tf32_split`` in the K-major layout, with
    V transposed and each 8-key group of its columns holding keys
    0 2 4 6 1 3 5 7.  Flat f32, ``BKV * n_tiles`` records."""
    BKV, _, D = k.shape
    BK = tile_keys
    n_tiles = -(-seq_k // BK)
    parts = 2 if k.dtype == torch.float32 else 1
    E = BK * D

    def tiles(x):
        t = torch.zeros((BKV, n_tiles * BK, D), dtype=torch.float32,
                        device=x.device)
        t[:, :seq_k] = x[:, :seq_k].to(torch.float32)
        return t.view(BKV, n_tiles, E)

    j = torch.arange(BK, device=k.device)[:, None].expand(BK, D)
    d = torch.arange(D, device=k.device)[None, :].expand(BK, D)
    # V^T column holding key j: the inverse of the 0 2 4 6 1 3 5 7 order
    col = (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1)
    where = (_smem_word(BK, j, d).reshape(-1),
             _smem_word(D, d, col).reshape(-1))
    out = torch.empty((BKV, n_tiles, 2 * parts * E), dtype=torch.float32,
                      device=k.device)
    for h, x in enumerate((k, v)):
        big, small = tf32_split(tiles(x))
        for p, part in enumerate((big, small)[:parts]):
            out[..., (h * parts + p) * E + where[h]] = part
    return out.reshape(-1)
