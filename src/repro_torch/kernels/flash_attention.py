"""Wrapper of the flash-attention kernel — counterpart of
``repro/kernels/flash_attention.py``.

Online-softmax attention over q ``(BH, Sq, D)`` and k/v ``(BKV, Sk, D)``
(GQA: q row ``b`` reads kv row ``b // G``, G = BH // BKV), causal and
sliding-window masks, tanh soft-capping, f32 accumulation.  A CPU tensor
takes the plain version (``ref.flash_attention_ref``); a CUDA tensor
launches ``csrc/flash_attention.cu`` or raises — there is no fallback.
On the card one call is two launches: ``flash_layout_kv`` splits K and V
into TF32 parts in the tensor cores' shared-memory layout (a scratch
allocated here), then ``flash_attention_bhsd`` runs both products on the
tensor cores in three TF32 passes (``ref.flash_attention_3xtf32`` is its
arithmetic in plain PyTorch).

Forward only, as in the reference (which has no ``custom_vjp`` for it):
on the card an input that requires grad is refused rather than given an
output with no gradient.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (16, 32, 48, 64, 128, 160, 256)   # D the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: keys per K/V record at each head dim (``Cfg<D>::BK`` of the .cu)
TILE_KEYS = {16: 64, 32: 64, 48: 64, 64: 64, 128: 32, 160: 16, 256: 8}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, seq_k: Optional[int]) -> int:
    """Shape checks of both routes; returns the number of live keys."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention_bhsd: need q (BH, Sq, D) and "
                         f"k/v (BKV, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] == 0 or q.shape[0] % k.shape[0]:
        raise ValueError(f"flash_attention_bhsd: BH = {q.shape[0]} is not a "
                         f"multiple of BKV = {k.shape[0]}")
    if window < 0:
        raise ValueError(f"flash_attention_bhsd: window {window} < 0")
    n = k.shape[1] if seq_k is None else int(seq_k)
    if not 0 <= n <= k.shape[1]:
        raise ValueError(f"flash_attention_bhsd: seq_k {n} outside "
                         f"[0, {k.shape[1]}]")
    return n


def check_kernel_args(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> None:
    """What the card's kernel takes beyond the shapes: f32 or bf16 (one
    dtype for q, k and v), a head dim in ``HEAD_DIMS``, no autograd."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_bhsd: the kernel takes float32 "
                         f"or bfloat16 (one dtype), got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bhsd: head dim {q.shape[-1]} not "
                         f"built (built: {HEAD_DIMS})")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attention_bhsd: forward only (the kernel "
                         "has no backward); detach the inputs")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         seq_k: Optional[int] = None) -> torch.Tensor:
    """o ``(BH, Sq, D)`` in q's dtype.  Keys ``seq_k`` and past (default:
    none) are not attended to, as if k/v held only the first ``seq_k``
    rows; q, k and v must be contiguous on the card."""
    n = _check_shapes(q, k, v, window, seq_k)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k[:, :n], v[:, :n], causal=causal,
                                        window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: unsupported device "
                         f"{q.device}")
    check_kernel_args(q, k, v)
    _build.require_cuda("flash_attention_bhsd", q, k, v, aligned=False)
    BH, Sq, D = q.shape
    BKV, Sk, _ = k.shape
    lib, dt, stream = _build.lib(), _DTYPES[q.dtype], _build.stream_of(q)
    records = flash_layout_kv(k, v, seq_k=n)
    out = torch.empty_like(q)
    rc = lib.repro_flash_attention_bhsd(
        q.data_ptr(), v.data_ptr(), records.data_ptr(), out.data_ptr(), BH,
        BKV, Sq, Sk, n, D, dt, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(D), stream)
    _build.check(rc, "flash_attention_bhsd")
    _build.LAUNCHES["flash_attention_bhsd"] += 1
    return out


def flash_layout_kv(k: torch.Tensor, v: torch.Tensor,
                    seq_k: Optional[int] = None) -> torch.Tensor:
    """The K/V records ``flash_attention_bhsd`` reads: k/v ``(BKV, Sk, D)``
    split once into TF32 parts in the tensor cores' layout, one record per
    (kv row, tile of ``TILE_KEYS[D]`` keys), flat f32
    (``ref.flash_layout_kv_ref`` on a CPU tensor, the layout kernel on a
    CUDA tensor).  Keys ``seq_k`` and past are written as zeros."""
    n = k.shape[1] if seq_k is None else int(seq_k)
    D = k.shape[2]
    if k.device.type == "cpu":
        return _ref.flash_layout_kv_ref(k, v, n, TILE_KEYS[D])
    check_kernel_args(k, k, v)
    _build.require_cuda("flash_layout_kv", k, v, aligned=False)
    BKV, Sk, _ = k.shape
    lib, dt = _build.lib(), _DTYPES[k.dtype]
    n_records = BKV * -(-n // lib.repro_flash_tile_keys(D, dt))
    records = torch.empty(n_records * lib.repro_flash_record_words(D, dt),
                          dtype=torch.float32, device=k.device)
    if records.numel():
        rc = lib.repro_flash_layout_kv(k.data_ptr(), v.data_ptr(),
                                       records.data_ptr(), BKV, Sk, n, D, dt,
                                       _build.stream_of(k))
        _build.check(rc, "flash_layout_kv")
        _build.LAUNCHES["flash_layout_kv"] += 1
    return records
