"""Wrapper of the triple-modular-redundancy vote kernel — counterpart of
``repro/kernels/vote.py``.

Repairs a corrupted replicated leaf from three synchronously updated
copies: each output bit is the majority of the three input bits.  A CPU
tensor takes the plain version (``kernels/ref.py``); a CUDA tensor
launches ``csrc/vote.cu`` or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref


def vote3_tiles(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """Bitwise majority ``(a & b) | (a & c) | (b & c)`` of three flat
    int32 vectors of one length (``ref.to_i32`` views), as a new vector.
    Every operand must be contiguous; any base alignment."""
    if a.device.type == "cpu":
        return _ref.vote3_tiles_ref(a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"vote3_tiles: unsupported device {a.device}")
    for t in (a, b, c):
        if t.dtype != torch.int32 or t.dim() != 1 or t.numel() != a.numel():
            raise ValueError("vote3_tiles: need three 1-D int32 tensors of "
                             "one length")
    _build.require_cuda("vote3_tiles", a, b, c, aligned=False)
    out = torch.empty_like(a)
    rc = _build.lib().repro_vote3_tiles(a.data_ptr(), b.data_ptr(),
                                        c.data_ptr(), out.data_ptr(),
                                        a.numel(), _build.stream_of(a))
    _build.check(rc, "vote3_tiles")
    _build.LAUNCHES["vote3_tiles"] += 1
    return out
