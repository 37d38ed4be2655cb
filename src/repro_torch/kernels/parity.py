"""Wrappers of the XOR parity kernels — counterpart of
``repro/kernels/parity.py``.

XOR is bit-exact, so a lost or corrupt block is reconstructed with its
exact bits from the parity and its surviving peers.  ``xor_fold_tiles``
builds the parity, ``xor_update_tiles`` keeps it current every training
step.  A CPU tensor takes the plain version (``kernels/ref.py``); a CUDA
tensor launches ``csrc/parity.cu`` or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

LANES = _ref.LANES
TILE_ROWS = _ref.TILE_ROWS


def _check_tiles(name: str, x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 4 or x.shape[0] < 1 \
            or tuple(x.shape[2:]) != (TILE_ROWS, LANES):
        raise ValueError(f"{name}: {what} must be int32 (n >= 1, nt, "
                         f"{TILE_ROWS}, {LANES}), got {x.dtype} "
                         f"{tuple(x.shape)}")


def xor_fold_tiles(x: torch.Tensor) -> torch.Tensor:
    """``x``: ``(R, nt, TILE_ROWS, LANES)`` int32 -> the parity
    ``(nt, TILE_ROWS, LANES)``, XOR over the R rows, as a new tensor."""
    _check_tiles("xor_fold_tiles", x, "x")
    if x.device.type == "cpu":
        return _ref.xor_fold_tiles_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"xor_fold_tiles: unsupported device {x.device}")
    _build.require_cuda("xor_fold_tiles", x)
    out = torch.empty(x.shape[1:], dtype=torch.int32, device=x.device)
    rc = _build.lib().repro_xor_fold_tiles(
        x.data_ptr(), x.shape[0], out.numel(), out.data_ptr(),
        _build.stream_of(x))
    _build.check(rc, "xor_fold_tiles")
    _build.LAUNCHES["xor_fold_tiles"] += 1
    return out


def xor_update_tiles(x: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """Incremental parity update ``parity ^= XOR_d x[d]``, in place.

    ``x``: ``(D, nt, TILE_ROWS, LANES)`` int32 per-block deltas (``old ^
    new``); ``parity``: ``(nt, TILE_ROWS, LANES)`` int32, returned (same
    storage: the steady-state update allocates nothing).
    ``xor_update_tiles(x, zeros)`` equals ``xor_fold_tiles(x)``."""
    _check_tiles("xor_update_tiles", x, "x")
    if parity.dtype != torch.int32 or tuple(parity.shape) != tuple(
            x.shape[1:]):
        raise ValueError(f"xor_update_tiles: parity must be int32 "
                         f"{tuple(x.shape[1:])}, got {parity.dtype} "
                         f"{tuple(parity.shape)}")
    if x.device.type == "cpu":
        return _ref.xor_update_tiles_ref(x, parity)
    if x.device.type != "cuda":
        raise ValueError(f"xor_update_tiles: unsupported device {x.device}")
    _build.require_cuda("xor_update_tiles", x, parity)
    rc = _build.lib().repro_xor_update_tiles(
        x.data_ptr(), x.shape[0], parity.numel(), parity.data_ptr(),
        _build.stream_of(x))
    _build.check(rc, "xor_update_tiles")
    _build.LAUNCHES["xor_update_tiles"] += 1
    return parity
