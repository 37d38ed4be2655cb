"""Fault injection — the single-bit-flip adversary of ``repro/core/faults.py``.

The reference's ``flip_bit`` returned a new array; the port flips the bit
IN PLACE through an int32 view of the tensor's storage, which is what an
upset in device memory does and what keeps the engine's in-place state
(and the pointers its kernels hold) stable.
"""

from __future__ import annotations

import torch

def _signed_mask(bit: int) -> int:
    """1 << bit as a signed 32-bit value (wraps the sign bit)."""
    m = 1 << bit
    return m - (1 << 32) if m >= 1 << 31 else m


def flip_bit(t: torch.Tensor, element: int, bit: int) -> torch.Tensor:
    """Flip ``bit`` of flat element ``element`` of a contiguous 4-byte
    tensor, in place.  Returns ``t``."""
    if t.element_size() != 4 or not t.is_contiguous():
        raise TypeError(f"flip_bit: contiguous 4-byte tensors only, "
                        f"got {t.dtype}")
    if not 0 <= bit < 32:
        raise ValueError(f"flip_bit: bit {bit} out of range")
    words = t.view(-1).view(torch.int32)
    words[element:element + 1].bitwise_xor_(_signed_mask(bit))
    return t
