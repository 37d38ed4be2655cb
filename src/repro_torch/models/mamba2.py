"""Pieces of ``repro/models/mamba2.py`` the port's other families share.
Only the depthwise causal convolution so far (the xLSTM blocks use it);
the Mamba-2 model itself is not ported (ROADMAP.md queue 1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over time.  xbc (B,S,C); w (K,C).  The K taps
    accumulate in f32 in order ``i = 0..K-1``, then the bias; the result
    is cast to the input's dtype, as in the reference."""
    K = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    acc = 0.0
    for i in range(K):
        acc = acc + pad[:, i:i + S, :].to(torch.float32) * \
            w[i][None, None, :].to(torch.float32)
    return (acc + b.to(torch.float32)).to(xbc.dtype)
