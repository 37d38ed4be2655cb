"""Bit-preserving bridge from host (numpy) state trees to the port.

The JAX package's params or whole train state ``{params, opt, iv}``,
fetched to the host (``np.asarray`` per leaf), are nested dicts and lists
of numpy arrays, 0-dim counters included; ``state_from_numpy`` turns such
a tree into the port's tensors on a given device with the same
structure, shapes, dtypes and bits.  A bf16 array arrives as an
``ml_dtypes`` array that ``torch.from_numpy`` rejects, so it crosses as
its ``uint16`` bits and is viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def state_from_numpy(tree, device="cpu"):
    """Same-structure tree of tensors on ``device`` (copies the bytes)."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)
