"""Public kernel-level helpers — the part of ``repro/kernels/ops.py`` the
serving slice runs."""

from __future__ import annotations

from typing import List


def rotating_slice(step: int, n_slices: int, n_leaves: int) -> List[int]:
    """Indices of the leaves checked at ``step`` under the rotating-canary
    schedule (full coverage every n_slices steps at 1/n_slices the cost)."""
    return [i for i in range(n_leaves) if i % n_slices == step % n_slices]
