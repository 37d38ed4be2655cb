"""Detectors — the serving slice of ``repro/core/detect.py``.

The rotating checksum canary digests a rotating 1/K slice of the protected
state per step through the fused digest engine (``kernels/digest.py``),
keeps its reference digests in a double-buffered pair of on-device tables
and fetches one scalar "any mismatch?" flag per check; leaf attribution
runs on the fault path only.

The serving engine builds it over a *view* of its state: per-block views
of the paged KV pool (``blockNNNN/<leaf>``) and per-slot views of the
position vector (``slotNNN/pos``), so digest units are (leaf, block) and
(pos, slot) pairs and a mismatch names its block or slot directly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import digest as kdigest
from repro_torch.kernels.ops import rotating_slice
from repro_torch.tree import tree_map

_SLOT_RE = re.compile(r"^slot(\d+)/")
#: owned pool blocks appear as ``slotNNN/blockNNNN/<leaf>`` after
#: ownership translation — matched mid-path, hence ``(?:^|/)``
_BLOCK_RE = re.compile(r"(?:^|/)block(\d+)/")


def slot_leaf_prefix(slot: int) -> str:
    """Canonical view key for one slot (zero-padded so string-sorted plan
    keys group by slot)."""
    return f"slot{slot:03d}"


def slot_view(tree, n_slots: int) -> Dict:
    """Per-slot view of a slot-major tree (every leaf ``[slot, ...]``):
    ``slotNNN/<leaf path>`` keys over views that alias the tree's
    storage."""
    return {slot_leaf_prefix(u): tree_map(lambda t: t[u], tree)
            for u in range(n_slots)}


def slot_of_leaf(key: str) -> Optional[int]:
    m = _SLOT_RE.match(key)
    return int(m.group(1)) if m else None


def block_leaf_prefix(block: int) -> str:
    """Canonical view key for one pool block."""
    return f"block{block:04d}"


def block_view(pool, n_blocks: int) -> Dict:
    """Per-block view of a block-major pool (every leaf ``[block, ...]``):
    ``blockNNNN/<leaf path>`` keys — (leaf, block) canary units."""
    return {block_leaf_prefix(b): tree_map(lambda t: t[b], pool)
            for b in range(n_blocks)}


def block_of_leaf(key: str) -> Optional[int]:
    """Pool block id in a raw (``block0007/...``) or ownership-translated
    (``slot001/block0007/...``) key; None for non-block keys."""
    m = _BLOCK_RE.search(key)
    return int(m.group(1)) if m else None


@dataclass
class FaultReport:
    step: int
    detector: str               # 'nonfinite' | 'checksum' | 'external'
    leaves: List[str] = field(default_factory=list)  # suspected leaf paths
    detail: str = ""
    #: deferred attribution: the hot path fetches only the scalar flag;
    #: the mismatch mask stays on the device until ``resolve``
    resolver: Optional[Callable] = \
        field(default=None, repr=False, compare=False)

    def resolve(self) -> List[str]:
        """Materialise ``leaves`` from a deferred attribution."""
        if self.resolver is not None:
            self.leaves = self.resolver()
            self.resolver = None
        return self.leaves

    def injured_slots(self) -> List[int]:
        return sorted({s for s in (slot_of_leaf(k) for k in self.resolve())
                       if s is not None})

    def injured_blocks(self) -> List[int]:
        return sorted({b for b in (block_of_leaf(k) for k in self.resolve())
                       if b is not None})

    def __str__(self):
        where = (f" leaves={self.leaves[:3]}"
                 f"{'...' if len(self.leaves) > 3 else ''}"
                 if self.leaves else "")
        return (f"FaultReport(step={self.step}, {self.detector}{where} "
                f"{self.detail})")


class ChecksumCanary:
    """Rotating-slice checksum detector over a state tree.

    ``_tables`` is the double-buffered pair of (n_leaves, 2) reference
    tables, alternating by generation: a check verifies against the read
    generation while the arm writes the other one IN PLACE, so the hot path
    allocates no table.  ``begin_update``/``commit_update`` hand the pair
    to a caller that runs the check+arm itself (the serving engine's
    step).  A full ``refresh`` re-digests everything and bumps the
    generation; a ``refresh(keys=)`` patches the named rows in BOTH tables
    and leaves the generation alone, so rows of other units armed earlier
    still verify."""

    def __init__(self, tree, n_slices: int = 4):
        self.n_slices = max(1, n_slices)
        self.plan = kdigest.plan_for(tree)
        self._keys: Tuple[str, ...] = self.plan.keys
        table = self.plan.digest_table(tree)
        self._tables = [table, table.clone()]
        self._gen = 0

    @property
    def generation(self) -> int:
        return self._gen

    @property
    def reference(self) -> torch.Tensor:
        """The read-generation on-device reference table."""
        return self._tables[self._gen & 1]

    def _slice_indices(self, step: int) -> List[int]:
        return rotating_slice(step, self.n_slices, len(self._keys))

    def _attribute(self, chk: Sequence[int], bad_mask) -> List[str]:
        """Fault path only: fetch the mismatch mask (the one extra
        transfer) and name the corrupted leaf paths."""
        mask = np.atleast_1d(kdigest.fetch(bad_mask))
        return sorted(self._keys[i] for i, b in zip(chk, mask) if b)

    def begin_update(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(read_table, write_table) for one check+arm generation."""
        return self._tables[self._gen & 1], self._tables[(self._gen + 1) & 1]

    def commit_update(self, new_write: torch.Tensor) -> None:
        """Install the armed write table and bump the generation."""
        self._tables[(self._gen + 1) & 1] = new_write
        self._gen += 1

    def refresh(self, tree, keys: Optional[Sequence[str]] = None) -> None:
        """Re-digest the whole table (bumps the generation) or only the
        named leaves (patched in both generations, no bump)."""
        if keys is None:
            self._gen += 1
            self._tables[self._gen & 1] = self.plan.digest_table(tree)
            return
        idx = sorted(self.plan.index_of(k) for k in keys)
        if not idx:
            return
        rows = torch.tensor(idx, dtype=torch.int64,
                            device=self.reference.device)
        sub = self.plan.digest_subset(tree, idx)
        for t in self._tables:
            t.index_copy_(0, rows, sub)
