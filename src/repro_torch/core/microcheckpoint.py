"""Micro-checkpoints — the paper's Algorithm 2 at training-loop scale;
counterpart of ``repro/core/microcheckpoint.py`` (single device).

* **IV micro-checkpoint** (every step, bytes): the iv block, kept where
  the recovery runtime can always reach it.
* **state snapshot** (every K steps, double-buffered, host RAM): a full
  train-state copy + per-leaf digests, giving the replay rung a nearby
  anchor.  No disk I/O on the recovery path.

The snapshot is ONE read of the live state (a real host copy); its
digests are computed from that copy on the host (numpy uint32
arithmetic, bit-identical to the device digest), so they certify exactly
the bytes stored.

On a mesh (``ctx`` and the state's ``shardings``) every rank snapshots
its own blocks, and a snapshot also records, per leaf, the global index
box of every shard id (``shard_slices``, shard order) and this rank's
block digest (``shard_digests``: the digest of exactly the bytes the
shard_patch rung would restore).  ``verify_shards`` certifies the named
(leaf, shard) units this rank holds; the recovery runtime all-reduces
every rank's verdict.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import digest as kdigest
from repro_torch.tree import flatten_with_path, leaf_key, leaves, tree_map


def host_copy(tree):
    """Host copy of a state tree: every leaf a new CPU tensor that owns
    its bytes (``copy=True`` also for leaves already on the CPU, so a
    later in-place write to the live state cannot reach the copy).
    Shared by the micro-checkpointer and ``checkpoint.store``."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


@dataclass
class Snapshot:
    step: int
    state: object                    # host tree (CPU tensors)
    digests: Dict[str, np.ndarray]
    nbytes: int = 0                  # cached at snapshot time
    wall: float = field(default_factory=time.time)
    #: mesh only: per leaf, the index box of every shard id, and this
    #: rank's block digest (the rank's shard id is ``shard_id``)
    shard_slices: Optional[Dict[str, List]] = None
    shard_digests: Optional[Dict[str, np.ndarray]] = None
    shard_id: int = 0


class MicroCheckpointer:
    """Double-buffered host snapshots + per-step IV micro-checkpoints."""

    def __init__(self, interval: int = 8, keep: int = 2, ctx=None,
                 shardings=None):
        self.interval = max(1, interval)
        self.keep = max(1, keep)
        self.ctx = ctx if (ctx is not None and ctx.enabled) else None
        if self.ctx is not None and shardings is None:
            raise ValueError("a mesh snapshot needs the state's shardings")
        self.shardings = shardings
        self.snapshots: List[Snapshot] = []
        self.iv_log: Dict[int, Dict[str, int]] = {}

    def record_iv(self, step: int, iv: Dict) -> None:
        """Log the iv block (one device→host transfer for all counters)."""
        names = sorted(iv)
        vals = torch.stack([iv[k] for k in names]).tolist()
        self.iv_log[step] = dict(zip(names, vals))
        if len(self.iv_log) > 4 * self.interval:       # bounded window
            for s in sorted(self.iv_log)[:-2 * self.interval]:
                del self.iv_log[s]

    def maybe_snapshot(self, step: int, state) -> bool:
        if step % self.interval != 0:
            return False
        self.snapshot(step, state)
        return True

    def snapshot(self, step: int, state) -> None:
        host = host_copy(state)
        digests = kdigest.host_tree_checksums(host)
        slices = None
        if self.ctx is not None:
            slices = {leaf_key(p): kdigest.shard_indices(sh)
                      for p, sh in flatten_with_path(self.shardings)}
        self.snapshots.append(Snapshot(
            step=step, state=host, digests=digests,
            nbytes=sum(t.numel() * t.element_size() for t in leaves(host)),
            shard_slices=slices,
            # a rank's block digest is its per-leaf digest
            shard_digests=digests if slices is not None else None,
            shard_id=self.ctx.shard_id if self.ctx is not None else 0))
        if len(self.snapshots) > self.keep:
            self.snapshots.pop(0)

    def latest(self, before: Optional[int] = None) -> Optional[Snapshot]:
        cands = [s for s in self.snapshots
                 if before is None or s.step <= before]
        return cands[-1] if cands else None

    def verify(self, snap: Snapshot) -> List[str]:
        """Digest-verify a snapshot before trusting it for replay
        (exact-or-abort), host-side, no device upload."""
        return kdigest.host_verify_tree(snap.state, snap.digests)

    def verify_shards(self, snap: Snapshot,
                      shards: Dict[str, List[int]]) -> List[str]:
        """Digest-verify the named (leaf, shard) units of a snapshot that
        this rank holds — the shard_patch rung's exact-or-abort gate;
        returns the ``"leaf@shard"`` names that fail (empty: certified).
        Host-side, no device work."""
        if snap.shard_slices is None or snap.shard_digests is None:
            return sorted(f"{k}@{d}" for k, ds in shards.items() for d in ds)
        host = {leaf_key(p): t for p, t in flatten_with_path(snap.state)}
        bad = []
        for key, ids in shards.items():
            if snap.shard_id not in ids:
                continue
            ref = snap.shard_digests.get(key)
            leaf = host.get(key)
            if ref is None or leaf is None or not np.array_equal(
                    kdigest.host_checksum(leaf), ref):
                bad.append(f"{key}@{snap.shard_id}")
        return sorted(bad)

    @property
    def memory_bytes(self) -> int:
        return sum(s.nbytes for s in self.snapshots)
