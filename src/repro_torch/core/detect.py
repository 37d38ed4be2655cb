"""Detectors — ``repro/core/detect.py`` for the serving and training
slices.

Ordered by cost:

1. ``trap_nonfinite`` — free: inspects the already-fetched loss and
   grad-norm scalars.
2. ``trap_loss_spike`` — free: an order-of-magnitude loss jump over the
   median of the last ``LOSS_WINDOW`` losses.
3. the rotating checksum canary — digests a rotating 1/K slice of the
   protected state per step through the fused digest engine
   (``kernels/digest.py``), keeps its reference digests in a
   double-buffered pair of on-device tables and fetches one scalar "any
   mismatch?" flag per check; leaf attribution runs on the fault path
   only.  ``check_and_arm`` is the training loop's form: 1
   ``row_checksums`` launch and 1 ``fetch`` per step.

The serving engine builds it over a *view* of its state: per-block views
of the paged KV pool (``blockNNNN/<leaf>``) and per-slot views of the
position vector (``slotNNN/pos``), so digest units are (leaf, block) and
(pos, slot) pairs and a mismatch names its block or slot directly.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import digest as kdigest
from repro_torch.kernels.ops import rotating_slice
from repro_torch.tree import tree_map

#: window of the loss-spike trap; callers keep a bounded
#: ``deque(maxlen=LOSS_WINDOW)`` history
LOSS_WINDOW = 8

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
    #: 'nonfinite' | 'loss_spike' | 'checksum' | 'external'
    detector: str
    leaves: List[str] = field(default_factory=list)  # suspected leaf paths
    detail: str = ""
    #: leaf path -> injured shard ids: on a mesh the sharded canary's
    #: (mesh-flat shard order, the same on every rank); off the mesh a
    #: shard id is a parity block id, and only an external report fills
    #: it (the single-device canary attributes whole leaves).
    shards: Dict[str, List[int]] = field(default_factory=dict)
    #: deferred attribution: the hot path fetches only the scalar flag;
    #: the mismatch mask stays on the device until ``resolve``
    resolver: Optional[Callable] = \
        field(default=None, repr=False, compare=False)
    #: True when the faulting state version was consumed by the step that
    #: detected it: the in-step fused check of a donated (in-place) step
    #: overwrote it, so in-place rungs (triage, parity) must abort to
    #: snapshot + replay.  The donated pair's ``check`` runs before the
    #: step and reports ``False``.
    consumed: bool = False
    #: HARD loss: rows of the data axis whose ranks are gone (a host
    #: failure).  A non-empty tuple routes the ladder to the ``remesh``
    #: rung (``launch/elastic.py``): in-place repair is meaningless when
    #: the hardware itself is dead.
    lost_rows: Tuple[int, ...] = ()

    def resolve(self) -> List[str]:
        """Materialise ``leaves`` from a deferred attribution (and, on a
        mesh, ``shards``: a resolver may return ``(leaves, shards)``; a
        collective there, which every rank runs once the flag fired)."""
        if self.resolver is not None:
            got = self.resolver()
            if isinstance(got, tuple):
                self.leaves, self.shards = got
            else:
                self.leaves = got
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


def trap_nonfinite(step: int, metrics: Dict) -> Optional[FaultReport]:
    """A non-finite loss or grad norm (host floats or 0-dim tensors)."""
    for name in ("loss", "grad_norm"):
        v = metrics.get(name)
        if v is None:
            continue
        fv = float(v)
        if not math.isfinite(fv):
            return FaultReport(step, "nonfinite", detail=f"{name}={fv}")
    return None


def trap_loss_spike(step: int, metrics: Dict, history: Sequence[float],
                    factor: float = 10.0,
                    window: int = LOSS_WINDOW) -> Optional[FaultReport]:
    """Loss above ``factor`` × the median of the last ``window`` losses."""
    if len(history) < window:
        return None
    v = metrics.get("loss")
    if v is None:
        return None
    fv = float(v)
    ref = float(np.median(list(history)[-window:]))
    if math.isfinite(fv) and fv > factor * max(ref, 1e-6):
        return FaultReport(step, "loss_spike",
                           detail=f"loss={fv:.3g} median={ref:.3g}")
    return None


def evict_mesh(ctx) -> int:
    """Drop the check+arm cores cached on ``ctx``'s digest plans (the
    canary's per-rotation units; their packing buffers are the plans'):
    the elastic remesh calls it before the plans go."""
    mk = kdigest.mesh_key(ctx)
    n = 0
    for key, plan in kdigest._PLAN_CACHE.items():
        if key[0] == "mesh" and key[1] == mk:
            n += len(plan._check_arm)
            plan._check_arm.clear()
    return n


class ChecksumCanary:
    """Rotating-slice checksum detector over a state tree.

    ``_tables`` is the double-buffered pair of (n_leaves, 2) reference
    tables, alternating by generation: a check verifies against the read
    generation while the arm writes the other one IN PLACE, so the hot path
    allocates no table.  Both tables keep their storage for the canary's
    life (every write goes into them), so a captured CUDA graph may read
    and write them by address.  ``begin_update``/``commit_update`` hand
    the pair to a caller that runs the check+arm itself (the serving
    engine's step, the fused train step).  A full ``refresh`` re-digests
    everything and bumps the generation; a ``refresh(keys=)`` patches the
    named rows in BOTH tables and leaves the generation alone, so rows of
    other units armed earlier still verify.

    Two protocols guard a training loop:

    * ``check_and_arm(s, state, new_state)`` after a functional step: the
      check slice of the pre-step state (still intact) and the arm slice
      of the fresh output go into ONE packing buffer, ONE
      ``row_checksums`` launch and ONE scalar ``fetch``;
    * the donated pair around an in-place step: ``arm_current(s, state)``
      at the top of the loop body digests slice ``s % K`` of the state the
      previous step produced (one launch, no sync), and ``check(s,
      state)`` verifies the same slice of the same version just before the
      step overwrites it (one launch, one fetch).

    ``fuse_into_step`` moves the check and the arm inside the step
    (``core/fused_step.py``).

    On a mesh (``ctx`` enabled) ``tree`` is this rank's blocks of the
    state and the canary goes shard-local: the plan is a
    ``ShardedDigestPlan`` (every rank digests only its own blocks), each
    rank's two tables are its rows of the reference's ``(n_shards, L,
    2)`` pair, and the one fetched flag is the fault flag all-reduced
    over the mesh, so every rank takes the same branch.  Only after it
    fires is the per-(shard, leaf) mismatch mask gathered:
    ``FaultReport.shards`` names each injured leaf's shard ids, the same
    on every rank."""

    def __init__(self, tree, n_slices: int = 4, ctx=None):
        self.n_slices = max(1, n_slices)
        self.ctx = ctx if (ctx is not None and ctx.enabled) else None
        self.plan = kdigest.sharded_plan_for(tree, self.ctx) if self.ctx \
            else kdigest.plan_for(tree)
        self._keys: Tuple[str, ...] = self.plan.keys
        table = self.plan.digest_table(tree)
        self._tables = [table, table.clone()]
        self._gen = 0
        #: optional ``core.parity.ParityStore`` over the same state, kept
        #: current by every arm (see ``attach_parity``)
        self._parity = None
        #: the read table that served the most recent FIRED check (a
        #: copy: the live tables are armed in place).  ``check_and_arm``
        #: commits the generation bump before the flag is fetched, so
        #: after a fault ``reference`` is one generation ahead; repairs
        #: certify against these rows.  Set on the fault path only.
        self._fault_reference: Optional[torch.Tensor] = None

    def attach_parity(self, store) -> None:
        """Keep ``store`` current from now on: ``check_and_arm`` applies
        the gated incremental update ``old ^ new`` and ``arm`` rebuilds the
        parity of the armed tree (the donated pair sees one state version
        only), each committed as version ``step + 1``.  The store's plan
        must cover the same state structure (on a mesh, the rank's
        blocks: the update's exchange then rides the canary's calls, which
        every rank makes)."""
        self._parity = store

    @property
    def parity_store(self):
        return self._parity

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
        return self._attribution(chk, bad_mask)[0]

    def _attribution(self, chk: Sequence[int], bad_mask
                     ) -> Tuple[List[str], Dict[str, List[int]]]:
        """``_attribute`` and, on a mesh, each corrupted leaf's injured
        shard ids: the mask is gathered to ``(n_shards, len(chk))`` first
        (a collective every rank runs once the all-reduced flag fired)."""
        if self.ctx is not None:
            from repro_torch.distributed import collectives as coll
            mask = kdigest.fetch(coll.all_gather(
                bad_mask.reshape(-1), self.ctx.group(self.ctx.axis_names)))
            shards = {self._keys[i]: [int(d) for d in
                                      np.nonzero(mask[:, j])[0]]
                      for j, i in enumerate(chk) if mask[:, j].any()}
            return sorted(shards), shards
        mask = np.atleast_1d(kdigest.fetch(bad_mask))
        return sorted(self._keys[i] for i, b in zip(chk, mask) if b), {}

    def _report(self, step: int, chk: Sequence[int], bad_mask,
                read: torch.Tensor) -> FaultReport:
        self._fault_reference = read.clone()
        leaves, shards = self._attribution(chk, bad_mask)
        return FaultReport(step, "checksum", leaves=leaves, shards=shards)

    def _run(self, step: int, chk: Sequence[int], arm: Sequence[int],
             tree, armed_tree, parity: Optional[str],
             commit: bool = True) -> Optional[FaultReport]:
        """Pack slice ``chk`` of ``tree`` and slice ``arm`` of
        ``armed_tree`` into the rotation's buffer, digest it once, compare
        the check rows against the read generation, arm the rest into the
        write generation in place and bump the generation (``commit``),
        bring an attached parity up to ``armed_tree``
        (``parity='update'``: the update gated on the check's flag;
        ``'rebuild'``; None: leave it) and fetch the one flag when there
        is a check slice."""
        core, union = kdigest.check_arm_subcomputation(
            self.plan, chk, arm, n_slices=self.n_slices)
        if not union:
            return None
        kdigest.STATS.launches += 1
        buf = core.buffer()
        read, write = self.begin_update()
        leaves = self.plan.leaves(tree)
        core.pack_check(buf, [leaves[i] for i in chk])
        leaves = self.plan.leaves(armed_tree)
        core.pack_arm(buf, [leaves[i] for i in arm])
        flag, bad = core.finish(buf, read, write)
        if commit:
            self.commit_update(write)
        if self._parity is not None and parity is not None:
            pp = self._parity.plan
            if parity == "update":
                new = pp.update_leaves(self._parity.parity, pp.leaves(tree),
                                       pp.leaves(armed_tree), flag)
            else:
                new = pp.rebuild_leaves(pp.leaves(armed_tree))
            self._parity.commit(new, step + 1)
        if chk and bool(kdigest.fetch(flag)):     # the step's ONE host sync
            return self._report(step, chk, bad, read)
        return None

    def check_and_arm(self, step: int, tree, armed_tree=None
                      ) -> Optional[FaultReport]:
        """Verify slice ``step % K`` of ``tree`` against the generation
        armed last step and digest slice ``(step+1) % K`` of
        ``armed_tree`` (default ``tree``) into the next generation — one
        ``row_checksums`` launch, one scalar fetch (and, with parity
        attached, one ``xor_update_tiles`` launch).  In a training loop:
        ``(pre_step_state, post_step_state)``.  A donated loop uses the
        ``arm_current``/``check`` pair instead: its step overwrites the
        pre-step state."""
        if armed_tree is None:
            armed_tree = tree
        return self._run(step, self._slice_indices(step),
                         self._slice_indices(step + 1), tree, armed_tree,
                         parity="update")

    def check(self, step: int, tree) -> Optional[FaultReport]:
        """Verify slice ``step % K`` of ``tree`` against the read
        generation only: one launch and one scalar fetch, the tables, the
        generation and an attached parity untouched.  The check half of
        the donated pair, run just before the step overwrites ``tree``."""
        return self._run(step, self._slice_indices(step), (), tree, tree,
                         parity=None, commit=False)

    def arm(self, step: int, tree) -> None:
        """Digest the slice ``check_and_arm(step+1, ...)`` will verify into
        the next generation (one launch, no host sync); an attached parity
        is rebuilt over ``tree``."""
        self._run(step, (), self._slice_indices(step + 1), tree, tree,
                  parity="rebuild")

    def arm_current(self, step: int, tree) -> None:
        """The arm half of the donated pair: digest slice ``step % K`` of
        the live state into the next generation and bump (one launch, no
        sync; an attached parity is rebuilt over it).  Call it at the top
        of the loop body; ``check(step, tree)`` just before the step then
        verifies the same slice of the same version."""
        self.arm(step - 1, tree)

    def fuse_into_step(self, step_fn, *, donate: bool = False,
                       warm: str = "lazy", host_metrics: Sequence[str] = ()):
        """Wrap ``step_fn(state, *args) -> (new_state, aux)`` so the check
        of the input state's slice ``s % K``, the step and the arm of the
        output's slice ``(s+1) % K`` run as one unit: one captured CUDA
        graph per rotation on the card, the same phases eagerly on the
        CPU.  ``donate=True`` takes an in-place step (``step_fn`` writes
        the state's own tensors and returns them); otherwise ``step_fn`` is
        functional and the input state survives the step.  ``warm``:
        ``'eager'`` builds every rotation at the first step, ``'lazy'``
        each on first use.  ``host_metrics`` names 0-dim entries of
        ``aux`` fetched with the flag in the step's one transfer.  Returns
        a ``core.fused_step.FusedStepFactory``; drive it with
        ``factory.step(s, state, *args) -> (new_state, aux, report)``.
        On a mesh ``step_fn`` is the mesh step (``front`` / ``tail``), and
        the unit's device stretches between its collectives are the
        captured graphs."""
        from repro_torch.core.fused_step import FusedStepFactory
        return FusedStepFactory(step_fn, self, donate=donate, warm=warm,
                                host_metrics=host_metrics)

    def check_full(self, step: int, tree) -> Optional[FaultReport]:
        """Verify every leaf against the read generation (one digest, one
        fetch; meaningful right after init or refresh)."""
        table = self.plan.digest_table(tree)
        bad = (table != self.reference).any(dim=-1)
        flag = bad.any()
        if self.ctx is not None:
            from repro_torch.distributed import collectives as coll
            flag = coll.flag_max(
                flag, self.ctx.group(self.ctx.axis_names))[0] > 0
        if bool(kdigest.fetch(flag)):
            return self._report(step, range(len(self._keys)), bad,
                                self.reference)
        return None

    def reference_digests(self) -> Dict[str, np.ndarray]:
        """Host copy of the read-generation table (one fetch)."""
        table = kdigest.fetch(self.reference)
        return {k: table[i] for i, k in enumerate(self._keys)}

    def fault_reference_digests(self) -> Dict[str, np.ndarray]:
        """Host copy of the table that served the most recent FIRED check
        — what a repair must certify against; the read generation when no
        check has fired since the last full refresh."""
        table = self._fault_reference
        table = kdigest.fetch(self.reference if table is None else table)
        return {k: table[i] for i, k in enumerate(self._keys)}

    def surviving_reference_digests(self, dead):
        """``fault_reference_digests`` under a hard loss, on a mesh: every
        surviving rank's own rows, gathered over the survivors (a
        collective only they take), never a dead rank's.  ``dead`` holds
        shard ids.  Returns ``(digests, have)``: ``digests[k]`` the
        ``(n_shards, 2)`` rows with the dead shards' zeroed, ``have[d]``
        whether shard ``d``'s rows were read (the only rows a block may be
        certified against)."""
        if self.ctx is None:
            raise ValueError("surviving_reference_digests needs a "
                             "sharded canary")
        from repro_torch.distributed import collectives as coll
        surv, group = self.ctx.survivors(dead)
        table = self._fault_reference
        if table is None:
            table = self.reference
        rows = kdigest.fetch(coll.all_gather(table, group))
        out = np.zeros((self.ctx.n_devices,) + rows.shape[1:], np.int32)
        out[list(surv)] = rows
        have = np.zeros(self.ctx.n_devices, bool)
        have[list(surv)] = True
        return {k: out[:, i] for i, k in enumerate(self._keys)}, have

    def fault_reference_digest(self, key: str) -> np.ndarray:
        """One leaf's row of ``fault_reference_digests``: the int32[2]
        pair the triage rung solves ``kernels.digest.locate_single_flip``
        against."""
        table = self._fault_reference
        if table is None:
            table = self.reference
        return kdigest.fetch(table[self.plan.index_of(key)])

    def begin_update(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(read_table, write_table) for one check+arm generation."""
        return self._tables[self._gen & 1], self._tables[(self._gen + 1) & 1]

    def commit_update(self, new_write: torch.Tensor) -> None:
        """Install the armed write table (written in place; a new tensor
        is copied into it) and bump the generation."""
        write = self._tables[(self._gen + 1) & 1]
        if new_write is not write:
            write.copy_(new_write)
        self._gen += 1

    def refresh(self, tree, keys: Optional[Sequence[str]] = None) -> None:
        """Re-digest the whole table (bumps the generation) or only the
        named leaves (patched in both generations, no bump)."""
        if keys is None:
            self._gen += 1
            self._tables[self._gen & 1].copy_(self.plan.digest_table(tree))
            self._fault_reference = None
            return
        idx = sorted(self.plan.index_of(k) for k in keys)
        if not idx:
            return
        rows = torch.tensor(idx, dtype=torch.int64,
                            device=self.reference.device)
        sub = self.plan.digest_subset(tree, idx)
        for t in self._tables:
            t.index_copy_(0, rows, sub)
