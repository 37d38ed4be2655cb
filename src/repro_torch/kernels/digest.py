"""Fused state digesting — the DigestPlan engine (single device).

Counterpart of ``repro/kernels/digest.py``.  A ``DigestPlan`` is computed
once per state structure (sorted leaf keys, shapes, dtypes, device): a flat
int32 packing layout where every leaf owns a private row-aligned
(128-element / 512 B) range, plus the row→leaf segment map and per-row
offsets the exact combine needs.  A digest is

  1. ``checksum.pack_rows`` — every selected leaf's int32 bits into one
     persistent packing buffer, in place (one launch per call);
  2. ONE ``checksum.row_checksums`` launch over the whole buffer;
  3. the exact combine into per-leaf Fletcher pairs, in int64 masked to
     32 bits: ``s1 = Σ_r s1_r`` and ``s2 = Σ_r (s2_r + off_r·s1_r)``.

The (L, 2) int32 table equals the reference's bit for bit on the same
bytes, with the same sorted key order, so the two packages' canaries line
up row for row.

The reference built the check+arm of one canary rotation as one jitted
subcomputation; XLA scheduled the check slice's reads before the step's
in-place writes.  PyTorch runs eagerly, so ``check_arm_subcomputation``
returns an object whose phases the caller orders by hand: ``pack_check``
before any write to the state, ``pack_arm`` after the step, then
``finish`` (one ``row_checksums`` launch, the combine, the on-device
compare and the in-place arm of the write table).

``STATS`` counts logical digest launches and host syncs; every
device→host crossing of the subsystem goes through ``fetch``.

On a mesh (``ShardedDigestPlan``, ``sharded_plan_for``) every rank holds
only its own blocks of the state, and the guards make every block of a
leaf the same shape on every rank, so every rank runs the single-device
plan above unchanged over its own blocks: its ``PackRing``, ``pack_rows``
and one ``row_checksums`` launch a check.  The reference's
``(n_shards, L, 2)`` tables are the ranks' ``(L, 2)`` tables stacked in
shard order (``gather_table``), and a rotation's compare and arm run on
each rank's own rows; the only collective of a steady check is the fault
flag all-reduced with MAX (``ShardedCheckArm``), so a check stays one
launch and one fetch on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels import checksum as _ck
from repro_torch.kernels import ref as _ref

LANES = _ck.LANES
TILE_ROWS = _ck.TILE_ROWS
_MASK32 = 0xFFFFFFFF
#: words of the largest transient packing buffer: an off-hot-path digest
#: of more leaves goes through several (a larger leaf alone), so digesting
#: a whole state never holds a second, widened copy of it on the card
TRANSIENT_WORDS = 1 << 28

leaf_key = _tree.leaf_key


@dataclass
class DigestStats:
    """Hot-path accounting for the detection-cost model."""
    launches: int = 0   # logical digest invocations
    syncs: int = 0      # device→host transfers

    def reset(self) -> None:
        self.launches = self.syncs = 0

    def snapshot(self) -> Tuple[int, int]:
        return (self.launches, self.syncs)


STATS = DigestStats()


def fetch(x: torch.Tensor) -> np.ndarray:
    """The ONLY device→host crossing in the digest subsystem — counted."""
    STATS.syncs += 1
    return x.detach().cpu().numpy()


@dataclass(frozen=True)
class LeafSpec:
    key: str
    index: int          # position in the plan's canonical (sorted-key) order
    size: int           # int32 words (== element count; to_i32 is 1:1)
    n_rows: int         # row-aligned footprint: max(1, ceil(size/LANES))


class _Layout:
    """Packing layout of one leaf subset, given as ``parts``: the leaves
    of each part in order, each part padded to whole ``TILE_ROWS`` (a
    plain subset is one part; a canary rotation's check and arm slices in
    the plan's ring are two).  Holds the element ``starts`` per leaf, the
    element offset within its leaf of every row of the padded buffer
    (fill and pad rows stay all-zero, so they add nothing) and each
    segment's row range ``[lo, hi)``: the rows of one leaf are
    contiguous, so its sums are differences of running sums.  A leaf's
    digest reads only its own rows and their offsets within the leaf, so
    it does not depend on where a layout places it."""

    def __init__(self, parts: Sequence[Sequence[LeafSpec]], key=None):
        self.key = key
        specs = [sp for part in parts for sp in part]
        self.n_seg = len(specs)
        lo = np.zeros(self.n_seg, np.int64)
        self.starts: List[int] = []
        r = j = 0
        for part in parts:
            for sp in part:
                lo[j] = r
                self.starts.append(r * LANES)
                r += sp.n_rows
                j += 1
            r = -(-r // TILE_ROWS) * TILE_ROWS
        self.padded_rows = r
        n_rows = np.array([sp.n_rows for sp in specs], np.int64)
        off = np.zeros(self.padded_rows, np.int64)
        for l0, n in zip(lo, n_rows):
            off[l0:l0 + n] = np.arange(n) * LANES
        hi = lo + n_rows
        self._host = (off, lo, hi)
        self._dev: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def maps(self, device) -> Tuple[torch.Tensor, ...]:
        """``(off, lo, hi)`` on ``device``, uploaded at first use (a
        captured CUDA graph must find them there already)."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = tuple(torch.from_numpy(a).to(device)
                                   for a in self._host)
        return self._dev[key]


class PackRing:
    """ONE packing allocation for the K rotating slices of a canary: the
    slices in rotation order, each padded to whole tiles, starting at the
    smallest and ending with that slice once more.  A rotation's
    check+arm union (slices j, j+1 mod K) is a view of two neighbouring
    ring slots, a single slice (the donated pair's check or arm) a view of
    one, so a plan's K rotations hold each word (K+1)/K times at most
    (plus the tile pads) instead of twice for the unions and once more
    for the pair.  Neighbouring rotations share a slot: the steps and
    graphs run one after another, and each packs every slice of its view
    before digesting it, always at the same place within the slot."""

    def __init__(self, plan: "DigestPlan", n_slices: int):
        K = n_slices
        self.slices = [tuple(range(j, plan.n_leaves, K)) for j in range(K)]
        rows = [plan.layout(s).padded_rows for s in self.slices]
        first = int(np.argmin(rows))
        #: slot p holds slice ``order[p]``; slot K repeats slot 0
        self.order = [(first + p) % K for p in range(K)] + [first]
        self.row0 = np.concatenate(
            [[0], np.cumsum([rows[j] for j in self.order])]).astype(np.int64)
        self.buf = torch.zeros(int(self.row0[-1]) * LANES,
                               dtype=torch.int32, device=plan.device)
        self._slot = {s: p for p, s in
                      ((p, self.slices[j]) for p, j in
                       enumerate(self.order[:K])) if s}

    def place(self, chk: Tuple[int, ...], arm: Tuple[int, ...]
              ) -> Optional[Tuple[int, int]]:
        """Ring slots ``[a, b)`` whose rows hold ``chk + arm`` laid out
        part by part, or None when it is not one slice or a slice and its
        successor."""
        if chk and arm:
            p = self._slot.get(chk)
            if p is None or self.slices[self.order[p + 1]] != arm:
                return None
            return p, p + 2
        p = self._slot.get(chk or arm)
        return None if p is None else (p, p + 1)

    def view(self, a: int, b: int) -> torch.Tensor:
        return self.buf[int(self.row0[a]) * LANES:int(self.row0[b]) * LANES]


class DigestPlan:
    """Packing layout + digest machinery for one state structure.

    The canonical leaf order is sorted-by-path, as in the reference."""

    def __init__(self, keys: Tuple[str, ...], sizes: Tuple[int, ...],
                 device: torch.device):
        self.keys = keys                       # sorted
        self.device = device
        self.specs = tuple(
            LeafSpec(key=k, index=i, size=s, n_rows=max(1, -(-s // LANES)))
            for i, (k, s) in enumerate(zip(keys, sizes)))
        self.n_leaves = len(keys)
        self.n_rows = sum(sp.n_rows for sp in self.specs)
        self._key_to_index = {k: i for i, k in enumerate(keys)}
        self._layouts: Dict[Tuple, _Layout] = {}
        self._pack_bufs: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._rings: Dict[int, PackRing] = {}
        #: ring views the canary's rotations took, by subset
        self._ring_views: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._descs: Dict[Tuple, Tuple[Tuple[int, ...],
                                       _ck.PackDescriptors]] = {}
        self._check_arm: Dict[Tuple, "CheckArm"] = {}

    # -- leaf extraction ---------------------------------------------------

    def leaves(self, tree) -> List[torch.Tensor]:
        """Tree leaves in the plan's canonical (sorted-key) order; rejects a
        tree whose leaf paths differ from the plan's."""
        by_key = {leaf_key(p): x for p, x in _tree.flatten_with_path(tree)}
        if len(by_key) != self.n_leaves or any(k not in by_key
                                               for k in self.keys):
            raise ValueError("tree structure does not match DigestPlan")
        return [by_key[k] for k in self.keys]

    def index_of(self, key: str) -> int:
        return self._key_to_index[key]

    def layout(self, idx: Sequence[int]) -> _Layout:
        """The one-part layout of subset ``idx``."""
        return self.parts_layout((tuple(idx),))

    def parts_layout(self, parts: Tuple[Tuple[int, ...], ...]) -> _Layout:
        """The layout of ``parts`` (subsets), each padded to whole tiles."""
        lay = self._layouts.get(parts)
        if lay is None:
            lay = _Layout([[self.specs[i] for i in p] for p in parts],
                          key=parts)
            self._layouts[parts] = lay
        return lay

    # -- persistent packing buffers ----------------------------------------

    def _new_buffer(self, idx: Tuple[int, ...]) -> torch.Tensor:
        return torch.zeros(self.layout(idx).padded_rows * LANES,
                           dtype=torch.int32, device=self.device)

    def take_buffer(self, indices: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
        """The subset's own persistent packing buffer.  Taking it REGISTERS
        the subset as hot-path-persistent (a canary rotation outside a
        ``PackRing``); other subsets digest through a transient buffer.  The pack and the
        digest write it in place, so there is nothing to put back."""
        idx = tuple(range(self.n_leaves)) if indices is None \
            else tuple(indices)
        buf = self._pack_bufs.get(idx)
        if buf is None:
            buf = self._new_buffer(idx)
            self._pack_bufs[idx] = buf
        return buf

    def ring(self, n_slices: int) -> PackRing:
        """The ring of the K-slice canary's rotating slices, allocated at
        first use and kept for the plan's life."""
        ring = self._rings.get(n_slices)
        if ring is None:
            ring = PackRing(self, n_slices)
            self._rings[n_slices] = ring
        return ring

    def buffer_pointer(self, indices: Optional[Sequence[int]] = None):
        """Device address of the subset's packing buffer, a ring view
        included (None before first use) — the steady-state buffer-reuse
        probe."""
        idx = tuple(range(self.n_leaves)) if indices is None \
            else tuple(indices)
        buf = self._ring_views.get(idx, self._pack_bufs.get(idx))
        return None if buf is None else buf.data_ptr()

    def buffer_pointers(self) -> Dict[Tuple[int, ...], int]:
        """Every persistent packing buffer's address, by subset."""
        return {idx: self.buffer_pointer(idx)
                for idx in (*self._pack_bufs, *self._ring_views)}

    # -- the three digest phases -------------------------------------------

    def descriptors(self, lay: _Layout, leaves: Sequence[torch.Tensor],
                    first: int = 0) -> Optional[_ck.PackDescriptors]:
        """A fresh ``pack_rows`` schedule of ``leaves`` (positions
        ``first ..`` of layout ``lay``) on the card, None on the CPU.  A
        caller that captures the pack in a CUDA graph keeps it alive as
        long as the graph: the graph reads it by address."""
        if self.device.type != "cuda" or not leaves:
            return None
        return _ck.pack_descriptors(
            leaves, lay.starts[first:first + len(leaves)], self.device)

    def pack(self, buf: torch.Tensor, lay: _Layout,
             leaves: Sequence[torch.Tensor], first: int = 0,
             desc: Optional[_ck.PackDescriptors] = None) -> None:
        """Pack ``leaves`` — positions ``first .. first+len-1`` of layout
        ``lay`` — into ``buf`` (one ``pack_rows`` launch).  On the card
        the kernel's schedule (``checksum.pack_descriptors``) is ``desc``
        when given, else cached per (layout, part) and rebuilt and
        re-uploaded only when a leaf's base pointer changed."""
        if not leaves:
            return
        starts = lay.starts[first:first + len(leaves)]
        if buf.device.type == "cuda" and desc is None:
            ptrs = tuple(x.data_ptr() for x in leaves)
            key = (lay.key, first, len(leaves))
            hit = self._descs.get(key)
            if hit is None or hit[0] != ptrs:
                hit = (ptrs, _ck.pack_descriptors(leaves, starts,
                                                  buf.device))
                self._descs[key] = hit
            desc = hit[1]
        _ck.pack_rows(buf, leaves, starts, desc=desc)

    def combine(self, buf: torch.Tensor, lay: _Layout) -> torch.Tensor:
        """ONE ``row_checksums`` launch over ``buf`` and the exact combine
        into the subset's (n_seg, 2) int32 digest table.  The per-leaf
        sums are differences of int64 running sums at the leaves' row
        bounds (exact: every term is below 2^32 and a buffer holds fewer
        than 2^31 rows), so the combine needs no scatter: under
        deterministic algorithms PyTorch's ``index_add_`` on the card
        becomes a sorted ``index_put_`` that checks its indices' range
        with a host sync (a captured step cannot hold one) and sums each
        leaf's rows one after another (45.5 ms a step at the training
        canary's 4.7 M rows on the H100)."""
        d = _ck.row_checksums(buf.view(-1, LANES))
        off, lo, hi = lay.maps(buf.device)
        s1 = d[:, 0].to(torch.int64)
        # |off·s1| < 2^62: the product is exact in int64 before the mask
        t2 = (d[:, 1].to(torch.int64) + off * s1) & _MASK32

        def seg_sums(x):
            # one flat scan each (a scan along the inner dim of a (2, n)
            # tensor runs on 2 rows of threads and is ~100x slower)
            run = torch.nn.functional.pad(torch.cumsum(x, 0), (1, 0))
            return run.index_select(0, hi) - run.index_select(0, lo)

        out = torch.stack([seg_sums(s1), seg_sums(t2)], dim=1)
        return _ref.wrap_i32(out)

    def _groups(self, idx: Tuple[int, ...]) -> List[Tuple[int, int]]:
        """``[lo, hi)`` runs of ``idx`` whose rows fit ``TRANSIENT_WORDS``
        words (a larger leaf makes a run alone)."""
        runs, lo, rows = [], 0, 0
        for j, i in enumerate(idx):
            n = self.specs[i].n_rows
            if j > lo and (rows + n) * LANES > TRANSIENT_WORDS:
                runs.append((lo, j))
                lo, rows = j, 0
            rows += n
        runs.append((lo, len(idx)))
        return runs

    def _run(self, idx: Tuple[int, ...], leaves) -> torch.Tensor:
        STATS.launches += 1
        buf = self._pack_bufs.get(idx)
        if buf is not None:
            self.pack(buf, self.layout(idx), leaves)
            return self.combine(buf, self.layout(idx))
        # off-hot-path digests (canary init / refresh) use transient
        # buffers instead of pinning one per subset for the plan's life;
        # a leaf's digest does not depend on its neighbours, so the runs'
        # tables concatenate to the whole subset's
        parts = []
        for lo, hi in self._groups(idx):
            sub = idx[lo:hi]
            buf = self._new_buffer(sub)
            self.pack(buf, self.layout(sub), leaves[lo:hi])
            parts.append(self.combine(buf, self.layout(sub)))
            del buf
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    # -- public digesting --------------------------------------------------

    def digest_table(self, tree) -> torch.Tensor:
        """(n_leaves, 2) int32 digest table, on the device."""
        return self._run(tuple(range(self.n_leaves)), self.leaves(tree))

    def digest_subset(self, tree, indices: Sequence[int]) -> torch.Tensor:
        """(len(indices), 2) digest table of the selected leaves."""
        idx = tuple(indices)
        if not idx:
            return torch.zeros((0, 2), dtype=torch.int32, device=self.device)
        leaves = self.leaves(tree)
        return self._run(idx, [leaves[i] for i in idx])

    def digest_dict(self, tree) -> Dict[str, np.ndarray]:
        """Host-side per-leaf digests: one digest + ONE ``fetch``."""
        table = fetch(self.digest_table(tree))
        return {k: table[i] for i, k in enumerate(self.keys)}

    def verify(self, tree, reference: Dict[str, np.ndarray]) -> List[str]:
        """Leaf paths whose digest no longer matches ``reference``."""
        current = self.digest_dict(tree)
        return sorted(k for k, d in reference.items()
                      if k not in current
                      or not np.array_equal(current[k], d))


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict[Tuple, DigestPlan] = {}


def plan_for(tree) -> DigestPlan:
    """The cached DigestPlan for ``tree``'s structure (leaf paths, shapes,
    dtypes) on its device."""
    flat = _tree.flatten_with_path(tree)
    if not flat:
        raise ValueError("plan_for: empty tree")
    device = flat[0][1].device
    sig = tuple(sorted((leaf_key(p), tuple(x.shape), str(x.dtype))
                       for p, x in flat))
    key = (str(device), sig)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        keys = tuple(k for k, _, _ in sig)
        sizes = tuple(int(np.prod(shape, dtype=np.int64))
                      for _, shape, _ in sig)
        plan = DigestPlan(keys, sizes, device)
        _PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# mesh-sharded digesting: each rank's single-device plan over its blocks
# ---------------------------------------------------------------------------

def mesh_device_order(ctx) -> Tuple[int, ...]:
    """Canonical shard order: the ranks in mesh-flat (row-major over the
    axes) order.  Shard id ``d`` everywhere in the subsystem (tables, bad
    masks, snapshot shard digests, ``FaultReport.shards``) is the rank
    at this position."""
    return ctx.device_order()


class ShardedDigestPlan(DigestPlan):
    """This rank's digest plan on a mesh: the single-device layout over
    its own blocks, plus the mesh it belongs to."""

    def __init__(self, ctx, keys: Tuple[str, ...], sizes: Tuple[int, ...],
                 device: torch.device):
        super().__init__(keys, sizes, device)
        self.ctx = ctx
        self.n_shards = ctx.n_devices

    def gather_table(self, table: torch.Tensor) -> torch.Tensor:
        """``(n_shards, rows, 2)``: every rank's table in shard order
        (collective)."""
        from repro_torch.distributed import collectives as coll
        return coll.all_gather(table, self.ctx.group(self.ctx.axis_names))


def mesh_key(ctx) -> Tuple:
    """What names a mesh in a cache key: its axes and its ranks in
    mesh-flat order (after a hard loss a mesh of the same shape may be
    made of other ranks)."""
    return (ctx.axes, ctx.device_order())


def evict_mesh(ctx) -> int:
    """Drop every cached digest plan of ``ctx``'s mesh: after a hard loss
    they hold buffers (the pack ring) of a mesh that is gone."""
    mk = mesh_key(ctx)
    stale = [k for k in _PLAN_CACHE if k[0] == "mesh" and k[1] == mk]
    for k in stale:
        del _PLAN_CACHE[k]
    return len(stale)


def sharded_plan_for(tree, ctx) -> ShardedDigestPlan:
    """The cached ``ShardedDigestPlan`` of this rank's blocks ``tree`` on
    ``ctx``'s mesh."""
    flat = _tree.flatten_with_path(tree)
    if not flat:
        raise ValueError("sharded_plan_for: empty tree")
    device = flat[0][1].device
    sig = tuple(sorted((leaf_key(p), tuple(x.shape), str(x.dtype))
                       for p, x in flat))
    key = ("mesh", mesh_key(ctx), ctx.rank, str(device), sig)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = ShardedDigestPlan(
            ctx, tuple(k for k, _, _ in sig),
            tuple(int(np.prod(s, dtype=np.int64)) for _, s, _ in sig),
            device)
        _PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# check+arm of one canary rotation
# ---------------------------------------------------------------------------

def _as_slice(rows: Sequence[int]) -> slice:
    """``rows`` as a slice: the canary's rotating slices ``r, r+K, ...``
    step evenly (a slice reads and writes the tables with no scatter,
    which under deterministic algorithms would sync the host)."""
    if not rows:
        return slice(0, 0)
    step = rows[1] - rows[0] if len(rows) > 1 else 1
    if step <= 0 or any(b - a != step for a, b in zip(rows, rows[1:])):
        raise ValueError(f"check/arm rows must step evenly, got {rows}")
    return slice(rows[0], rows[-1] + 1, step)


class CheckArm:
    """The fused check+arm digest of one canary rotation, in phases.

    Its packing buffer holds the check-slice leaves first and the
    arm-slice leaves after them: for a K-slice canary's rotation a view
    of the plan's ``PackRing``, each slice padded to whole tiles (a
    union's tail pad would be the next slice's words); otherwise the
    union's own buffer (``plan.take_buffer(union)``).  A caller that
    updates the state in place runs ``pack_check`` before its first write,
    ``pack_arm`` after its last, then ``finish``.  Every phase launches
    work only on the device, with no host sync, so a CUDA graph can
    capture all three."""

    def __init__(self, plan: DigestPlan, chk: Sequence[int],
                 arm: Sequence[int], n_slices: int = 0):
        self.plan = plan
        self.chk = tuple(chk)
        self.arm = tuple(arm)
        self.union = self.chk + self.arm
        self.nc = len(self.chk)
        self._chk_rows, self._arm_rows = _as_slice(self.chk), \
            _as_slice(self.arm)
        ring = plan.ring(n_slices) if n_slices and self.union else None
        slots = ring.place(self.chk, self.arm) if ring else None
        self._view = None if slots is None else ring.view(*slots)
        self.layout = plan.layout(self.union) if slots is None else \
            plan.parts_layout(tuple(p for p in (self.chk, self.arm) if p))

    def buffer(self) -> torch.Tensor:
        """The rotation's packing buffer: its ring view, or the union's
        own buffer; either is registered with the plan under the union
        (``plan.buffer_pointer``)."""
        if self._view is None:
            return self.plan.take_buffer(self.union)
        self.plan._ring_views[self.union] = self._view
        return self._view

    def descriptors(self, check_leaves, arm_leaves):
        """Fresh ``pack_rows`` schedules of both phases (None on the
        CPU), for a caller that captures them."""
        return (self.plan.descriptors(self.layout, check_leaves),
                self.plan.descriptors(self.layout, arm_leaves,
                                      first=self.nc))

    def pack_check(self, buf, leaves, desc=None) -> None:
        self.plan.pack(buf, self.layout, leaves, first=0, desc=desc)

    def pack_arm(self, buf, leaves, desc=None) -> None:
        self.plan.pack(buf, self.layout, leaves, first=self.nc, desc=desc)

    def finish_local(self, buf, ref_read, ref_write):
        """Digest the packed buffer, compare the check rows against
        ``ref_read`` on the device, and arm the rest into ``ref_write`` in
        place: device work only, so a graph can hold it.  Returns
        ``(any_mismatch, bad_mask)``, both on the device."""
        table = self.plan.combine(buf, self.layout)
        bad = (table[:self.nc] != ref_read[self._chk_rows]).any(dim=1)
        if self.arm:
            ref_write[self._arm_rows].copy_(table[self.nc:])
        return bad.any(), bad

    def reduce_flag(self, flag: torch.Tensor) -> torch.Tensor:
        """The flag every rank acts on: off the mesh the local one."""
        return flag

    def finish(self, buf, ref_read, ref_write):
        """``finish_local``, then ``reduce_flag`` of its flag."""
        flag, bad = self.finish_local(buf, ref_read, ref_write)
        return self.reduce_flag(flag), bad


class ShardedCheckArm(CheckArm):
    """A rotation's check+arm on a mesh: this rank's single-device core
    over its own blocks, then the fault flag all-reduced with MAX
    (``reduce_flag``) — the one collective of a steady check."""

    def reduce_flag(self, flag: torch.Tensor) -> torch.Tensor:
        """The mesh-wide flag (every rank the same); the local one when
        the rotation checks nothing (no rank then calls a collective)."""
        if not self.nc:
            return flag
        from repro_torch.distributed import collectives as coll
        ctx = self.plan.ctx
        return coll.flag_max(flag, ctx.group(ctx.axis_names))[0] > 0


def check_arm_subcomputation(plan: DigestPlan, chk: Sequence[int],
                             arm: Sequence[int], n_slices: int = 0):
    """``(core, union)`` for one canary rotation; ``core`` is the plan's
    cached ``CheckArm`` and ``union = tuple(chk) + tuple(arm)``.  With
    ``n_slices`` (the canary's K) the core packs into the plan's ring
    (``core.buffer()``); without, into ``plan.take_buffer(union)``, as the
    reference's does."""
    key = (tuple(chk), tuple(arm), n_slices)
    core = plan._check_arm.get(key)
    if core is None:
        kind = ShardedCheckArm if isinstance(plan, ShardedDigestPlan) \
            else CheckArm
        core = kind(plan, chk, arm, n_slices)
        plan._check_arm[key] = core
    return core, core.union


# ---------------------------------------------------------------------------
# host digest path — numpy uint32 arithmetic wraps mod 2^32 exactly like the
# device math, so host copies are certified without a device round trip
# ---------------------------------------------------------------------------

def host_bits(x) -> np.ndarray:
    """Host numpy array holding the raw bits of a host tensor or array
    (bf16, which numpy lacks, crosses as its int16 bits; a tensor that
    lies on the card is refused — this is the device-free path)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("host digests take host tensors")
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    return np.asarray(x)


def _host_i32(x) -> np.ndarray:
    """Host mirror of ``ref.to_i32``: flat int32 view of the raw bits."""
    a = np.ascontiguousarray(host_bits(x))
    if a.dtype.itemsize == 4:          # float32 / int32 / uint32: bit view
        return a.reshape(-1).view(np.int32)
    if a.dtype.itemsize == 2:          # bf16 / f16 / i16 / u16: zero-extend
        return a.reshape(-1).view(np.uint16).astype(np.int32)
    if a.dtype.itemsize == 1:          # i8 / u8: zero-extend
        return a.reshape(-1).view(np.uint8).astype(np.int32)
    if a.dtype == np.int64:            # truncate
        return a.reshape(-1).astype(np.int32)
    if a.dtype.kind == "c":
        raise TypeError(f"host digest: complex dtype {a.dtype} has no "
                        f"int32 view")
    return np.ascontiguousarray(
        a.astype(np.float32)).reshape(-1).view(np.int32)


#: words a host digest takes at a time: its temporaries stay in cache (a
#: whole-leaf weight vector and product cost 3-4x the time at 10-18 GB)
HOST_CHUNK = 1 << 16


def host_checksum(x) -> np.ndarray:
    """Fletcher digest int32[2] of a host tensor or array — bit-identical
    to the device digest of the same bytes, with no device work.  Taken
    ``HOST_CHUNK`` words at a time: word j of the chunk at i weighs
    ``i + j + 1`` (mod 2^32)."""
    a = np.ascontiguousarray(host_bits(x)).reshape(-1)
    n = a.shape[0]
    base = np.arange(1, min(n, HOST_CHUNK) + 1, dtype=np.uint32)
    w = np.empty_like(base)
    s1 = s2 = 0
    for i in range(0, n, HOST_CHUNK):
        f = _host_i32(a[i:i + HOST_CHUNK]).view(np.uint32)
        m = f.shape[0]
        np.add(base[:m], np.uint32(i & _MASK32), out=w[:m])
        s1 += int(np.add.reduce(f, dtype=np.uint32))
        np.multiply(f, w[:m], out=w[:m])
        s2 += int(np.add.reduce(w[:m], dtype=np.uint32))
    return np.array([s1 & _MASK32, s2 & _MASK32],
                    dtype=np.uint32).view(np.int32)


def host_tree_checksums(tree) -> Dict[str, np.ndarray]:
    """Per-leaf host digests keyed by path — certifies a host copy (a
    micro-snapshot) where it lives."""
    return {leaf_key(p): host_checksum(x)
            for p, x in _tree.flatten_with_path(tree)}


def host_verify_tree(tree, reference: Dict[str, np.ndarray]) -> List[str]:
    """Leaf paths of a HOST tree whose digest no longer matches
    ``reference`` — snapshot verification, device-free."""
    current = host_tree_checksums(tree)
    return sorted(k for k, d in reference.items()
                  if k not in current or not np.array_equal(current[k], d))


def shard_indices(sharding) -> List[Tuple[slice, ...]]:
    """The global index box of every shard id, in shard order, of a leaf
    with ``sharding`` (``distributed.sharding.LeafSharding``) — what a
    snapshot stores so one shard's bytes can be cut out of a full copy."""
    return [sharding.box(d) for d in range(sharding.ctx.n_devices)]


def host_shard_checksums(full, sharding) -> np.ndarray:
    """``(n_shards, 2)`` host digests of a FULL host tensor's shards in
    shard order — the single-device oracle of the sharded tables."""
    return np.stack([host_checksum(full[idx])
                     for idx in shard_indices(sharding)])


# ---------------------------------------------------------------------------
# single-flip localisation — triage's certificate engine.  The Fletcher pair
# (s1, s2) over a leaf's packed words is an error-locating code for the
# single-bit-flip channel: one flipped bit b in word j shifts the digests by
#
#     delta1 = s1' - s1 = d            (mod 2^32),   d = +-2^b
#     delta2 = s2' - s2 = (j + 1) * d  (mod 2^32)
#
# so the (bit, word) coordinates of the flip are solvable from the reference
# digest the canary already holds, with no second copy of the data.
# ---------------------------------------------------------------------------

def _inv_odd_u32(w: int) -> int:
    """Multiplicative inverse of odd ``w`` mod 2^32 (Newton iteration)."""
    inv = w & _MASK32
    for _ in range(5):
        inv = (inv * (2 - w * inv)) & _MASK32
    return inv


def locate_single_flip(ref_pair, cur_pair, n_words: int):
    """Solve the digest pair for a single flipped bit.

    Takes the reference and current int32[2] digests of one leaf and its
    packed word count.  Returns ``(bit, delta, candidates)``: the flipped
    bit, the mod-2^32 word delta (``old_word = (cur_word - delta) &
    0xFFFFFFFF``) and the candidate flat word indices j (several only when
    ``n_words > 2^(32-bit)``); or ``None`` when the deltas fit no
    single-bit flip (multi-word or multi-bit damage: the caller
    escalates)."""
    ref = np.asarray(ref_pair).view(np.uint32).reshape(-1)
    cur = np.asarray(cur_pair).view(np.uint32).reshape(-1)
    d1 = (int(cur[0]) - int(ref[0])) & _MASK32
    d2 = (int(cur[1]) - int(ref[1])) & _MASK32
    if d1 == 0:
        return None          # a single flip always moves s1 by +-2^b
    bit = (d1 & -d1).bit_length() - 1         # trailing zeros of d1
    w = d1 >> bit
    # d = +2^b gives w = 1; d = -2^b mod 2^32 gives w = 2^(32-b) - 1
    if w not in (1, (1 << (32 - bit)) - 1):
        return None
    q = (d2 * _inv_odd_u32(w)) & _MASK32
    if q & ((1 << bit) - 1):
        return None          # (j+1)·2^b has b low zero bits
    m = q >> bit             # j + 1 mod 2^(32-bit)
    period = 1 << (32 - bit)
    first = m if m != 0 else period
    candidates = [j1 - 1 for j1 in range(first, n_words + 1, period)]
    if not candidates:
        return None
    return bit, d1, candidates
