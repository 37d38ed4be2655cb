"""Elastic hard-loss recovery — shrink the mesh, keep training;
counterpart of ``repro/launch/elastic.py`` (the reference's DESIGN.md §7).

The dominant non-transient failure of a large job is a lost host: a
whole row of the data axis disappears, and no in-place rung of
``core/recover.py`` can help, since the ranks holding those blocks are
gone.  The classic answer is a restart from the last disk checkpoint.
The near-zero-downtime answer, run here by the survivors alone:

1. **Deterministic data re-assignment** — every survivor computes the
   same ``shard_assignment(step, dead)``: the dead rows' slices of the
   batch are absorbed by survivors, rotating by step, and the surviving
   loads concatenate to the SAME global batch (``stolen_batch``).
2. **Survivor-honest state reconstruction** — each leaf is assembled
   from the surviving ranks' blocks only (collectives over the
   survivors' group: a dead rank is never read).  A block with no
   surviving holder is rebuilt from the row-safe XOR parity
   (``core/parity.RowSafeParityPlan``: its rows are replicated over the
   data axis, and a lost row erases one member of each fold group).
   Every surviving block is certified against the canary's surviving
   reference rows (the dead ranks' rows are never read).
3. **Elastic re-mesh** — ``DistContext.degrade`` builds the survivors'
   mesh and groups, every cache keyed on the dead mesh is evicted
   (``invalidate_mesh_caches``: digest and parity plans, the canary's
   units, the fused step's graphs, the serving engines' graphs and
   gathered params), and ``launch/specs.bind_state`` runs
   the one binding recipe on the degraded context.  A fresh canary and
   row-safe parity are built there and training resumes at the reduced
   data width.

Downtime = reconstruction (the survivors' gathers, O(state bytes / dp)
a rank, and one ``xor_fold_tiles`` launch per lost block) + the re-bind
(and, with ``--fused-detect``, the graphs' re-capture, which the
training loop adds to ``relower_seconds``) — no disk restore, no replay.

``relower_degraded`` is the production-shape twin of the live path: the
dry-run cell (``launch/dryrun.py``) of a program on the degraded
production mesh, one rank's program traced on ``meta`` tensors.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import shard_assignment
from repro_torch.distributed.context import DistContext
from repro_torch.kernels import digest as kdigest
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_degraded_mesh
from repro_torch.tree import flatten_with_path, leaf_key, map_with_path

# ---------------------------------------------------------------------------
# events / resume bundle
# ---------------------------------------------------------------------------

@dataclass
class ElasticEvent:
    """Telemetry of one hard-loss remesh (``disk_restores`` is always 0)."""
    step: int
    lost_rows: Tuple[int, ...] = ()       # row indices in the ctx at loss
    lost_slices: Tuple[int, ...] = ()     # original data-slice ids
    old_dp: int = 0
    new_dp: int = 0
    downtime_seconds: float = 0.0
    reconstruct_seconds: float = 0.0
    relower_seconds: float = 0.0
    bytes_reconstructed: int = 0
    bytes_regathered: int = 0
    blocks_reconstructed: int = 0
    leaves_regathered: int = 0
    certified_blocks: int = 0
    uncertified_blocks: int = 0
    evicted_executables: int = 0
    disk_restores: int = 0

    def to_dict(self) -> Dict:
        return asdict(self)


@dataclass
class ElasticResume:
    """Everything the training loop swaps in after a remesh."""
    ctx: DistContext
    state: object
    step: Callable          # the mesh step on the degraded context
    bfn: Callable
    shardings: object
    specs: object
    canary: object = None
    pstore: object = None
    event: ElasticEvent = field(default_factory=lambda: ElasticEvent(0))
    batch_shardings: object = None


# ---------------------------------------------------------------------------
# survivor-honest reads (collectives over the survivors' group)
# ---------------------------------------------------------------------------

def _host_regather(leaf: torch.Tensor, dead, sharding):
    """The whole leaf from SURVIVING ranks' blocks only (``sharding``:
    its ``LeafSharding``; ``dead``: shard ids), or None when some box has
    no surviving holder (the caller then needs parity coverage or fails
    loudly).  A collective over the survivors when the leaf is sharded;
    a replicated leaf is this rank's own copy, a surviving replica."""
    from repro_torch.distributed import collectives as coll
    ctx = sharding.ctx
    surv, group = ctx.survivors(dead)
    spans = {sharding.span(d) for d in range(ctx.n_devices)}
    if spans - {sharding.span(d) for d in surv}:
        return None
    if not sharding.axes:
        return leaf.clone()
    rows = coll.all_gather(leaf.contiguous().reshape(-1), group)
    full = torch.empty(sharding.shape, dtype=sharding.dtype,
                       device=leaf.device)
    seen = set()
    for m, d in enumerate(surv):
        if sharding.span(d) not in seen:
            seen.add(sharding.span(d))
            full[sharding.box(d)] = rows[m].view(sharding.local_shape)
    return full


def _certify_leaf(key: str, full: torch.Tensor, sharding, refs, have,
                  dead) -> Tuple[int, int]:
    """Certify the surviving unique blocks of ``full`` (this rank's
    assembly) against the canary's SURVIVING reference rows: each
    block's digest (one ``checksum_tiles`` launch) must equal the row of
    a surviving shard holding it.  Returns ``(certified, mismatched)``
    block counts — a mismatch means the row was armed for an older state
    version (K > 1 rotation) or a survivor itself is corrupt."""
    ref = refs.get(key)
    if ref is None:
        return 0, 0
    dead = set(dead)
    shards, seen = [], set()
    for d in range(sharding.ctx.n_devices):
        if d in dead or not have[d] or sharding.span(d) in seen:
            continue
        seen.add(sharding.span(d))
        shards.append(d)
    if not shards:
        return 0, 0
    got = kdigest.fetch(torch.stack(
        [kops.checksum(full[sharding.box(d)].contiguous()) for d in shards]))
    ok = sum(bool(np.array_equal(g, ref[d])) for g, d in zip(got, shards))
    return ok, len(shards) - ok


def stolen_batch(pipe, step: int, n_slices: int,
                 dead: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """The global batch as the SURVIVORS assemble it: every surviving
    slice loads its own rows plus the dead slices' rows its
    ``shard_assignment`` hands it, and the pieces concatenate back in
    slice order — bitwise ``pipe.batch_at(step)``."""
    assign = shard_assignment(step, n_slices, tuple(dead))
    parts: Dict[int, Dict[str, torch.Tensor]] = {}
    for slices in assign.values():
        for sl in slices:
            parts[sl] = pipe.shard_at(step, sl, n_slices)
    return {k: torch.cat([parts[i][k] for i in range(n_slices)])
            for k in parts[0]}


# ---------------------------------------------------------------------------
# mesh-keyed cache eviction
# ---------------------------------------------------------------------------

def invalidate_mesh_caches(ctx: DistContext) -> Dict[str, int]:
    """Evict every cache entry keyed on ``ctx``'s mesh (its axes and
    ranks): the fused step's graphs and storage, the canary's check+arm
    units, the digest and parity plans (their pack rings and exchange
    buffers).  After a hard loss they hold buffers of a mesh that is
    gone, and a second loss in the same process must not meet them.
    ``"serving"`` counts the serving engines' graphs, check+arm cores and
    gathered params storage (``serving/engine.evict_mesh``)."""
    from repro_torch.core import detect, fused_step
    from repro_torch.core import parity as core_parity
    from repro_torch.serving import engine as serving_engine
    return {"fused_step": fused_step.evict_mesh(ctx),
            "serving": serving_engine.evict_mesh(ctx),
            "fused_canary": detect.evict_mesh(ctx),
            "digest_plans": kdigest.evict_mesh(ctx),
            "parity_plans": core_parity.evict_mesh_plans(ctx)}


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class ElasticManager:
    """Tracks dead data slices and runs the hard-loss recovery path.

    Two construction modes:

    * ``ElasticManager(n_slices=8)`` — assignment only: ``mark_dead``,
      ``assignment``, ``degraded_mesh``.
    * ``ElasticManager(ctx)`` — live, over a meshed ``DistContext`` in a
      rank: ``on_loss`` runs reconstruction and the remesh on the
      survivors and returns an ``ElasticResume``.  The manager's ``ctx``
      advances to the degraded context after each loss, so a second loss
      composes (``slice_ids`` keeps the surviving rows' ORIGINAL slice
      ids for ``shard_assignment``).
    """

    def __init__(self, ctx: Optional[DistContext] = None, *,
                 n_slices: Optional[int] = None, verbose: bool = False):
        if ctx is not None and not isinstance(ctx, DistContext):
            raise TypeError("pass a DistContext or n_slices=...")
        self.ctx = ctx if (ctx is not None and ctx.enabled) else None
        if n_slices is None:
            n_slices = self.ctx.shape[self.ctx.data_axis] if self.ctx else 0
        self.n_slices = int(n_slices)
        self.verbose = verbose
        #: dead ORIGINAL data-slice ids (stable across remeshes)
        self.dead: set = set()
        #: current-ctx row index -> original slice id
        self.slice_ids = list(range(self.n_slices))
        self.events: list = []

    # -- assignment ---------------------------------------------------------

    def mark_dead(self, *slices: int) -> None:
        self.dead.update(int(s) for s in slices)
        if len(self.dead) >= self.n_slices:
            raise RuntimeError("all data slices lost")
        self.slice_ids = [s for s in self.slice_ids if s not in self.dead]

    def assignment(self, step: int) -> Dict[int, Tuple[int, ...]]:
        """Which input slices each surviving slice loads this step."""
        return shard_assignment(step, self.n_slices, tuple(self.dead))

    def degraded_mesh(self, *, multi_pod: bool = False) -> DistContext:
        """The live context, or (assignment only) the production mesh
        less the dead slices, as a shape-only context."""
        if self.ctx is not None:
            return self.ctx
        return make_degraded_mesh(len(self.dead), multi_pod=multi_pod)

    def kill_target(self) -> int:
        """Highest surviving row of the CURRENT mesh — what a simulated
        ``--kill-row-at`` takes out."""
        return len(self.slice_ids) - 1

    # -- the hard-loss path -------------------------------------------------

    def on_loss(self, *, step: int, dead_rows: Sequence[int], state,
                raw_step: Callable, cfg, batch_fn: Callable,
                canary=None, pstore=None,
                shardings=None) -> ElasticResume:
        """The degraded-mesh resume, on a surviving rank (every survivor
        calls it; the dead ranks take no part): survivor-honest gather
        and certification, parity reconstruction of the dead rows'
        blocks, eviction of the old mesh's caches, the re-bind on the
        degraded context, a fresh canary and parity.  ``dead_rows`` are
        rows of the CURRENT context's data axis; ``state`` this rank's
        blocks; ``shardings`` their ``LeafSharding`` tree (default: the
        recipe's for ``cfg``); ``batch_fn`` the global batch of a step;
        ``raw_step`` carries its own donation.  Certification is strict
        (a mismatch raises) when the canary digests the whole state every
        step (K=1)."""
        if self.ctx is None:
            raise RuntimeError("on_loss needs a meshed DistContext")
        t0 = time.perf_counter()
        ctx = self.ctx
        dead_rows = tuple(sorted(int(r) for r in dead_rows))
        dead = set()
        for r in dead_rows:
            dead.update(ctx.row_devices(r))
        plan = pstore.plan if pstore is not None else None
        if plan is not None and not plan.keys:
            plan = None                 # empty coverage: a pure re-gather
        if plan is not None and not plan.row_safe:
            raise RuntimeError(
                "hard-loss recovery needs a row_safe ParityStore — the "
                "default parity placement dies with the row it covers")
        new_ctx = ctx.degrade(dead_rows)      # the survivors' groups
        if shardings is None:
            from repro_torch.launch.specs import state_shardings
            from repro_torch.train.loop import make_train_state
            shardings, _ = state_shardings(
                ctx, cfg, make_train_state(cfg, device="meta"))
        refs = have = None
        if canary is not None:
            refs, have = canary.surviving_reference_digests(dead)
        pflat = plan.host_parity_flat(pstore.parity, dead) \
            if plan is not None else None

        # ---- survivor-honest gather + certify + reconstruct ------------
        bytes_recon = bytes_regather = 0
        blocks_recon = leaves_regathered = 0
        certified = uncertified = 0
        by_sh = {leaf_key(p): sh for p, sh in flatten_with_path(shardings)}
        fulls = {}
        for path, leaf in flatten_with_path(state):
            key = leaf_key(path)
            sh = by_sh[key]
            if plan is not None and key in plan.key_set:
                blocks = plan.host_surviving_blocks(key, leaf, dead)
                full, missing = plan.assemble_blocks(key, blocks)
                uniq, _ = plan.slices[key]
                for b in missing:
                    blk = plan.host_reconstruct_block(key, b, pflat, blocks)
                    full[tuple(slice(a, e) for a, e in uniq[b])] = blk
                    bytes_recon += blk.numel() * blk.element_size()
                    blocks_recon += 1
            else:
                full = _host_regather(leaf, dead, sh)
                if full is None:
                    raise RuntimeError(
                        f"leaf {key}: some region has neither a surviving "
                        f"replica nor parity coverage — unrecoverable "
                        f"without a checkpoint")
                bytes_regather += full.numel() * full.element_size()
                leaves_regathered += 1
            if refs is not None:
                ok, bad = _certify_leaf(key, full, sh, refs, have, dead)
                certified += ok
                uncertified += bad
            fulls[key] = full
        if uncertified and canary.n_slices == 1:
            raise RuntimeError(
                f"{uncertified} surviving blocks failed digest "
                f"certification against the surviving reference rows")
        full_state = map_with_path(lambda p, _: fulls[leaf_key(p)], state)
        del fulls, pflat
        t_recon = time.perf_counter() - t0

        # ---- drop everything built on the dead mesh ---------------------
        evicted = invalidate_mesh_caches(ctx)

        # ---- remesh + re-bind -------------------------------------------
        lost_slices = tuple(self.slice_ids[r] for r in dead_rows
                            if r < len(self.slice_ids))
        old_dp = ctx.dp_size
        from repro_torch.launch.specs import bind_state
        t1 = time.perf_counter()
        bound = bind_state(new_ctx, cfg, full_state, raw_step, batch_fn)
        del full_state
        relower = time.perf_counter() - t1

        # ---- fresh detection / parity on the shrunken context ------------
        new_canary = new_pstore = None
        if pstore is not None:
            from repro_torch.core.parity import ParityStore
            new_pstore = ParityStore(bound.state, ctx=new_ctx, row_safe=True,
                                     shardings=bound.shardings)
            new_pstore.build(bound.state, step)
        if canary is not None:
            from repro_torch.core.detect import ChecksumCanary
            new_canary = ChecksumCanary(bound.state,
                                        n_slices=canary.n_slices,
                                        ctx=new_ctx)
            if new_pstore is not None and canary.parity_store is not None:
                new_canary.attach_parity(new_pstore)

        self.dead.update(lost_slices)
        self.slice_ids = [s for i, s in enumerate(self.slice_ids)
                          if i not in set(dead_rows)]
        self.ctx = new_ctx
        ev = ElasticEvent(
            step=step, lost_rows=dead_rows, lost_slices=lost_slices,
            old_dp=old_dp, new_dp=new_ctx.dp_size,
            downtime_seconds=time.perf_counter() - t0,
            reconstruct_seconds=t_recon, relower_seconds=relower,
            bytes_reconstructed=bytes_recon,
            bytes_regathered=bytes_regather,
            blocks_reconstructed=blocks_recon,
            leaves_regathered=leaves_regathered,
            certified_blocks=certified, uncertified_blocks=uncertified,
            evicted_executables=sum(evicted.values()), disk_restores=0)
        self.events.append(ev)
        if self.verbose:
            print(f"[elastic] step {step}: lost rows {dead_rows} "
                  f"(slices {lost_slices}), dp {old_dp}->{ev.new_dp}, "
                  f"reconstructed {blocks_recon} blocks ({bytes_recon} B), "
                  f"re-bound in {relower:.2f}s, downtime "
                  f"{ev.downtime_seconds:.2f}s")
        return ElasticResume(
            ctx=new_ctx, state=bound.state, step=bound.step,
            bfn=bound.bfn, shardings=bound.shardings,
            specs=bound.specs, canary=new_canary, pstore=new_pstore,
            event=ev, batch_shardings=bound.batch_shardings)

    def hook(self, *, raw_step, cfg, batch_fn, canary=None, pstore=None,
             shardings=None) -> Callable:
        """Adapter for ``RecoveryRuntime(elastic=...)``: a callable
        ``(state, report, step) -> ElasticResume`` closing over the bind
        ingredients (core/ takes a callable and imports nothing of
        launch/)."""
        def run(state, report, step):
            return self.on_loss(
                step=step, dead_rows=tuple(report.lost_rows), state=state,
                raw_step=raw_step, cfg=cfg, batch_fn=batch_fn,
                canary=canary, pstore=pstore, shardings=shardings)
        return run


def relower_degraded(cfg, shape, *, lost_slices: int = 1,
                     multi_pod: bool = False):
    """Re-trace the cell's program on the degraded production mesh.

    Returns ``(record, ctx, seconds)``, where the reference returns
    ``(compiled, mesh, seconds)``: the dry-run record of one rank's
    program (``dryrun.trace_cell``) on ``ctx``, the shape-only context of
    the (16 - lost) x 16 (or (32 - lost) x 16) mesh — the elastic-scaling
    proof at production shape, with no state and no device."""
    from repro_torch.launch.dryrun import trace_cell
    t0 = time.perf_counter()
    ctx = make_degraded_mesh(lost_slices, multi_pod=multi_pod)
    record = trace_cell(cfg, shape, ctx)[0]
    return record, ctx, time.perf_counter() - t0
