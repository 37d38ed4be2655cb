"""In-step fused detection — the step carries its own canary; counterpart
of ``repro/core/fused_step.py``.

The donated pair (``arm_current`` at the top of the loop, ``check`` just
before the step) guards an in-place step with two digest launches and the
step's own launches in between.  This module makes check, step and arm
ONE unit per canary rotation ``r = s % K``:

  * ``pack_check`` of slice ``s % K`` of the INPUT state (before the step
    writes anything),
  * the user step,
  * ``pack_arm`` of slice ``(s+1) % K`` of the OUTPUT state, and
    ``CheckArm.finish``: one ``row_checksums`` launch, the compare against
    the read generation and the in-place arm of the write generation,
  * with a parity attached, its gated incremental update (the old covered
    leaves taken into the delta before the step writes them).

On the card each unit is one captured ``torch.cuda.CUDAGraph``, so a
steady step is ONE graph replay plus ONE scalar fetch (the flag, with the
``host_metrics`` beside it) and nothing else launched from the host.  On
the CPU the same phases run eagerly with the same digests: detection and
the trajectory are bit-identical to the unfused ``check_and_arm`` and
donated-pair protocols.

A graph reads every pointer it was captured with.  Hence:

  * the state lives in the factory's storage (``load`` copies a state
    in, skipping every leaf that already is the storage's tensor;
    ``step`` returns trees of that storage).  With ``donate=True`` there
    is one state version, updated in place, and it is the state the
    factory was first given: the graphs adopt the loop's own tensors, so
    no second version is held.  Without donation the
    input must survive the step (the rungs read it), so there are two
    versions in ping-pong: the graph reads version ``b`` and writes the
    step's outputs into version ``1 - b`` — one more state copy per step
    and one more state version of memory in the graph pool (the
    functional step's outputs before the copy);
  * the canary's two tables and the parity keep their storage (they are
    written in place), and each rotation has one graph per read table,
    ``gen & 1``; without donation the buffer ``b`` is tied to the
    generation (``b = gen & 1 ^ phase``), so there are 2K graphs either
    way, sharing one memory pool;
  * the pack schedules of each graph are built before its capture and
    kept with it; the digest layout maps are uploaded before capture.

The first capture runs warm-up steps on the storage (two, and at least
one per rotation) with the canary's tables and parity saved and
restored around them, and, donated, the adopted state too (through a
pinned host copy), so warm-up never advances the run.  A capture that
fails on a card raises: there is no eager fallback there.  Graph
outputs (``aux``, the mismatch mask) are overwritten by the next
replay; a report clones what its resolver reads.

On a mesh (a ``ShardedDigestPlan`` canary and the mesh step of
``train/loop.pin_state_shardings``) a graph cannot hold the step's
collectives: they run through gloo on the host (NCCL, which a graph can
capture, refuses two ranks on one card).  So each rank's unit is
stretches of device work between collectives, and each stretch whose
inputs have fixed storage is a graph keyed by (rotation, read table):

  * the head (graph): the check pack of slice ``s % K`` of the input
    blocks (with a parity attached and donated, the old covered blocks
    into the delta);
  * the step's front (eager): every collective of the mesh step — the
    forward and backward with their model-axis collectives
    (tensor-parallel, on the rank's blocks in place; a mesh with no
    model axis wider than 1 reads the params' gather, a new tensor each
    step), the
    grads' mean and the norm's all-gather; its outputs are copied into
    fixed storage;
  * the tail (graph): the rest of the step (norm, clip, update, the
    ``iv`` advance), the arm pack of slice ``(s+1) % K`` of the output
    blocks, the ``row_checksums`` launch, the compare against the read
    table, the in-place arm of the write table and, with a parity, the
    new blocks' share of the delta;
  * eager: the flag's MAX all-reduce over the world group; with a
    parity the gate on that flag, the delta's all-to-all and
    ``xor_update_tiles`` (one launch each between collectives); the one
    fetch of the flag with the host metrics beside it.

On the CPU the same stretches run eagerly, in the same order.
"""

from __future__ import annotations

import time
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.detect import ChecksumCanary, FaultReport
from repro_torch.core.replay import copy_into
from repro_torch.kernels import _build
from repro_torch.kernels import digest as kdigest
from repro_torch.tree import flatten_with_path, leaves, tree_map

#: warm-up steps before the first capture (lazy initialisation of cuBLAS,
#: the autograd engine and the kernels' host state); at least one per
#: rotation, so every rotation runs eagerly once before its capture
WARMUP_STEPS = 2

#: every live factory on a mesh (``evict_mesh`` drops a lost mesh's)
_ON_MESH: "weakref.WeakSet[FusedStepFactory]" = weakref.WeakSet()


def evict_mesh(ctx) -> int:
    """Close every live fused unit built on ``ctx``'s mesh (its axes and
    ranks): after a hard loss its graphs hold the dead mesh's buffers.
    Returns the units dropped (captured graphs on the card, eager
    rotations on the CPU)."""
    mk = kdigest.mesh_key(ctx)
    return sum(f.close() for f in list(_ON_MESH)
               if kdigest.mesh_key(f.canary.ctx) == mk)


@dataclass
class _Rotation:
    """The fixed pieces of rotation ``r``: its CheckArm (None for a
    degenerate rotation with no leaf to digest), the packing buffer and
    the slices."""
    core: Optional[kdigest.CheckArm]
    buf: Optional[torch.Tensor]
    chk: Tuple[int, ...]
    arm: Tuple[int, ...]


@dataclass
class _MeshGraphs:
    """One rotation's two captured stretches on a mesh rank (head and
    tail, each a ``_Graph``)."""
    head: "_Graph"
    tail: "_Graph"


@dataclass
class _Graph:
    """One captured rotation: the graph, its outputs and what it keeps
    alive (pack schedules), and the kernel launches one replay makes."""
    graph: object
    aux: Dict
    bad: Optional[torch.Tensor]
    host: torch.Tensor
    keep: Tuple
    launches: Counter
    #: a mesh tail's local mismatch flag (reduced after the replay)
    flag: Optional[torch.Tensor] = None


class FusedStepFactory:
    """K rotation units of (check ∘ step ∘ arm).  Built by
    ``ChecksumCanary.fuse_into_step``; drive with::

        new_state, aux, report = factory.step(s, state, *args)

    ``step_fn(state, *args) -> (new_state, aux)`` takes and returns the
    canary's plan structure; with ``donate=True`` it writes the state in
    place.  ``report`` is None on the no-fault path (after the ONE scalar
    fetch) or a ``FaultReport`` whose leaf attribution is deferred to
    ``resolve()``; on a report ``new_state`` was computed from the
    corrupted input and must be discarded, and with ``donate=True`` the
    input was overwritten (``consumed=True``: the ladder replays).

    ``host_metrics`` names 0-dim entries of ``aux`` fetched with the flag
    in the step's one transfer; ``step`` returns them as Python floats.

    Accounting: ``n_compiles``/``compile_seconds`` count the rotation
    builds — CUDA graph captures and their seconds on the card, the
    eager rotation set-up on the CPU; ``warm()`` builds every rotation
    and returns the wall time it took."""

    def __init__(self, step_fn, canary: ChecksumCanary, *,
                 donate: bool = False, warm: str = "lazy",
                 host_metrics: Sequence[str] = ()):
        if warm not in ("lazy", "eager"):
            raise ValueError(f"warm must be 'lazy' or 'eager', got {warm!r}")
        self.step_fn = step_fn
        self.canary = canary
        self.plan = canary.plan
        self.n_slices = canary.n_slices
        self.donate = donate
        self.warm_mode = warm
        self.host_metrics = tuple(host_metrics)
        self.n_compiles = 0
        self.compile_seconds = 0.0
        #: a mesh rank's unit: the step's collectives between its graphs
        self.mesh = canary.ctx is not None
        if self.mesh and not hasattr(step_fn, "front"):
            raise ValueError("a fused step on a mesh takes the mesh step "
                             "(train/loop.pin_state_shardings)")
        #: the mesh step's front outputs in fixed storage (card)
        self._front = None
        self._rotations: Dict[int, _Rotation] = {}
        self._warmed = False
        # card only: the state storage (1 version donated, 2 in ping-pong),
        # the static step arguments, the graphs and their memory pool
        self._bufs: List = []
        self._args = None
        self._graphs: Dict[Tuple[int, int], _Graph] = {}
        self._pool = None
        self._dropped = False
        self._phase = 0
        if self.mesh:
            _ON_MESH.add(self)

    def close(self) -> int:
        """Drop every unit, the graphs' memory pool, the storage and the
        static arguments (the factory is unusable after it).  Returns the
        units dropped."""
        n = len(self._graphs) or len(self._rotations)
        self._graphs.clear()
        self._rotations.clear()
        self._bufs, self._args, self._front, self._pool = [], None, None, None
        _ON_MESH.discard(self)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        return n

    # -- rotations -----------------------------------------------------------

    def _rotation(self, r: int) -> _Rotation:
        rot = self._rotations.get(r)
        if rot is not None:
            return rot
        t0 = time.perf_counter()
        can = self.canary
        chk = tuple(can._slice_indices(r))
        arm = tuple(can._slice_indices(r + 1))
        if chk or arm:
            core, _ = kdigest.check_arm_subcomputation(
                self.plan, chk, arm, n_slices=self.n_slices)
            buf = core.buffer()
            # device constants a captured graph must find uploaded
            core.layout.maps(buf.device)
            rot = _Rotation(core, buf, chk, arm)
        else:
            rot = _Rotation(None, None, chk, arm)
        self._rotations[r] = rot
        if self.plan.device.type != "cuda":
            self.n_compiles += 1
            self.compile_seconds += time.perf_counter() - t0
        return rot

    # -- the unit: check, step, arm (eager on the CPU, captured on the card)
    #
    # Four stretches, off the mesh and on it: ``_head`` (device work
    # before the step), ``_step_front`` (the step up to its last
    # collective; off the mesh nothing), ``_tail`` (device work after it) and
    # ``_reduce`` (the flag every rank acts on, the parity's gated update,
    # the host vector).  Off the mesh one graph holds all four; on a mesh
    # the head and the tail are a graph each and the rest runs eagerly.

    def _pplan(self, rot: _Rotation):
        pstore = self.canary.parity_store
        if pstore is None or rot.core is None or not pstore.plan.keys:
            return None
        return pstore.plan

    def _head(self, rot: _Rotation, inp, desc=None) -> None:
        """Device work before the step: the check pack (and, donated, the
        old covered blocks into the parity delta)."""
        if rot.core is None:
            return
        lv = self.plan.leaves(inp)
        rot.core.pack_check(rot.buf, [lv[i] for i in rot.chk], desc=desc)
        pplan = self._pplan(rot)
        if pplan is not None and self.donate:
            pplan.begin_delta(pplan.leaves(inp))

    def _step_front(self, inp, args):
        """The step up to its last collective: on a mesh the mesh step's
        ``front``; off the mesh nothing (the arguments go on to the
        tail)."""
        return self.step_fn.front(inp, *args) if self.mesh else args

    def _tail(self, rot: _Rotation, inp, out, read, write, fr, desc=None):
        """Device work after the step's last collective: the rest of the
        step (off the mesh the whole step), the arm pack,
        ``row_checksums``, the compare and the arm of the write table, the
        new blocks' share of the parity delta.  ``out`` is where the
        output state must end up (None: wherever the step put it).
        Returns ``(new_state, aux, local flag, bad)``."""
        new_state, aux = self.step_fn.tail(inp, fr) if self.mesh \
            else self.step_fn(inp, *fr)
        if out is not None and out is not new_state:
            new_state = copy_into(out, new_state)
        flag = bad = None
        if rot.core is not None:
            lv = self.plan.leaves(new_state)
            rot.core.pack_arm(rot.buf, [lv[i] for i in rot.arm], desc=desc)
            flag, bad = rot.core.finish_local(rot.buf, read, write)
            pplan = self._pplan(rot)
            if pplan is not None:
                if self.donate:
                    pplan.stream_mat(pplan.leaves(new_state), xor=True)
                else:
                    pplan.stream_mat(pplan.leaves(inp),
                                     pplan.leaves(new_state))
        return new_state, aux, flag, bad

    def _reduce(self, rot: _Rotation, flag, aux):
        """After the tail: the flag every rank acts on (on a mesh its MAX
        all-reduce), the parity's gated update and the host vector of the
        one fetch (the flag, when there is a digest, and the host
        metrics)."""
        extra = [aux[n].detach().to(torch.float64)
                 for n in self.host_metrics]
        if rot.core is None:
            return torch.stack(extra) if extra else None
        flag = rot.core.reduce_flag(flag)
        pplan = self._pplan(rot)
        if pplan is not None:
            pstore = self.canary.parity_store
            pplan.apply_delta(pstore.parity,
                              pplan.stream_row(pstore.device), flag)
        return torch.stack([flag.to(torch.float64)] + extra)

    def _body(self, rot: _Rotation, inp, out, read, write, args,
              descs=(None, None), fixed: bool = False):
        """One whole unit, run (or, off the mesh, recorded) in order;
        ``fixed`` (a warm-up step on a mesh rank) puts the front's outputs
        into the storage the captured tail reads.  Returns ``(new_state,
        aux, bad, host_vector)``."""
        self._head(rot, inp, descs[0])
        fr = self._step_front(inp, args)
        if fixed:
            fr = self._load_front(fr)
        new_state, aux, flag, bad = self._tail(rot, inp, out, read, write,
                                               fr, descs[1])
        return new_state, aux, bad, self._reduce(rot, flag, aux)

    def _load_front(self, fr):
        """The front's outputs into their fixed storage (allocated at the
        first step, before any capture)."""
        if self._front is None:
            self._front = tree_map(torch.clone, fr)
        else:
            copy_into(self._front, fr)
        return self._front

    def _finish(self, s: int, rot: _Rotation, new_state, aux, bad, host,
                read, write):
        """Host half of a step: commit the generation and the parity
        version, fetch the flag (and the host metrics) once, build the
        report."""
        can = self.canary
        vals = kdigest.fetch(host) if host is not None else ()
        if rot.core is not None:
            can.commit_update(write)
            if can.parity_store is not None:
                can.parity_store.commit(can.parity_store.parity, s + 1)
            fired, vals = bool(vals[0]), vals[1:]
        else:
            fired = False
        aux = dict(aux, **{n: float(v) for n, v in
                           zip(self.host_metrics, vals)})
        if not fired:
            return new_state, aux, None
        # the generation is already bumped: the rows this check compared
        # against are ``read``, which a later arm overwrites — keep a copy,
        # as of the mismatch mask (the next replay rewrites it)
        can._fault_reference = read.clone()
        bad = bad.clone()
        chk = rot.chk
        return new_state, aux, FaultReport(
            s, "checksum", detail="in-step fused check",
            resolver=lambda: can._attribution(chk, bad),
            consumed=self.donate)

    # -- warm-up and capture (card) ----------------------------------------

    def _on_card(self, state) -> bool:
        return leaves(state)[0].device.type == "cuda"

    def _prepare(self, state, args) -> None:
        """First use on the card: storage, static arguments and the
        warm-up on the storage (the canary's tables and parity restored
        after it).  Donated, the storage IS ``state``: the graphs capture
        the loop's own tensors, and a pinned host copy of the state
        brings back, bitwise, what the warm-up steps wrote.  In
        ping-pong the storage is two copies of ``state``, and the real
        state goes in at the first ``load``."""
        if self._bufs:
            return
        saved_state = None
        if self.donate:
            self._bufs = [state]
            saved_state = [torch.empty_like(t, device="cpu",
                                            pin_memory=True).copy_(t)
                           for t in leaves(state)]
        else:
            self._bufs = [tree_map(torch.clone, state),
                          tree_map(torch.clone, state)]
        self._args = tuple(tree_map(
            lambda t: torch.empty_like(t, device=self.plan.device), a)
            for a in args)
        self._load_args(args)
        self._pool = torch.cuda.graph_pool_handle()
        can = self.canary
        pstore = can.parity_store
        saved = [t.clone() for t in can._tables]
        saved_parity = pstore.parity.clone() if pstore is not None else None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(max(WARMUP_STEPS, self.n_slices)):
                rot = self._rotation(i % self.n_slices)
                read, write = can._tables[0], can._tables[1]
                inp = self._bufs[0]
                out = None if self.donate else self._bufs[1]
                # on a mesh every rank warms up together: the front's
                # and the flag's collectives run here too
                self._body(rot, inp, out, read, write, self._args,
                           fixed=self.mesh)
        torch.cuda.current_stream().wait_stream(side)
        for t, v in zip(can._tables, saved):
            t.copy_(v)
        if pstore is not None:
            pstore.parity.copy_(saved_parity)
        if saved_state is not None:
            for t, h in zip(leaves(state), saved_state):
                t.copy_(h)
            torch.cuda.synchronize()
        # the real state goes in at the first ``load``; b = 0 at this gen
        self._phase = can.generation & 1

    def _load_args(self, args) -> None:
        for static, a in zip(self._args, args):
            for (_, dst), (_, src) in zip(flatten_with_path(static),
                                          flatten_with_path(a)):
                if dst is not src:
                    dst.copy_(src)

    def _record(self, fn) -> Tuple[object, object, Counter]:
        """Capture ``fn()`` into a graph of the factory's pool: ``(graph,
        fn's result, the kernel launches one replay makes)``.  On a mesh
        the capture checks only this thread's CUDA calls: gloo's threads
        are idle between collectives, but they are not the capture's."""
        before = Counter(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        mode = "thread_local" if self.mesh else "global"
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode=mode):
            got = fn()
        self.compile_seconds += time.perf_counter() - t0
        self.n_compiles += 1
        # nothing ran during the capture: its kernels count at each replay
        launches = Counter(_build.LAUNCHES)
        launches.subtract(before)
        _build.LAUNCHES.subtract(launches)
        return graph, got, +launches

    def _capture(self, r: int, g: int):
        """Capture rotation ``r`` reading table ``g``: one ``_Graph``, or
        on a mesh the head and the tail (``_MeshGraphs``)."""
        can = self.canary
        rot = self._rotation(r)
        b = 0 if self.donate else g ^ self._phase
        inp = self._bufs[b]
        out = None if self.donate else self._bufs[1 - b]
        read, write = can._tables[g], can._tables[1 - g]
        descs = (None, None)
        if rot.core is not None:
            descs = rot.core.descriptors(
                [self.plan.leaves(inp)[i] for i in rot.chk],
                [self.plan.leaves(inp if out is None else out)[i]
                 for i in rot.arm])
        if self.mesh:
            head, _, lh = self._record(
                lambda: self._head(rot, inp, descs[0]))
            tail, (_, aux, flag, bad), lt = self._record(
                lambda: self._tail(rot, inp, out, read, write, self._front,
                                   descs[1]))
            return _MeshGraphs(
                _Graph(head, {}, None, None, (descs[0],), lh),
                _Graph(tail, aux, bad, None, (descs[1],), lt, flag=flag))
        graph, (_, aux, bad, host), launches = self._record(
            lambda: self._body(rot, inp, out, read, write, self._args,
                               descs))
        return _Graph(graph, aux, bad, host, descs, launches)

    def _graph(self, r: int, g: int) -> _Graph:
        ent = self._graphs.get((r, g))
        if ent is None:
            ent = self._graphs[(r, g)] = self._capture(r, g)
        return ent

    def _pool_split(self) -> Tuple[int, int]:
        """(bytes reserved in the graphs' private pool, bytes reserved but
        free in the default pool)."""
        own = spare = 0
        for seg in torch.cuda.memory_snapshot():
            pid = tuple(seg["segment_pool_id"])
            if pid == tuple(self._pool):
                own += seg["total_size"]
            elif pid == (0, 0):
                spare += seg["total_size"] - seg["allocated_size"]
        return own, spare

    def pool_bytes(self) -> int:
        """Bytes reserved in the graphs' private memory pool (0 before the
        first capture): the step's temporaries, which an eager step
        allocates and frees each time."""
        return self._pool_split()[0] if self._pool is not None else 0

    def make_room(self) -> bool:
        """Before an eager recovery on the card (a replay runs the step
        eagerly): when the card cannot hold the eager step's temporaries
        (about the graphs' pool) beside that pool, drop the graphs, and
        so their pool.  Each is captured again at its next use; storage,
        static arguments and pack buffers keep their addresses.  Returns
        whether the graphs were dropped."""
        if self._pool is None or not self._graphs:
            return False
        own, spare = self._pool_split()
        if torch.cuda.mem_get_info()[0] + spare >= own:
            return False
        self._graphs.clear()
        self._pool = torch.cuda.graph_pool_handle()
        self._dropped = True
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return True

    def load(self, state):
        """The live state tree of the factory's storage holding ``state``:
        ``state`` itself on the CPU or when it already is that storage,
        else a copy of it into the storage the next step reads (a leaf
        that already is the storage's tensor is not copied: a donated
        recovery that repaired the adopted tensors in place copies
        nothing).  Call it after a recovery that produced a new tree."""
        if not self._bufs or not self._on_card(state):
            return state
        if self._dropped:
            # the eager recovery's cached blocks go back to the card
            # before the graphs are captured again
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            self._dropped = False
        b = 0 if self.donate else (self.canary.generation & 1) ^ self._phase
        live = self._bufs[b]
        if state is live:
            return live
        return copy_into(live, state)

    def warm(self, state, *args) -> float:
        """Build every rotation for these argument shapes without stepping
        the run (on the card: capture its 2K graphs).  Returns wall
        seconds; idempotent."""
        if self._warmed:
            return 0.0
        t0 = time.perf_counter()
        if self._on_card(state):
            self._prepare(state, args)
            for r in range(self.n_slices):
                for g in (0, 1):
                    self._graph(r, g)
        else:
            for r in range(self.n_slices):
                self._rotation(r)
        self._warmed = True
        return time.perf_counter() - t0

    # -- hot path ------------------------------------------------------------

    def step(self, s: int, state, *args):
        """One fused step: ``(new_state, aux, report)``.  On the card ONE
        graph replay and ONE scalar fetch."""
        if self.warm_mode == "eager":
            self.warm(state, *args)
        r = s % self.n_slices
        can = self.canary
        kdigest.STATS.launches += 1
        if not self._on_card(state):
            rot = self._rotation(r)
            read, write = can.begin_update()
            new_state, aux, bad, host = self._body(rot, state, None, read,
                                                   write, args)
            return self._finish(s, rot, new_state, aux, bad, host, read,
                                write)
        self._prepare(state, args)
        state = self.load(state)
        self._load_args(args)
        g = can.generation & 1
        ent = self._graph(r, g)
        new_state = self._bufs[0] if self.donate \
            else self._bufs[1 - (g ^ self._phase)]
        rot = self._rotations[r]
        if self.mesh:
            ent.head.graph.replay()
            self._load_front(self._step_front(state, self._args))
            ent.tail.graph.replay()
            _build.LAUNCHES.update(ent.head.launches)
            _build.LAUNCHES.update(ent.tail.launches)
            ent = ent.tail
            host = self._reduce(rot, ent.flag, ent.aux)
        else:
            ent.graph.replay()
            _build.LAUNCHES.update(ent.launches)
            host = ent.host
        return self._finish(s, rot, new_state, ent.aux, ent.bad, host,
                            *can.begin_update())
