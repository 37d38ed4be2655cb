"""Continuous-batching serving engine with slot-isolated recovery — the
off-mesh ``repro/serving/engine.py``.

* **Two cache layouts.**  Paged (the default where the family supports
  it, ``serving/paged.py``: every cache leaf holds ``max_len`` rows, so a
  windowed config pages only within its window): every cache leaf is a
  shared block pool plus
  a per-slot block table, a request owns
  ``ceil((P + 1 + max_new) / block_size)`` blocks and the canary's units
  are (leaf, block) pairs plus one ``pos`` unit per slot; block → owning
  slot is a host allocator lookup, so a flip on a free block evicts
  nobody.  Dense (``paged=False``, a window below ``max_len``, or a
  family with no ``prefill_chunk``): one slot-major cache, every leaf of
  the family's decode cache but ``pos`` stacked ``(S, count, 1, ...)``
  as in the reference (``(S, count, 1, cap, KV, Dh)`` for attention,
  ``cap`` a windowed layer's ring of ``window`` rows, else ``max_len``;
  enc-dec's read-only ``mem_k`` / ``mem_v`` beside its ``k`` / ``v``),
  whose canary units are (leaf, slot) pairs; the batched decode reads
  and writes it in place through a permuted view ``(count, S, ...)``.
* **One engine step** (``engine_step``) advances every lane one token, in
  this order: ``pack_rows`` of the canary's check slice ``s % K`` (before
  any state write); ``gather_blocks`` of each slot's blocks (paged); the
  batched decode (the reference vmapped a B=1 decode: lanes are
  computationally independent either way); the new rows scattered back
  (paged); ``pos += amask``; the forced-token select and the finite trap;
  ``pack_rows`` of the arm slice ``(s+1) % K``; ``CheckArm.finish`` (ONE
  ``row_checksums`` launch, the combine, the on-device compare and arm).
  The host then makes ONE counted ``fetch``: the fault flag with the token
  payload beside it (the data plane, as in the reference).
* **The step as captured CUDA graphs.**  The reference's step is always
  one fused executable.  On the card the port captures the step of
  rotation ``r`` reading canary table ``g = generation & 1`` as one
  ``torch.cuda.CUDAGraph``: 2K graphs sharing one memory pool (with no
  canary, one decode-only graph; two without donation).  A steady step is
  one replay and the one fetch.  ``warm()`` captures every graph (and is
  run by the first step if the caller did not); a capture or replay that
  fails raises, with no eager fallback.  On the CPU the same phases run
  eagerly.  A graph reads the pointers it was captured with, so every
  state update is in place (``copy_`` into the storage), forced tokens go
  through one static buffer, the pack schedules are built before each
  capture and kept with its graph, and a report clones the mismatch mask
  the next replay overwrites.  Installing new params (``scrub_params``,
  ``corrupt_param``) drops the graphs; the next step captures anew.
* **Donation.**  ``donate=True`` (the reference's default): one version of
  the covered state (cache or pool, and ``pos``), written in place by the
  step.  ``donate=False``: the step's input survives it, so there are two
  versions in ping-pong, the live one tied to the canary generation
  (``b = generation & 1``; the step count without a canary): the step
  reads version ``b`` and writes ``1 - b``, one state copy a step.
  Admission writes, fault flips and refreshes go to the live version.
  Both give bit-identical tokens.
* **Chunked prefill** (``prefill_chunk=C`` > 0, paged): a prompt prefills
  in C-token chunks, one per prefilling slot per ``run`` iteration,
  eagerly between engine steps, so a long prompt does not stall the
  decoding lanes.  Chunks equal monolithic prefill in tokens, not bits
  (another reduction order), as in the reference.
* **Per-request features.**  A request's ``features`` (enc-dec's
  ``src_embeds``, (1, Ss, frontend_dim); the VLM's ``patch_embeds``,
  (1, Np, patch_dim), and its m-rope ``positions``, (1, Np + P, 3)) go
  to ``prefill`` beside its prompt, at admission and at every prefix
  replay (an evicted request re-encodes its source or re-projects its
  patches).  The slot's position is the prefilled cache's ``pos`` (the
  prompt's length; Np + P for the VLM, whose patches take the first
  rows; 1 for enc-dec, whose prefill decodes BOS at position 0).  Held
  to the oracle, not the reference: a source whose length is not the
  cache's memory rows (``max_len``) is refused with ``AdmissionError``,
  where the reference attends to stale memory rows or raises; a VLM
  request is refused unless Np + P + 1 + max_new fits ``max_len`` (the
  reference does not count the patch rows, and its decode overwrites
  the cache's last row) and its ``positions`` cover Np + P rows.
* **Slot-isolated recovery.**  On a fault ``plan_serving_recovery``
  evicts only the injured slots (a prefilling slot too); they re-enter
  the queue front and are rebuilt by prefix replay (prefill + forced
  decode over the token log).  Healthy slots keep the fault step's own
  tokens and keep decoding.
* **At-rest parity over the params** (``parity=True``).  Serving never
  writes the params, so one XOR parity build at construction and the
  digests recorded beside it let ``scrub_params`` detect and repair a
  silently flipped weight with no reload.
* **On a mesh** (``ctx``: a meshed ``DistContext``, one engine per rank;
  the reference's mesh mode).  The params shard per
  ``launch/specs.param_shardings`` and the engine holds only the rank's
  blocks (``blocks``): those are the at-rest weights the parity covers,
  the adversary flips and the scrub repairs.  On a model axis wider
  than 1 the compute is tensor-parallel for every family
  (``distributed/tensor_parallel.py``): the model reads the rank's blocks
  in place (``params`` is ``blocks``), its heads, FFN columns, recurrent
  projections and vocabulary rows, with the model axis's collectives
  inside the decode (each layer's new K/V rows gathered so the cache
  stays a replica, the activations that feed a recurrent state gathered
  so the state is computed whole on every rank, the row-parallel sums,
  the logits gathered over the vocabulary); only ``fsdp`` leaves are
  gathered, over the batch axes, once per ``run`` iteration (the blocks
  do not change within one; the reference's partitioner gathers them in
  each call, the same values).  A mesh with no model axis (pure data
  parallelism) reads a whole-params tree in fixed storage (``params``; a
  replicated leaf is its block itself), gathered from every rank's
  blocks by ``gather_tree(..., out=)`` eagerly once per ``run``
  iteration, before the first admission, prefill chunk or engine step
  that reads it (``refresh_params``): no token is computed from weights
  older than the blocks at the start of its iteration.
  The covered state (cache or pool, ``pos``, ``tok``, ``amask``, the
  forced buffer) is replicated: every rank holds all of it and runs the
  same scheduler on the same requests in lockstep.  The canary is
  shard-local over the rank's replica (a ``ShardedDigestPlan``).  A
  graph cannot hold a gloo collective (and NCCL refuses two ranks on one
  card), so on the card a whole-params step's graph records the body up
  to ``CheckArm.finish_local`` (with a lane's non-finite logits folded
  into the local flag), and a tensor-parallel step is two graphs a
  rotation and read table around the eager model: the head (the check
  pack, the ping-pong copy, the paged gather view) and the tail (the
  scatter, ``pos`` advance, forced select over the logits the model
  left in fixed storage, arm pack, ``finish_local``).  ``reduce_flag``
  (the flag's MAX all-reduce) runs eagerly after the replay, before the
  one fetch.  Once the flag fired every rank gathers the mismatch masks
  and the lanes' finite bits (``FaultReport.shards`` names the injured
  replicas), so every rank evicts the same victims.  ``evict_mesh``
  drops a mesh's engines' graphs, cores and gathered storage.
"""

from __future__ import annotations

import math
import time
import weakref
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.detect import (ChecksumCanary, FaultReport,
                                     block_leaf_prefix, block_of_leaf,
                                     slot_leaf_prefix, slot_of_leaf,
                                     slot_view)
from repro_torch.core.faults import bit_width, flip_bit
from repro_torch.core.parity import ParityStore
from repro_torch.core.recover import plan_serving_recovery
from repro_torch.core.replay import copy_into
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import gather_tree, local_tree
from repro_torch.kernels import _build
from repro_torch.kernels import digest as kdigest
from repro_torch.kernels import ops as kops
from repro_torch.launch.specs import param_shardings
from repro_torch.models.registry import get_model
from repro_torch.serving import paged as pgd
from repro_torch.serving.paged import (AdmissionError, BlockAllocator,
                                       PoolSaturated)
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.tree import (flatten_with_path, leaf_key, leaves,
                              replace_leaves, tree_map)

#: eager steps on the card before the first capture (lazy initialisation
#: of cuBLAS and the kernels' host state); at least one per rotation
WARMUP_STEPS = 2

#: every live engine on a mesh (``evict_mesh`` drops a lost mesh's)
_ON_MESH: "weakref.WeakSet[ServingEngine]" = weakref.WeakSet()


def evict_mesh(ctx) -> int:
    """Close every live engine on ``ctx``'s mesh (its axes and ranks):
    after a hard loss its graphs, check+arm cores and gathered params
    storage belong to a mesh that is gone.  Returns the entries dropped
    (graphs + cores + gathered-storage trees)."""
    mk = kdigest.mesh_key(ctx)
    return sum(e.close() for e in list(_ON_MESH)
               if kdigest.mesh_key(e.ctx) == mk)


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; with no card and no
    explicit device, raise rather than carry on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass "
                "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def decode_view(cache):
    """The batched decode's view ``(count, S, ...)`` of a slot-major dense
    cache (every leaf but ``pos`` ``(S, count, 1, ...)``): it aliases the
    cache, so the decode's row writes land in place."""
    view = {k: tree_map(lambda t: t[:, :, 0].transpose(0, 1), v)
            for k, v in cache.items() if k != "pos"}
    view["pos"] = cache["pos"]
    return view


def _pcts(xs: Sequence[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0}
    a = np.asarray(xs, np.float64)
    return {"mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


@dataclass
class ServingReport:
    """Engine telemetry."""
    n_slots: int = 0
    requests: int = 0
    completed: int = 0
    dropped: int = 0
    tokens_out: int = 0
    engine_steps: int = 0
    admissions: int = 0
    admission_rejected: int = 0
    faults_injected: int = 0
    faults_detected: int = 0
    faults_recovered: int = 0
    faults_on_free_slots: int = 0
    replay_tokens: int = 0
    retracted_tokens: int = 0
    decode_ms: List[float] = field(default_factory=list)
    recovery_ms: List[float] = field(default_factory=list)
    injured_rids: Set[int] = field(default_factory=set)
    per_request: Dict[int, Dict] = field(default_factory=dict)

    def summary(self) -> Dict:
        d, r = _pcts(self.decode_ms), _pcts(self.recovery_ms)
        return {
            "requests": self.requests,
            "completed": self.completed,
            "dropped": self.dropped,
            "tokens_out": self.tokens_out,
            "engine_steps": self.engine_steps,
            "admissions": self.admissions,
            "admission_rejected": self.admission_rejected,
            "slots": self.n_slots,
            "faults": {"injected": self.faults_injected,
                       "detected": self.faults_detected,
                       "recovered": self.faults_recovered,
                       "on_free_slots": self.faults_on_free_slots},
            "mean_decode_ms": d["mean"],
            "p50_decode_ms": d["p50"],
            "p99_decode_ms": d["p99"],
            "mean_recovery_ms": r["mean"],
            "p50_recovery_ms": r["p50"],
            "p99_recovery_ms": r["p99"],
            "replay_tokens": self.replay_tokens,
            "retracted_tokens": self.retracted_tokens,
        }


@dataclass
class _Graph:
    """One captured engine step: the graph, its outputs (the host vector
    and the mismatch mask, overwritten by every replay), the pack
    schedules it reads by address, and the kernel launches one replay
    makes."""
    graph: object
    host: torch.Tensor
    bad: Optional[torch.Tensor]
    keep: Tuple
    launches: Counter


@dataclass
class _Split:
    """A tensor-parallel engine step's two graphs (head and tail) around
    the eager model, and the decode view the head leaves for it."""
    head: _Graph
    tail: _Graph
    view: Dict


class ServingEngine:
    """Iteration-level scheduler + batched decoder + rotating canary.

    Parameters
    ----------
    cfg           : full config (``cfg.model`` drives the model)
    n_slots       : batch slots S
    max_len       : per-slot capacity in positions (paged: rounded up to a
                    multiple of ``block_size``)
    canary_slices : rotating canary K; 0 disables the canary
    donate        : one state version written in place by the step (the
                    reference's default); False keeps the step's input
                    (two versions in ping-pong)
    seed          : params init seed (ignored when ``params`` is given)
    max_replays   : fault evictions a request survives before it is dropped
    paged         : None = the paged pool where the family supports it;
                    False forces the dense slot-major cache; True raises
                    if unsupported
    block_size    : KV-pool block size in positions (paged)
    prefill_chunk : 0 = monolithic prefill; C > 0 prefills in C-token
                    chunks interleaved with engine steps (paged only)
    pool_blocks   : pool blocks incl. scratch block 0 (0 = every slot can
                    hold a max-size request)
    ctx           : DistContext for mesh serving (this rank's param blocks,
                    the replicated covered state, the shard-local canary)
                    or None
    device        : torch device; None = the CUDA card, raising if none
                    (on a mesh the rank's, ``ctx.device``)
    params        : ready params (same tree as ``init_lm``; on a mesh the
                    GLOBAL tree, the rank keeps its blocks), e.g. bridged
                    from the reference; None = the port's seeded init
    parity        : keep an XOR parity over the params (``scrub_params``)
    """

    def __init__(self, cfg, *, n_slots: int = 4, max_len: int = 64,
                 canary_slices: int = 4, donate: bool = True, ctx=None,
                 seed: int = 0, max_replays: int = 8, verbose: bool = False,
                 paged: Optional[bool] = None, block_size: int = 8,
                 prefill_chunk: int = 0, pool_blocks: int = 0, device=None,
                 params=None, parity: bool = False):
        self.ctx = ctx if (ctx is not None and ctx.enabled) else None
        self.device = dev = (self.ctx.device if self.ctx is not None
                             else resolve_device(device))
        if dev.type == "cuda":
            # f32 projections as in the reference: no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.m = cfg.model
        self.model = get_model(self.m)
        self.S = S = int(n_slots)
        self.K = int(canary_slices)
        self.donate = bool(donate)
        self.max_replays = int(max_replays)
        self.verbose = verbose
        self.block_size = bs = int(block_size)
        self.prefill_chunk = int(prefill_chunk)
        self.max_len = int(max_len)
        full = (params if params is not None
                else self.model.init(self.m, seed, dev))
        #: on a mesh: the rank's param blocks (the at-rest weights), their
        #: shardings, and (no model axis: whole params) the storage the
        #: model reads; tensor-parallel, the model reads the blocks
        self._blocks = self._psh = self._whole = None
        self._stale = self._closed = False
        self._tp = TP.for_model(self.ctx, self.m)
        self._mkw = {} if self._tp is None else {"tp": self._tp}
        self._zero = False
        #: the fsdp leaves gathered over the batch axes (tensor-parallel)
        self._zeroed = None
        if self.ctx is not None:
            self._psh, _ = param_shardings(self.ctx, cfg, full)
            self._blocks = tree_map(lambda t: t.to(dev),
                                    local_tree(full, self._psh))
            if self._tp is None:
                self._whole = tree_map(
                    lambda b, sh: b if not sh.axes else torch.empty(
                        sh.shape, dtype=sh.dtype, device=dev),
                    self._blocks, self._psh)
                full = self._whole
                self._stale = True
            else:
                full = self._blocks
                batch = set(self.ctx.batch_axes)
                self._zero = self._stale = any(batch & set(sh.axes)
                                               for sh in leaves(self._psh))
            _ON_MESH.add(self)
        #: whether the params the model reads are gathered, once a
        #: ``run`` iteration (marked stale at its start and after a step)
        self._refreshed = self._whole is not None or self._zero
        self.params = full
        #: the tensor-parallel step's logits, where the eager model leaves
        #: them for the tail graph (allocated before the first capture)
        self._logits: Optional[torch.Tensor] = None

        # at-rest parity over the STATIC params: one build here and the
        # healthy digests recorded beside it (one fetch) let
        # ``scrub_params`` detect and repair at-rest corruption; on a
        # mesh over the rank's blocks, the digests per shard
        self.parity_store: Optional[ParityStore] = None
        self._param_refs: Optional[Dict[str, np.ndarray]] = None
        if parity:
            at_rest = self.blocks
            self.parity_store = ParityStore(at_rest, ctx=self.ctx,
                                            shardings=self._psh)
            self.parity_store.build(at_rest)
            if self.ctx is not None:
                self._param_refs = self.parity_store.shard_digests(at_rest)
            else:
                plan = self.parity_store.plan
                table = kdigest.fetch(torch.stack(
                    [kops.checksum(x) for x in plan.leaves(at_rest)]))
                self._param_refs = dict(zip(plan.keys, table))

        # layout: the paged pool unless forced off or unsupported
        self.paged = False
        if paged is not False:
            ml = -(-self.max_len // bs) * bs
            probe = self.model.make_decode_cache(self.m, 1, ml, "meta")
            supported = pgd.paged_supported(self.model, self.m, probe, ml)
            if paged and not supported:
                raise ValueError(
                    "paged=True: this family/config has no paged-KV "
                    "support (needs linear caches, 1-D rope and a "
                    "prefill_chunk entry point)")
            self.paged = supported
            if self.paged:
                self.max_len = ml
        per_slot = self.model.make_decode_cache(self.m, 1, self.max_len, dev)
        # the source rows of an enc-dec slot's memory (0: no memory)
        self._mem_rows = (int(per_slot["mem_k"].shape[2])
                          if "mem_k" in per_slot else 0)
        if self.paged:
            self.max_blocks = self.max_len // bs
            self.n_blocks = int(pool_blocks) or (1 + S * self.max_blocks)
            if self.n_blocks < 2:
                raise ValueError("pool_blocks must be >= 2")
            self.bt = torch.zeros((S, self.max_blocks), dtype=torch.int32,
                                  device=dev)
            self._bt_np = np.zeros((S, self.max_blocks), np.int32)
            self.alloc = BlockAllocator(self.n_blocks)

            def covered():
                return pgd.make_block_pool(per_slot, self.n_blocks, bs)
        else:
            def covered():
                return {k: tree_map(lambda t: torch.zeros(
                    (S,) + tuple(t.shape), dtype=t.dtype, device=dev), v)
                    for k, v in per_slot.items() if k != "pos"}
        # the covered decode state (every cache key, or the pool, and the
        # slots' positions): one version written in place, or two in
        # ping-pong without donation
        self._versions = [
            dict(covered(),
                 pos=torch.zeros((S,), dtype=torch.int32, device=dev))
            for _ in range(1 if self.donate else 2)]
        self.amask = torch.zeros((S,), dtype=torch.bool, device=dev)
        self.tok = torch.zeros((S,), dtype=torch.int32, device=dev)
        # forced tokens (prefix replay): row 0 the mask, row 1 the token
        self._forced = torch.zeros((2, S), dtype=torch.int32, device=dev)
        self._forced_on = False

        self.canary: Optional[ChecksumCanary] = None
        self.plan = None
        self._block_keys: List[Tuple[str, ...]] = []
        self._pos_keys: List[str] = []
        self._slot_keys: List[Tuple[str, ...]] = []
        self._views: List[List[torch.Tensor]] = []
        self._cores: Dict[int, Optional[kdigest.CheckArm]] = {}
        if self.K:
            self.canary = ChecksumCanary(self._view_of(self._versions[0]),
                                         n_slices=self.K, ctx=self.ctx)
            self.plan = self.canary.plan
            if self.paged:
                self._block_keys = [
                    tuple(k for k in self.plan.keys
                          if k.startswith(block_leaf_prefix(b) + "/"))
                    for b in range(self.n_blocks)]
                self._pos_keys = [f"{slot_leaf_prefix(u)}/pos"
                                  for u in range(S)]
            else:
                self._slot_keys = [
                    tuple(k for k in self.plan.keys
                          if k.startswith(slot_leaf_prefix(u) + "/"))
                    for u in range(S)]
            # each version's canary leaves alias its storage, which every
            # update writes in place: valid for the engine's life
            self._views = [self.plan.leaves(self._view_of(v))
                           for v in self._versions]

        self.slot_rid: List[Optional[int]] = [None] * S
        self._by_slot: Dict[int, Request] = {}
        self._prefilling: Dict[int, Dict] = {}   # paged: slot -> {rq, off}
        self.step_count = 0
        self.report = ServingReport(n_slots=S)
        # the card replays captured graphs; the CPU runs the body eagerly
        self._replay = dev.type == "cuda"
        self._pool = None
        self.n_captures = 0
        self.capture_seconds = 0.0

    # -- state versions ------------------------------------------------------

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value) -> None:
        # a captured graph reads the params it was captured with
        self._params = value
        self._graphs: Dict[Tuple[int, int], _Graph] = {}

    @property
    def blocks(self):
        """The at-rest params: on a mesh this rank's blocks, else
        ``params``."""
        return self._blocks if self.ctx is not None else self.params

    def refresh_params(self) -> None:
        """On a mesh with no model axis: gather every rank's blocks
        into the whole-params storage the model reads, in place (a
        collective, eager, outside any graph; the storage keeps its
        pointers, so the graphs stay valid).  Tensor-parallel with fsdp
        leaves: the blocks with those gathered over the batch axes (a
        new tree: the eager model reads it, no graph does).  Off the
        mesh, and tensor-parallel without fsdp (the model reads the
        blocks in place), nothing."""
        if self._closed:
            raise RuntimeError("this engine was closed (evict_mesh)")
        if self._whole is not None:
            gather_tree(self._blocks, self._psh, out=self._whole)
        elif self._zero:
            self._zeroed = gather_tree(self._blocks, self._psh,
                                       axes=self.ctx.batch_axes)
        else:
            return
        self._stale = False

    def _ensure_params(self) -> None:
        """Gather unless this iteration already did (whole params on a
        mesh with no model axis, the fsdp leaves tensor-parallel)."""
        if self._closed:
            raise RuntimeError("this engine was closed (evict_mesh)")
        if self._stale:
            self.refresh_params()

    def _read(self):
        """The params tree the model reads: tensor-parallel with fsdp
        leaves, the blocks with those gathered over the batch axes (once
        a ``run`` iteration and after every engine step, as the whole
        params are: every call of the iteration reads the same blocks);
        else ``params``."""
        if self._zero:
            self._ensure_params()
            return self._zeroed
        return self.params

    @property
    def n_graphs(self) -> int:
        """CUDA graphs held: one per rotation and read table, two for a
        tensor-parallel step (head and tail)."""
        return sum(2 if isinstance(e, _Split) else 1
                   for e in self._graphs.values())

    def close(self) -> int:
        """Drop the graphs, the check+arm cores and, on a mesh, the
        gathered params storage; the engine is unusable after it.  Returns
        the entries dropped."""
        n = (len(self._graphs) + sum(c is not None
                                     for c in self._cores.values())
             + (self._whole is not None))
        self._graphs.clear()
        self._cores.clear()
        self._pool = None
        if self.ctx is not None:
            self._whole = self._params = self._zeroed = None
            self._stale = False
            self._closed = True
        _ON_MESH.discard(self)
        return n

    def _gen(self) -> int:
        return (self.canary.generation if self.canary is not None
                else self.step_count)

    def _live(self) -> int:
        """Index of the state version the next step reads."""
        return 0 if self.donate else self._gen() & 1

    @property
    def pos(self) -> torch.Tensor:
        return self._versions[self._live()]["pos"]

    @property
    def pool(self):
        """The live block pool (paged), else None."""
        if not self.paged:
            return None
        return {"groups": self._versions[self._live()]["groups"]}

    @property
    def cache(self):
        """The live slot-major cache (dense: the family's cache keys and
        ``pos``), else None."""
        return None if self.paged else self._versions[self._live()]

    def _view_of(self, ver):
        """Canary view of one state version: (leaf, block) + per-slot pos
        (paged) or (leaf, slot) with the slot's pos (dense)."""
        if self.paged:
            return pgd.paged_canary_view({"groups": ver["groups"]},
                                         ver["pos"], self.n_blocks, self.S)
        return slot_view(ver, self.S)

    def _view(self):
        return self._view_of(self._versions[self._live()])

    def _refresh_blocks(self, blocks) -> None:
        """Re-certify the given pool blocks' canary rows after an
        out-of-step pool write (both generations, no generation bump)."""
        if self.canary is None or not blocks:
            return
        view = self._view()
        for b in sorted(set(blocks)):
            self.canary.refresh(view, keys=self._block_keys[b])

    def _rotation(self, r: int) -> Optional[kdigest.CheckArm]:
        """The check+arm core of rotation ``r`` with its packing buffer
        and layout maps on the device (None: nothing to digest)."""
        if r in self._cores:
            return self._cores[r]
        can = self.canary
        core, union = kdigest.check_arm_subcomputation(
            self.plan, can._slice_indices(r), can._slice_indices(r + 1),
            n_slices=can.n_slices)
        if union:
            core.layout.maps(core.buffer().device)
        else:
            core = None
        self._cores[r] = core
        return core

    # -- the engine step: the body, and its graphs on the card ---------------

    def _decode_view(self, ver):
        """The decode cache the model reads and writes in place: the
        pool's blocks gathered (paged) or the slot-major cache."""
        if self.paged:
            return pgd.gathered_cache({"groups": ver["groups"]}, self.bt,
                                      ver["pos"])
        return decode_view(ver)

    def _model(self, view):
        """The batched decode over ``view`` (its new K/V rows written in
        place): the step's logits (S, V).  Tensor-parallel, it holds the
        model axis's collectives."""
        return self.model.decode_step(self._read(), self.m, view, self.tok,
                                      **self._mkw)[0]

    def _decode_out(self, ver, view, logits):
        """In-place scatter-back (paged) and position advance on state
        version ``ver``, the forced select.  Returns (next tokens (S,),
        finite (S,)) on the device."""
        if self.paged:
            pgd.scatter_token({"groups": ver["groups"]}, view["groups"],
                              self.bt, ver["pos"], self.amask,
                              self.block_size)
        ver["pos"].add_(self.amask.to(torch.int32))
        nxt = torch.where(self._forced[0] != 0, self._forced[1],
                          logits.argmax(-1).to(torch.int32))
        self.tok.copy_(nxt)
        return nxt, torch.isfinite(logits).all(dim=-1)

    def _versions_of(self, g: int):
        b = 0 if self.donate else g & 1
        return b, self._versions[b], self._versions[0 if self.donate
                                                     else 1 - b]

    def _head(self, r: int, g: int, desc=None):
        """The step's device work before the model: the check pack (before
        any state write), the ping-pong copy and the decode view."""
        b, inp, out = self._versions_of(g)
        core = self._rotation(r) if self.canary is not None else None
        if core is not None:
            lv = self._views[b]
            core.pack_check(core.buffer(), [lv[i] for i in core.chk],
                            desc=desc)
        if out is not inp:
            copy_into(out, inp)
        return self._decode_view(out)

    def _body(self, r: int, g: int, descs=(None, None)):
        """One engine step of rotation ``r`` against read table ``g``:
        what a graph records, and what runs eagerly on the CPU.  Returns
        (host vector: [flag,] tokens, finite; mismatch mask | None)."""
        view = self._head(r, g, descs[0])
        return self._tail(r, g, view, self._model(view), descs[1])

    def _tail(self, r: int, g: int, view, logits, desc=None):
        """The step's device work after the model: scatter, advance,
        forced select, the arm pack and the local check."""
        b, _, out = self._versions_of(g)
        core = self._rotation(r) if self.canary is not None else None
        nxt, finite = self._decode_out(out, view, logits)
        parts = [nxt, finite.to(torch.int32)]
        bad = None
        if core is not None:
            buf = core.buffer()
            lv = self._views[0 if self.donate else 1 - b]
            core.pack_arm(buf, [lv[i] for i in core.arm], desc=desc)
            tables = self.canary._tables
            # the local flag: on a mesh ``engine_step`` reduces it over
            # the ranks after the replay (a graph cannot hold the
            # collective), with a lane's non-finite logits folded in, so
            # a fault any rank sees is acted on by every rank
            flag, bad = core.finish_local(buf, tables[g & 1],
                                          tables[1 - (g & 1)])
            if self.ctx is not None:
                flag = flag | (self.amask & ~finite).any()
            parts.insert(0, flag.to(torch.int32).reshape(1))
        elif self.canary is not None:
            # a rotation with nothing to digest: a flag that never fires
            parts.insert(0, torch.zeros((1,), dtype=torch.int32,
                                        device=nxt.device))
        return torch.cat(parts), bad

    def _key(self, r: int, g: int) -> Tuple[int, int]:
        # donated with no canary the step reads no table and one version
        return (r, g & 1) if (self.canary is not None
                              or not self.donate) else (r, 0)

    def _graph_keys(self) -> List[Tuple[int, int]]:
        return sorted({self._key(r, g) for r in range(max(1, self.K))
                       for g in (0, 1)})

    def _record(self, fn):
        """Capture ``fn()`` as one graph in the engine's pool: ``(graph,
        fn's result, the kernel launches one replay makes)``."""
        before = Counter(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool):
            got = fn()
        self.capture_seconds += time.perf_counter() - t0
        self.n_captures += 1
        # nothing ran during the capture: its kernels count at each replay
        launches = Counter(_build.LAUNCHES)
        launches.subtract(before)
        _build.LAUNCHES.subtract(launches)
        return graph, got, +launches

    def _capture(self, r: int, g: int):
        """Capture rotation ``r``'s step against read table ``g``: one
        graph, or (tensor-parallel) the head and the tail around the
        eager model."""
        b = 0 if self.donate else g & 1
        core = self._rotation(r) if self.canary is not None else None
        descs = (None, None)
        if core is not None:
            lin = self._views[b]
            lout = self._views[0 if self.donate else 1 - b]
            descs = core.descriptors([lin[i] for i in core.chk],
                                     [lout[i] for i in core.arm])
        if self._tp is None:
            graph, (host, bad), lt = self._record(
                lambda: self._body(r, g, descs))
            return _Graph(graph, host, bad, descs, lt)
        hg, view, lh = self._record(lambda: self._head(r, g, descs[0]))
        tg, (host, bad), lt = self._record(
            lambda: self._tail(r, g, view, self._logits, descs[1]))
        return _Split(_Graph(hg, None, None, descs, lh),
                      _Graph(tg, host, bad, descs, lt), view)

    def _capture_all(self) -> None:
        """Warm up eagerly (every rotation once, on a side stream), then
        capture every graph.  The state, the last tokens and the canary's
        tables are saved before the warm-up and restored after it, so
        warming changes nothing the next step reads."""
        mutable = [t for v in self._versions for t in leaves(v)]
        mutable.append(self.tok)
        if self.canary is not None:
            mutable.extend(self.canary._tables)
        saved = [t.clone() for t in mutable]
        self._pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(max(WARMUP_STEPS, self.K)):
                self._body(i % max(1, self.K), i)
        torch.cuda.current_stream().wait_stream(side)
        if self._tp is not None and self._logits is None:
            self._logits = torch.zeros((self.S, self.m.vocab_size),
                                       dtype=torch.float32,
                                       device=self.device)
        for r, g in self._graph_keys():
            self._graphs[(r, g)] = self._capture(r, g)
        for t, v in zip(mutable, saved):
            t.copy_(v)

    def warm(self) -> float:
        """Build the kernels, every rotation's packing buffer and layout
        and, on the card, capture every graph of the step (2K; one or two
        without a canary).  Returns wall seconds; idempotent."""
        t0 = time.perf_counter()
        self._ensure_params()
        if self.device.type == "cuda":
            _build.lib()
        if self.canary is not None:
            for r in range(self.K):
                self._rotation(r)
        if self._replay and not self._graphs:
            self._capture_all()
        return time.perf_counter() - t0

    def _load_forced(self) -> None:
        """Install this step's forced tokens in the static buffer; zero it
        once when forcing ends (steady steps upload nothing)."""
        forced = [(u, rq.forced[0]) for u, rq in self._by_slot.items()
                  if rq.forced]
        if forced:
            a = np.zeros((2, self.S), np.int32)
            for u, t in forced:
                a[0, u], a[1, u] = 1, t
            self._forced.copy_(torch.from_numpy(a))
            self._forced_on = True
        elif self._forced_on:
            self._forced.zero_()
            self._forced_on = False

    def engine_step(self) -> Tuple[np.ndarray, np.ndarray,
                                   Optional[FaultReport]]:
        """Advance every lane one token: one logical launch (counted in
        ``kdigest.STATS``; one graph replay on the card) and ONE counted
        fetch of the fault flag with the token payload beside it (with no
        canary an uncounted payload transfer: the data plane).

        On a mesh the flag is all-reduced (MAX) after the replay, before
        the fetch; when it fired every rank gathers the masks and the
        lanes' finite bits, so all act on the same report and lanes.

        Returns ``(tokens (S,), finite (S,) bool, report|None)``."""
        self._ensure_params()
        if self._replay and not self._graphs:
            self.warm()
        s = self.step_count
        r = s % self.K if self.K else 0
        g = self._gen() & 1
        self._load_forced()
        kdigest.STATS.launches += 1
        if self._replay:
            ent = self._graphs[self._key(r, g)]
            if isinstance(ent, _Split):
                ent.head.graph.replay()
                _build.LAUNCHES.update(ent.head.launches)
                self._logits.copy_(self._model(ent.view))
                ent = ent.tail
            ent.graph.replay()
            _build.LAUNCHES.update(ent.launches)
            host, bad = ent.host, ent.bad
        else:
            host, bad = self._body(r, g)
        report = None
        if self.canary is not None:
            core = self._rotation(r)
            if self.ctx is not None and core is not None:
                host[:1].copy_(core.reduce_flag(host[:1]).to(host.dtype))
            self.canary.commit_update(self.canary.begin_update()[1])
            vals = kdigest.fetch(host)          # the step's ONE fault sync
            fired, vals = bool(vals[0]), vals[1:]
            if fired:
                detail = "paged block canary" if self.paged \
                    else "slot canary"
                if self.ctx is None:
                    report = FaultReport(s, "checksum", detail=detail,
                                         resolver=self._resolver(
                                             core.chk, bad.clone()))
                else:
                    report, vals = self._mesh_fault(s, detail, core, bad,
                                                    vals)
        else:
            vals = host.cpu().numpy()
        self.step_count += 1
        self._stale = self._refreshed
        return vals[:self.S], vals[self.S:].astype(bool), report

    def _mesh_fault(self, s: int, detail: str, core, bad, vals):
        """The fault path of a mesh step (every rank, the flag having
        fired on all): the mismatch masks gathered (``FaultReport.shards``
        names the injured replicas; no mismatch on any rank: no report,
        as off the mesh) and the lanes' finite bits ANDed over the
        ranks.  Returns ``(report | None, vals)``."""
        from repro_torch.distributed import collectives as coll
        group = self.ctx.group(self.ctx.axis_names)
        fin = torch.from_numpy(np.ascontiguousarray(
            vals[self.S:])).to(torch.int32).to(self.device)
        vals = vals.copy()
        vals[self.S:] = kdigest.fetch(coll.all_reduce(fin, "min", group))
        leaves, shards = self._resolver(core.chk, bad)()
        if not leaves:
            return None, vals
        return FaultReport(s, "checksum", leaves=leaves, shards=shards,
                           detail=detail), vals

    def _resolver(self, chk, bad):
        """Attribution closure.  Paged: (leaf, block) keys of blocks a
        request owned AT DETECTION TIME become ``slotNNN/blockNNNN/...``
        keys; unowned blocks keep their raw keys (nobody to evict).
        Dense: the (leaf, slot) keys as they are.  On a mesh the closure
        returns ``(leaves, shards)`` (the masks gathered: a
        collective)."""
        can = self.canary
        owner = dict(self.alloc.owner) if self.paged else {}

        def xlat(k):
            b = block_of_leaf(k)
            o = owner.get(b) if b is not None else None
            return k if o is None else f"{slot_leaf_prefix(o)}/{k}"
        if self.ctx is not None:
            def attribution():
                got, shards = can._attribution(chk, bad)
                return (sorted(xlat(k) for k in got),
                        {xlat(k): v for k, v in shards.items()})
            return attribution
        return lambda: sorted(xlat(k) for k in can._attribute(chk, bad))

    # -- scheduler: admission / acceptance / eviction ------------------------

    def free_slots(self) -> List[int]:
        return [u for u in range(self.S) if self.slot_rid[u] is None]

    def check_admissible(self, rq: Request) -> None:
        """Typed rejection of a request whose worst-case footprint can
        never fit: the block budget (paged) or ``max_len`` (dense), a
        VLM request's patch rows counted; of an enc-dec request whose
        ``src_embeds`` do not fill the slot's encoder memory of
        ``max_len`` rows exactly; and of a VLM request whose
        ``patch_embeds`` are not (1, Np, patch_dim) or whose
        ``positions`` are not (1, Np + P, 3)."""
        rows = len(rq.prompt)
        if self.m.patch_dim:
            rows += self._check_vlm_features(rq)
        need = rows + 1 + rq.max_new_tokens
        if self._mem_rows:
            src = rq.features.get("src_embeds")
            want = (1, self._mem_rows, self.m.frontend_dim)
            if src is None or tuple(src.shape) != want:
                raise AdmissionError(
                    f"rid={rq.rid}: src_embeds "
                    f"{None if src is None else tuple(src.shape)}, the "
                    f"slot's encoder memory takes {want} (its rows are "
                    f"max_len)")
        if not self.paged:
            if need > self.max_len:
                raise AdmissionError(
                    f"rid={rq.rid}: needs {need} positions (prompt "
                    f"{len(rq.prompt)}, patches {rows - len(rq.prompt)}, "
                    f"+ 1 + max_new {rq.max_new_tokens}), slot capacity "
                    f"is {self.max_len}")
            return
        nb = pgd.blocks_needed(len(rq.prompt), rq.max_new_tokens,
                               self.block_size)
        if nb > self.max_blocks:
            raise AdmissionError(
                f"rid={rq.rid}: needs {nb} blocks ({need} positions), "
                f"per-slot budget is {self.max_blocks} blocks "
                f"({self.max_len} positions)")
        if nb > self.alloc.capacity:
            raise AdmissionError(
                f"rid={rq.rid}: needs {nb} blocks, whole pool holds "
                f"{self.alloc.capacity}")

    def _check_vlm_features(self, rq: Request) -> int:
        """The patch rows ``Np`` of a VLM request (0 without patches),
        after its features' shapes are checked: ``patch_embeds`` (1, Np,
        patch_dim), ``positions`` (1, Np + P, 3) when given."""
        patches = rq.features.get("patch_embeds")
        n = 0
        if patches is not None:
            n = int(patches.shape[1]) if patches.ndim == 3 else -1
            if tuple(patches.shape) != (1, n, self.m.patch_dim):
                raise AdmissionError(
                    f"rid={rq.rid}: patch_embeds {tuple(patches.shape)}, "
                    f"want (1, Np, {self.m.patch_dim})")
        positions = rq.features.get("positions")
        want = (1, n + len(rq.prompt), 3)
        if positions is not None and tuple(positions.shape) != want:
            raise AdmissionError(
                f"rid={rq.rid}: positions {tuple(positions.shape)}, the "
                f"prefill's {n} patch + {len(rq.prompt)} prompt rows take "
                f"{want}")
        return n

    def _prompt(self, tokens) -> torch.Tensor:
        return torch.from_numpy(
            np.asarray(tokens, np.int32)[None]).to(self.device)

    def _batch(self, rq: Request) -> Dict[str, torch.Tensor]:
        """The prefill batch of ``rq``: its prompt and its features."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in rq.features.items()}
        batch["tokens"] = self._prompt(rq.prompt)
        return batch

    def _claim(self, rq: Request, slot: int, now_s: float) -> None:
        self.slot_rid[slot] = rq.rid
        rq.slot = slot
        rq.state = "active"
        if rq.t_admit_s < 0:
            rq.t_admit_s = now_s
        self.report.admissions += 1

    def admit(self, rq: Request, slot: int, now_s: float = 0.0, *,
              interleave: bool = False) -> None:
        """Prefill the request into ``slot``, re-certify the canary rows
        it touched and activate the lane.

        Paged, it first reserves the request's block budget (may raise
        ``PoolSaturated``); with ``interleave=True`` and a
        ``prefill_chunk`` it only does the bookkeeping, and ``run``
        prefills the prompt chunk by chunk (``_prefill_step``) between
        engine steps.  Dense, the prefilled cache goes into the slot in
        one in-place write, its ``pos`` the slot's position."""
        self.check_admissible(rq)
        self._ensure_params()
        if self.paged:
            self._admit_paged(rq, slot, now_s, interleave=interleave)
            return
        logits, sub = self.model.prefill(self._read(), self.m,
                                         self._batch(rq),
                                         max_len=self.max_len, **self._mkw)
        keys = [k for k in sub if k != "pos"]
        copy_into({k: tree_map(lambda t: t[slot], self.cache[k])
                   for k in keys}, {k: sub[k] for k in keys})
        self._claim(rq, slot, now_s)
        if self.verbose:
            kind = "replay" if rq.log else "admit"
            print(f"[engine] {kind} rid={rq.rid} -> slot {slot} "
                  f"(log={len(rq.log)})")
        self._activate(rq, slot, sub["pos"][0], logits)

    def _admit_paged(self, rq: Request, slot: int, now_s: float, *,
                     interleave: bool) -> None:
        """Reserve the block budget, zero the blocks (a freed block may
        hold non-finite bytes), wire the block table and prefill — now,
        or chunk by chunk from ``run``.  Every pool write here is out of
        step, so the touched blocks are re-certified before the next
        engine step."""
        nb = pgd.blocks_needed(len(rq.prompt), rq.max_new_tokens,
                               self.block_size)
        bids = self.alloc.allocate(slot, nb)
        pgd.zero_blocks(self.pool, torch.tensor(bids, device=self.device))
        self._bt_np[slot] = 0
        self._bt_np[slot, :nb] = bids
        self.bt.copy_(torch.from_numpy(self._bt_np))
        self._claim(rq, slot, now_s)
        if self.verbose:
            kind = "replay" if rq.log else "admit"
            print(f"[engine] {kind} rid={rq.rid} -> slot {slot} "
                  f"({nb} blocks {bids})")
        self._prefilling[slot] = {"rq": rq, "off": 0}
        if interleave and self.prefill_chunk > 0:
            self._refresh_blocks(bids)
            return
        while slot in self._prefilling:
            self._prefill_step(slot, refresh=False)
        self._refresh_blocks(bids)

    def _prefill_step(self, slot: int, refresh: bool = True) -> None:
        """Advance one slot's prefill by one unit — the whole prompt, or
        one ``prefill_chunk`` of it against the context already in the
        pool — and scatter its rows into the slot's blocks (in place,
        only the valid rows: scratch block 0 is not written).  With
        ``refresh`` the touched blocks are re-certified; the last unit
        activates the lane."""
        self._ensure_params()
        st = self._prefilling[slot]
        rq, off = st["rq"], st["off"]
        P = len(rq.prompt)
        bs = self.block_size
        pool, bt_row = self.pool, self.bt[slot]
        if self.prefill_chunk <= 0:
            logits, sub = self.model.prefill(self._read(), self.m,
                                             self._batch(rq), **self._mkw)
            pgd.scatter_span(pool, sub["groups"], bt_row, 0, P, bs)
            end = P
        else:
            C = self.prefill_chunk
            valid = min(C, P - off)
            chunk = np.zeros((C,), np.int32)
            chunk[:valid] = np.asarray(rq.prompt, np.int32)[off:off + valid]
            logits, new_kv = self.model.prefill_chunk(
                self._read(), self.m, {"tokens": self._prompt(chunk)},
                pgd.ctx_from_pool(pool, bt_row, bs, off),
                pgd.ctx_kpos(off, self.max_len, self.device), off, valid,
                **self._mkw)
            pgd.scatter_span(pool, new_kv["groups"], bt_row, off, valid, bs)
            end = off + valid
        st["off"] = end
        if refresh:
            self._refresh_blocks(self.alloc.owned(slot)[off // bs:
                                                        -(-end // bs)])
        if end >= P:
            del self._prefilling[slot]
            self._activate(rq, slot, P, logits)

    def _activate(self, rq: Request, slot: int, P, logits) -> None:
        """Install the first decode input and the slot's position ``P``
        (an int, or the prefilled cache's 0-d ``pos`` on the device) and
        flip the lane active."""
        if rq.log:
            # prefix replay: the log IS the RSI
            t0 = rq.log[0]
            rq.forced = deque(rq.log[1:])
            self.report.replay_tokens += len(rq.log) - 1
        else:
            t0 = int(logits[0].argmax())
            rq.log = [t0]
        self.pos[slot] = P
        self.tok[slot] = t0
        self.amask[slot] = True
        if self.canary is not None:
            keys = ([self._pos_keys[slot]] if self.paged
                    else list(self._slot_keys[slot]))
            self.canary.refresh(self._view(), keys=keys)
        self._by_slot[slot] = rq

    def _free(self, slot: int) -> None:
        self.slot_rid[slot] = None
        self._by_slot.pop(slot, None)
        if self.paged:
            self._prefilling.pop(slot, None)
            self.alloc.free(slot)
            self._bt_np[slot] = 0
            self.bt.copy_(torch.from_numpy(self._bt_np))
        self.amask[slot] = False

    def _finish(self, rq: Request, now_s: float, dropped: bool = False
                ) -> None:
        rq.state = "dropped" if dropped else "done"
        rq.t_done_s = now_s
        self.report.per_request[rq.rid] = {
            "arrival_s": rq.arrival_s,
            "t_admit_s": rq.t_admit_s,
            "t_first_s": rq.t_first_s,
            "t_done_s": now_s,
            "e2e_s": now_s - rq.arrival_s,
            "n_out": rq.n_out,
            "replays": rq.replays,
            "retracted": rq.retracted,
            "dropped": dropped,
            "tokens": list(rq.log[1:]),
        }
        if dropped:
            self.report.dropped += 1
        else:
            self.report.completed += 1

    def _accept(self, tokens: np.ndarray, now_s: float) -> None:
        """Fold one step's payload into the active requests."""
        for u in sorted(self._by_slot):
            rq = self._by_slot[u]
            if rq.forced:
                # forced replay output — already in the log
                rq.forced.popleft()
                continue
            rq.log.append(int(tokens[u]))
            self.report.tokens_out += 1
            if rq.t_first_s < 0:
                rq.t_first_s = now_s
            if rq.done:
                self._finish(rq, now_s)
                self._free(u)

    def handle_fault(self, report: Optional[FaultReport],
                     finite: np.ndarray, now_s: float,
                     queue: RequestQueue) -> List[int]:
        """Slot-isolated recovery: evict injured slots (prefilling ones
        too) to prefix replay.  Returns the evicted slot ids."""
        rep = self.report
        rep.faults_detected += 1
        nf = [u for u in self._by_slot if not finite[u]]
        plan = plan_serving_recovery(report, n_slices=self.K,
                                     nonfinite_slots=nf)
        occupied = sorted(set(self._by_slot) | set(self._prefilling))
        victims = occupied if plan.scope == "engine" else plan.slots
        refresh_blocks: set = set()
        if self.paged:
            # snapshot BEFORE the frees below return blocks to the pool:
            # the injured and victim-owned blocks keep their bytes until
            # the next zero-on-alloc, and their units must not fire again
            if report is not None:
                refresh_blocks |= set(report.injured_blocks())
            for u in victims:
                refresh_blocks |= set(self.alloc.owned(u))
        any_dropped = False
        for u in victims:
            rq = self._by_slot.get(u)
            if rq is None and u in self._prefilling:
                rq = self._prefilling[u]["rq"]
            if rq is None:
                # occupant already gone: SDC-risk telemetry
                rep.faults_on_free_slots += 1
                continue
            n = plan.retract if plan.retract is not None else rq.n_out
            removed = rq.retract(n)
            rep.retracted_tokens += removed
            rep.tokens_out -= removed
            rq.replays += 1
            rq.t_evicted_s = now_s
            rep.injured_rids.add(rq.rid)
            self._free(u)
            if rq.replays > self.max_replays:
                self._finish(rq, now_s, dropped=True)
                any_dropped = True
            else:
                queue.requeue_front(rq)
            if self.verbose:
                print(f"[engine] FAULT step {self.step_count} slot {u} "
                      f"rid={rq.rid} ({plan.reason}) — retract {removed}, "
                      f"replaying {len(rq.log) - 1} tokens")
        if self.paged:
            if plan.scope == "slots" and not victims and report is not None:
                # attribution landed only on unowned pool blocks
                rep.faults_on_free_slots += 1
            if self.canary is not None:
                self._refresh_blocks(refresh_blocks)
                for u in victims:
                    self.canary.refresh(self._view(),
                                        keys=[self._pos_keys[u]])
        elif self.canary is not None and victims:
            # re-certify every evicted lane against its current bytes: it
            # keeps decoding until the next admission overwrites it, and
            # its units must not fire again meanwhile
            self.canary.refresh(self._view(), keys=[
                k for u in victims for k in self._slot_keys[u]])
        if not any_dropped:
            rep.faults_recovered += 1
        return victims

    # -- fault injection (evaluation adversary) ------------------------------

    def _owned_unit_keys(self, u: int) -> List[str]:
        """Canary keys a slot owns: its blocks' units plus its pos unit
        (paged), its (leaf, slot) units (dense)."""
        if not self.paged:
            return list(self._slot_keys[u])
        keys = [k for b in self.alloc.owned(u) for k in self._block_keys[b]]
        keys.append(self._pos_keys[u])
        return keys

    def corrupt_slot(self, rng, slot: Optional[int] = None,
                     key: Optional[str] = None, bit: Optional[int] = None,
                     armed_only: bool = False,
                     ranks: Optional[Sequence[int]] = None
                     ) -> Tuple[int, str, int]:
        """Flip one bit of one element of one canary unit of the live
        state, in place.  On a mesh every rank draws the same values and
        flips the same element of its replica (the reference's replicated
        flip); ``ranks`` (shard ids) confines the flip to those ranks'
        replicas — one device's fault, a test hook of the same model.

        A slot target is the set of units the slot owns.  ``armed_only``
        restricts the pick to units armed for the NEXT step's check (the
        protected at-rest window), so every flip is detected; otherwise
        the pick is uniform over the owned units, a raw-coverage
        measurement.  ``key`` names a plan key directly (paged:
        ``blockNNNN/...`` — even an unowned block — or ``slotNNN/pos``;
        dense: ``slotNNN/<leaf>``).  Returns (owning slot | -1, plan key,
        bit)."""
        if self.canary is None:
            raise ValueError("corrupt_slot needs the canary (K > 0)")
        active = [u for u in range(self.S) if self.slot_rid[u] is not None]
        if key is None:
            if armed_only:
                cls = self.step_count % self.K

                def cands(lanes):
                    return [k_ for u_ in lanes
                            if slot is None or u_ == slot
                            for k_ in self._owned_unit_keys(u_)
                            if self.plan.index_of(k_) % self.K == cls]
                picks = cands(active) or cands(range(self.S))
            else:
                lanes = ([slot] if slot is not None
                         else (active or list(range(self.S))))
                picks = [k_ for u_ in lanes
                         for k_ in self._owned_unit_keys(u_)]
            if not picks:
                picks = (list(self._pos_keys) if self.paged
                         else [k for ks in self._slot_keys for k in ks])
            key = picks[rng.randrange(len(picks))]
        if self.paged and key in self._pos_keys:
            u = self._pos_keys.index(key)
            unit, start, per = self.pos, u, 1
        else:
            rest = key.split("/", 1)[-1]
            if self.paged:
                u = block_of_leaf(key)
                tree = self.pool
            else:
                u = slot_of_leaf(key)
                tree = self.cache
            if u is None:
                raise KeyError(key)
            unit = next((x for p, x in flatten_with_path(tree)
                         if leaf_key(p) == rest), None)
            if unit is None:
                raise KeyError(key)
            per = max(1, unit[0].numel())
            start = u * per
            if self.paged:
                u = self.alloc.owner.get(u, -1)
        # the reference draws the element of every dense unit, a 1-element
        # ``pos`` too, and none for a paged ``pos`` unit
        e = rng.randrange(per) if per > 1 or not self.paged else 0
        b = bit if bit is not None else rng.randrange(bit_width(unit))
        if self._flips_here(ranks):
            flip_bit(unit, start + e, b)
        self.report.faults_injected += 1
        rid = self.slot_rid[u] if 0 <= u < self.S else None
        if rid is not None:
            self.report.injured_rids.add(rid)
        return u, key, b

    def _flips_here(self, ranks) -> bool:
        """Does a flip confined to ``ranks`` (shard ids; None: every
        rank) land in this rank's replica?"""
        if ranks is None:
            return True
        if self.ctx is None:
            raise ValueError("ranks= confines a flip to ranks of a mesh")
        return self.ctx.shard_id in set(ranks)

    def corrupt_param(self, rng, key: Optional[str] = None,
                      bit: Optional[int] = None,
                      ranks: Optional[Sequence[int]] = None
                      ) -> Tuple[str, int]:
        """Flip one bit of one element of a parity-covered param leaf —
        the at-rest weight-rot adversary ``scrub_params`` exists for.  The
        flip goes into a copy of the leaf that replaces it in this
        engine's params tree, so another engine built over the same
        params is untouched.  On a mesh the element is drawn over the
        GLOBAL leaf, as the reference does, and every rank holding it
        flips its block in place (``ranks``: only those shard ids' blocks
        — one device's fault).  Returns (leaf key, bit)."""
        if self.parity_store is None:
            raise ValueError("corrupt_param requires parity=True")
        plan = self.parity_store.plan
        if key is None:
            key = plan.keys[rng.randrange(len(plan.keys))]
        leaf = dict(zip(plan.keys, plan.leaves(self.blocks)))[key]
        if self.ctx is not None:
            sh = {leaf_key(p): x for p, x in
                  flatten_with_path(self._psh)}[key]
            e = rng.randrange(max(1, math.prod(sh.shape)))
            b = bit if bit is not None else rng.randrange(bit_width(leaf))
            j = sh.local_index(e)
            if j is not None and self._flips_here(ranks):
                flip_bit(leaf, j, b)
            self._stale = self._refreshed
        else:
            self._flips_here(ranks)
            e = rng.randrange(max(1, leaf.numel()))
            b = bit if bit is not None else rng.randrange(bit_width(leaf))
            flipped = flip_bit(leaf.clone(), e, b)
            self.params = replace_leaves(self.params, {key: flipped})
        self.report.faults_injected += 1
        return key, b

    def scrub_params(self) -> Dict:
        """At-rest integrity sweep over the params: verify every covered
        leaf against the load-time digests and XOR-reconstruct an injured
        block from the parity and its peers (no reload).  Repaired params
        are installed, so later decode steps use healthy weights.  On a
        mesh (a collective) the per-shard digests name the injured block
        and every holder installs its repair in place (the graphs keep
        their pointers).  Returns the scrub stats with the parity's
        ``memory_bytes``."""
        if self.parity_store is None:
            raise ValueError("scrub_params requires parity=True")
        new_params, stats = self.parity_store.scrub(self.blocks,
                                                    self._param_refs)
        if stats["repaired"]:
            if self.ctx is None:
                self.params = new_params
            else:
                self._stale = self._refreshed
            self.report.faults_detected += stats["repaired"]
            self.report.faults_recovered += stats["repaired"]
        stats["memory_bytes"] = self.parity_store.memory_bytes
        return stats

    # -- run loop ------------------------------------------------------------

    def run(self, requests: Sequence[Request], *, inject_every: int = 0,
            inject_rng=None, inject_armed_only: bool = True,
            clock=None) -> ServingReport:
        """Drive the engine until every request completes (or drops).

        ``inject_every`` > 0 runs the fault-storm adversary: one bit flip
        every N ACCEPTED tokens, by default into the canary's protected
        window (``inject_armed_only``), so every storm fault is detected
        and the recovery path is what gets measured.  ``clock`` overrides
        the engine clock (seconds; default: wall time since this call).

        On a mesh every rank runs this loop over the same requests in
        lockstep, and the params are gathered once an iteration, before
        the first admission, prefill chunk or step that reads them.  A
        wall clock would admit open-loop arrivals at different times on
        different ranks, so arrivals after 0 need a ``clock`` that every
        rank reads alike (a ``VirtualClock``)."""
        if self.ctx is not None and clock is None and any(
                rq.arrival_s > 0 for rq in requests):
            raise ValueError("mesh serving admits in lockstep: open-loop "
                             "arrivals need a clock every rank reads "
                             "alike (e.g. VirtualClock)")
        queue = RequestQueue(requests)
        rep = self.report
        rep.requests += len(requests)
        t_start = time.perf_counter()
        clock = clock or (lambda: time.perf_counter() - t_start)
        next_inject = rep.tokens_out + inject_every
        interleave = self.paged and self.prefill_chunk > 0
        while True:
            # a new iteration reads the blocks anew (on a mesh)
            self._stale = self._refreshed
            while True:
                free = self.free_slots()
                if not free:
                    break
                rq = queue.pop_ready(clock())
                if rq is None:
                    break
                evicted_at = rq.t_evicted_s
                try:
                    self.admit(rq, free[0], now_s=clock(),
                               interleave=interleave)
                except AdmissionError as err:
                    rep.admission_rejected += 1
                    if self.verbose:
                        print(f"[engine] REJECT {err}")
                    self._finish(rq, clock(), dropped=True)
                    continue
                except PoolSaturated:
                    queue.requeue_front(rq)
                    break
                if evicted_at >= 0:
                    rep.recovery_ms.append(1e3 * (clock() - evicted_at))
                    rq.t_evicted_s = -1.0
            # chunked prefill: one chunk per prefilling slot per iteration,
            # between decode steps, so a long prompt never stalls the batch
            for u in sorted(self._prefilling):
                self._prefill_step(u)
            if not self._by_slot:
                if self._prefilling:
                    continue
                nxt = queue.next_arrival()
                if nxt is None:
                    break
                wait = max(0.0, nxt - clock())
                sleeper = getattr(clock, "sleep", None)
                (sleeper or time.sleep)(wait)
                continue

            if inject_every and rep.tokens_out >= next_inject:
                self.corrupt_slot(inject_rng, armed_only=inject_armed_only)
                next_inject = rep.tokens_out + inject_every

            t0 = time.perf_counter()
            tokens, finite, report = self.engine_step()
            rep.decode_ms.append(1e3 * (time.perf_counter() - t0))
            rep.engine_steps += 1
            now = clock()
            if report is not None or any(not finite[u]
                                         for u in self._by_slot):
                self.handle_fault(report, finite, now, queue)
            # healthy lanes keep the fault step's own tokens
            self._accept(tokens, now)
        return rep
