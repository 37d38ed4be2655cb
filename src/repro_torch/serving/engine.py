"""Continuous-batching serving engine with slot-isolated recovery — the
paged path of ``repro/serving/engine.py``.

* **Paged, in-place state.**  The engine owns S batch slots over a shared
  KV block pool (``serving/paged.py``), a per-slot block table, position
  vector, activity mask and last-token vector.  Every update is in place,
  so the storage of the pool and of ``pos`` never moves: the canary's
  views of them, and the pointers the pack kernel holds, stay valid for
  the engine's life.
* **One engine step** (``engine_step``) advances every lane one token:
  ``gather_blocks`` materialises each slot's blocks, one batched decode
  runs on the gathered view (the reference vmapped a B=1 decode; lanes are
  computationally independent either way), the new rows scatter back, and
  the rotating canary checks slice ``s % K`` and arms slice ``(s+1) % K``.
  The reference did all of that in one jitted launch, with XLA reading the
  check slice from the INPUT pool and arming from the OUTPUT pool.  The
  port orders it by hand: ``pack_rows`` of the check slice before any pool
  write; gather, decode, scatter; ``pack_rows`` of the arm slice; ONE
  ``row_checksums`` over the packing buffer and the combine; the on-device
  compare and arm; ONE scalar ``fetch`` of the fault flag.  The token
  payload that follows is the data plane, as in the reference.
* **Canary units** are (leaf, block) pairs plus one ``pos`` unit per slot;
  block → owning slot is a host allocator lookup, so a flip on a free
  block evicts nobody.
* **Slot-isolated recovery.**  On a fault ``plan_serving_recovery``
  evicts only the injured slots; they re-enter the queue front and are
  rebuilt by prefix replay (prefill + forced decode over the token log).
  Healthy slots keep the fault step's own tokens and keep decoding.
* **At-rest parity over the params** (``parity=True``).  Serving never
  writes the params, so one XOR parity build at construction and the
  digests recorded beside it let ``scrub_params`` detect and repair a
  silently flipped weight with no reload.

Not ported yet (ROADMAP.md, queue 1): the dense per-slot cache, chunked
prefill and mesh serving.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.detect import (ChecksumCanary, FaultReport,
                                     block_leaf_prefix, block_of_leaf,
                                     slot_leaf_prefix)
from repro_torch.core.faults import bit_width, flip_bit
from repro_torch.core.parity import ParityStore
from repro_torch.core.recover import plan_serving_recovery
from repro_torch.kernels import _build
from repro_torch.kernels import digest as kdigest
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import get_model
from repro_torch.serving import paged as pgd
from repro_torch.serving.paged import (AdmissionError, BlockAllocator,
                                       PoolSaturated)
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.tree import flatten_with_path, leaf_key, replace_leaves


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


class ServingEngine:
    """Iteration-level scheduler + paged batched decoder + block canary.

    Parameters
    ----------
    cfg           : full config (``cfg.model`` drives the model)
    n_slots       : batch slots S
    max_len       : per-slot capacity in positions (rounded up to a
                    multiple of ``block_size``)
    canary_slices : rotating canary K; 0 disables the canary
    seed          : params init seed (ignored when ``params`` is given)
    max_replays   : fault evictions a request survives before it is dropped
    block_size    : KV-pool block size in positions
    pool_blocks   : pool blocks incl. scratch block 0 (0 = every slot can
                    hold a max-size request)
    device        : torch device; None = the CUDA card, raising if none
    params        : ready params (same tree as ``init_lm``), e.g. bridged
                    from the reference; None = the port's seeded init
    parity        : keep an XOR parity over the params (``scrub_params``)
    """

    def __init__(self, cfg, *, n_slots: int = 4, max_len: int = 64,
                 canary_slices: int = 4, seed: int = 0,
                 max_replays: int = 8, verbose: bool = False,
                 block_size: int = 8, pool_blocks: int = 0, device=None,
                 params=None, parity: bool = False):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 projections as in the reference: no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.m = cfg.model
        self.model = get_model(self.m)
        self.S = int(n_slots)
        self.K = int(canary_slices)
        self.max_replays = int(max_replays)
        self.verbose = verbose
        self.block_size = bs = int(block_size)
        self.max_len = -(-int(max_len) // bs) * bs
        self.max_blocks = self.max_len // bs
        self.n_blocks = int(pool_blocks) or (1 + self.S * self.max_blocks)
        if self.n_blocks < 2:
            raise ValueError("pool_blocks must be >= 2")
        dev = self.device
        self.params = (params if params is not None
                       else self.model.init(self.m, seed, dev))

        # at-rest parity over the STATIC params: one build here and the
        # healthy digests recorded beside it (one fetch) let
        # ``scrub_params`` detect and repair at-rest corruption
        self.parity_store: Optional[ParityStore] = None
        self._param_refs: Optional[Dict[str, np.ndarray]] = None
        if parity:
            self.parity_store = ParityStore(self.params)
            self.parity_store.build(self.params)
            plan = self.parity_store.plan
            leaves = plan.leaves(self.params)
            table = kdigest.fetch(torch.stack([kops.checksum(x)
                                               for x in leaves]))
            self._param_refs = dict(zip(plan.keys, table))

        per_slot = self.model.make_decode_cache(self.m, 1, self.max_len, dev)
        self.pool = pgd.make_block_pool(per_slot, self.n_blocks, bs)
        self.bt = torch.zeros((self.S, self.max_blocks), dtype=torch.int32,
                              device=dev)
        self.pos = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self.amask = torch.zeros((self.S,), dtype=torch.bool, device=dev)
        self.tok = torch.zeros((self.S,), dtype=torch.int32, device=dev)
        self._bt_np = np.zeros((self.S, self.max_blocks), np.int32)
        self.alloc = BlockAllocator(self.n_blocks)
        self._fmask0 = torch.zeros((self.S,), dtype=torch.bool, device=dev)
        self._ftok0 = torch.zeros((self.S,), dtype=torch.int32, device=dev)

        self.canary: Optional[ChecksumCanary] = None
        self.plan = None
        self._block_keys: List[Tuple[str, ...]] = []
        self._pos_keys: List[str] = []
        self._view_leaves: List[torch.Tensor] = []
        self._cores: Dict[int, kdigest.CheckArm] = {}
        if self.K:
            view = self._view()
            self.canary = ChecksumCanary(view, n_slices=self.K)
            self.plan = self.canary.plan
            self._block_keys = [
                tuple(k for k in self.plan.keys
                      if k.startswith(block_leaf_prefix(b) + "/"))
                for b in range(self.n_blocks)]
            self._pos_keys = [f"{slot_leaf_prefix(u)}/pos"
                              for u in range(self.S)]
            # views aliasing the pool / pos storage: valid for the
            # engine's life because every state update is in place
            self._view_leaves = self.plan.leaves(view)

        self.slot_rid: List[Optional[int]] = [None] * self.S
        self._by_slot: Dict[int, Request] = {}
        self.step_count = 0
        self.report = ServingReport(n_slots=self.S)

    # -- plumbing -----------------------------------------------------------

    def _view(self):
        """Canary view of the paged state: (leaf, block) + per-slot pos."""
        return pgd.paged_canary_view(self.pool, self.pos, self.n_blocks,
                                     self.S)

    def _refresh_blocks(self, blocks) -> None:
        """Re-certify the given pool blocks' canary rows after an
        out-of-step pool write (both generations, no generation bump)."""
        if self.canary is None or not blocks:
            return
        view = self._view()
        for b in sorted(blocks):
            self.canary.refresh(view, keys=self._block_keys[b])

    def _rotation(self, r: int):
        """The check+arm core of rotation ``r``."""
        core = self._cores.get(r)
        if core is None:
            can = self.canary
            core, _ = kdigest.check_arm_subcomputation(
                self.plan, can._slice_indices(r), can._slice_indices(r + 1))
            self._cores[r] = core
        return core

    def warm(self) -> float:
        """Build the kernels (on the card) and every rotation's packing
        buffer and layout up front; returns wall seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.lib()
        for r in range(self.K):
            self.plan.take_buffer(self._rotation(r).union)
        return time.perf_counter() - t0

    # -- hot path -----------------------------------------------------------

    def _forced_arrays(self):
        forced = [(u, rq.forced[0]) for u, rq in self._by_slot.items()
                  if rq.forced]
        if not forced:
            return self._fmask0, self._ftok0
        fm = np.zeros((self.S,), bool)
        ft = np.zeros((self.S,), np.int32)
        for u, t in forced:
            fm[u] = True
            ft[u] = t
        return (torch.from_numpy(fm).to(self.device),
                torch.from_numpy(ft).to(self.device))

    def _decode(self, fmask, ftok):
        """Gather, batched decode, in-place scatter-back and position
        advance.  Returns (next tokens (S,), finite (S,)) on the device."""
        gcache = pgd.gathered_cache(self.pool, self.bt, self.pos)
        logits, ngc = self.model.decode_step(self.params, self.m, gcache,
                                             self.tok)
        pgd.scatter_token(self.pool, ngc["groups"], self.bt, self.pos,
                          self.amask, self.block_size)
        self.pos.add_(self.amask.to(torch.int32))
        nxt = torch.where(fmask, ftok, logits.argmax(-1).to(torch.int32))
        self.tok.copy_(nxt)
        return nxt, torch.isfinite(logits).all(dim=-1)

    def engine_step(self) -> Tuple[np.ndarray, np.ndarray,
                                   Optional[FaultReport]]:
        """Advance every lane one token: one logical launch (counted in
        ``kdigest.STATS``) + ONE scalar fault sync + the token payload.

        Returns ``(tokens (S,), finite (S,) bool, report|None)``."""
        s = self.step_count
        fmask, ftok = self._forced_arrays()
        kdigest.STATS.launches += 1
        report = None
        if self.canary is None:
            nxt, finite = self._decode(fmask, ftok)
        else:
            core = self._rotation(s % self.K)
            buf = self.plan.take_buffer(core.union)
            leaves = self._view_leaves
            core.pack_check(buf, [leaves[i] for i in core.chk])  # pre-write
            nxt, finite = self._decode(fmask, ftok)
            core.pack_arm(buf, [leaves[i] for i in core.arm])    # post-write
            ref_read, ref_write = self.canary.begin_update()
            flag, bad = core.finish(buf, ref_read, ref_write)
            self.canary.commit_update(ref_write)
            if bool(kdigest.fetch(flag)):     # the step's ONE fault sync
                report = FaultReport(
                    s, "checksum", detail="paged block canary",
                    resolver=self._paged_resolver(core.chk, bad))
        self.step_count += 1
        pl = torch.stack([nxt, finite.to(torch.int32)], dim=1).cpu().numpy()
        return pl[:, 0], pl[:, 1].astype(bool), report

    def _paged_resolver(self, chk, bad):
        """Attribution closure: (leaf, block) keys of blocks a request owned
        AT DETECTION TIME become ``slotNNN/blockNNNN/...`` keys; unowned
        blocks keep their raw keys (nobody to evict)."""
        can = self.canary
        owner = dict(self.alloc.owner)

        def xlat(k):
            b = block_of_leaf(k)
            o = owner.get(b) if b is not None else None
            return k if o is None else f"{slot_leaf_prefix(o)}/{k}"
        return lambda: sorted(xlat(k) for k in can._attribute(chk, bad))

    # -- scheduler: admission / acceptance / eviction ------------------------

    def free_slots(self) -> List[int]:
        return [u for u in range(self.S) if self.slot_rid[u] is None]

    def check_admissible(self, rq: Request) -> None:
        """Typed rejection of a request whose worst-case block budget can
        never fit."""
        nb = pgd.blocks_needed(len(rq.prompt), rq.max_new_tokens,
                               self.block_size)
        need = len(rq.prompt) + 1 + rq.max_new_tokens
        if nb > self.max_blocks:
            raise AdmissionError(
                f"rid={rq.rid}: needs {nb} blocks ({need} positions), "
                f"per-slot budget is {self.max_blocks} blocks "
                f"({self.max_len} positions)")
        if nb > self.alloc.capacity:
            raise AdmissionError(
                f"rid={rq.rid}: needs {nb} blocks, whole pool holds "
                f"{self.alloc.capacity}")

    def admit(self, rq: Request, slot: int, now_s: float = 0.0) -> None:
        """Reserve the request's block budget (may raise ``PoolSaturated``),
        zero and wire its blocks, prefill the prompt into them, re-certify
        their canary rows and activate the lane."""
        self.check_admissible(rq)
        nb = pgd.blocks_needed(len(rq.prompt), rq.max_new_tokens,
                               self.block_size)
        bids = self.alloc.allocate(slot, nb)
        pgd.zero_blocks(self.pool, torch.tensor(bids, device=self.device))
        self._bt_np[slot] = 0
        self._bt_np[slot, :nb] = bids
        self.bt.copy_(torch.from_numpy(self._bt_np))
        self.slot_rid[slot] = rq.rid
        rq.slot = slot
        rq.state = "active"
        if rq.t_admit_s < 0:
            rq.t_admit_s = now_s
        self.report.admissions += 1
        if self.verbose:
            kind = "replay" if rq.log else "admit"
            print(f"[engine] {kind} rid={rq.rid} -> slot {slot} "
                  f"({nb} blocks {bids})")
        P = len(rq.prompt)
        tokens = torch.from_numpy(
            np.asarray(rq.prompt, np.int32)[None]).to(self.device)
        logits, sub = self.model.prefill(self.params, self.m,
                                         {"tokens": tokens})
        pgd.scatter_span(self.pool, sub["groups"], self.bt[slot], 0, P,
                         self.block_size)
        # zeroing and the span scatter are out-of-step writes
        self._refresh_blocks(bids)
        self._activate(rq, slot, P, logits)

    def _activate(self, rq: Request, slot: int, P: int, logits) -> None:
        """Install the first decode input and flip the lane active."""
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
            self.canary.refresh(self._view(), keys=[self._pos_keys[slot]])
        self._by_slot[slot] = rq

    def _free(self, slot: int) -> None:
        self.slot_rid[slot] = None
        self._by_slot.pop(slot, None)
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
        """Slot-isolated recovery: evict injured slots to prefix replay.
        Returns the evicted slot ids."""
        rep = self.report
        rep.faults_detected += 1
        nf = [u for u in self._by_slot if not finite[u]]
        plan = plan_serving_recovery(report, n_slices=self.K,
                                     nonfinite_slots=nf)
        victims = (sorted(self._by_slot) if plan.scope == "engine"
                   else plan.slots)
        # snapshot BEFORE the frees below return blocks to the pool: the
        # injured and victim-owned blocks keep their bytes until the next
        # zero-on-alloc, and their units must not fire again meanwhile
        refresh_blocks: set = set()
        if report is not None:
            refresh_blocks |= set(report.injured_blocks())
        for u in victims:
            refresh_blocks |= set(self.alloc.owned(u))
        any_dropped = False
        for u in victims:
            rq = self._by_slot.get(u)
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
        if plan.scope == "slots" and not victims and report is not None:
            # attribution landed only on unowned pool blocks
            rep.faults_on_free_slots += 1
        if self.canary is not None:
            self._refresh_blocks(refresh_blocks)
            for u in victims:
                self.canary.refresh(self._view(), keys=[self._pos_keys[u]])
        if not any_dropped:
            rep.faults_recovered += 1
        return victims

    # -- fault injection (evaluation adversary) ------------------------------

    def _owned_unit_keys(self, u: int) -> List[str]:
        """Canary keys a slot owns: its blocks' units plus its pos unit."""
        keys = [k for b in self.alloc.owned(u) for k in self._block_keys[b]]
        keys.append(self._pos_keys[u])
        return keys

    def corrupt_slot(self, rng, slot: Optional[int] = None,
                     key: Optional[str] = None, bit: Optional[int] = None,
                     armed_only: bool = False) -> Tuple[int, str, int]:
        """Flip one bit of one element of one canary unit, in place.

        A slot target is the set of units the slot owns (its blocks plus
        its ``pos``).  ``armed_only`` restricts the pick to units armed for
        the NEXT step's check (the protected at-rest window), so every
        flip is detected; otherwise the pick is uniform over the owned
        units, a raw-coverage measurement.  ``key`` names a plan key
        (``blockNNNN/...`` or ``slotNNN/pos``) directly — even an unowned
        block.  Returns (owning slot | -1, plan key, bit)."""
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
                picks = list(self._pos_keys)
            key = picks[rng.randrange(len(picks))]
        if key in self._pos_keys:
            u = self._pos_keys.index(key)
            b = bit if bit is not None else rng.randrange(32)
            flip_bit(self.pos, u, b)
        else:
            blk = block_of_leaf(key)
            if blk is None:
                raise KeyError(key)
            rest = key.split("/", 1)[1]
            leaf = next((x for p, x in flatten_with_path(self.pool)
                         if leaf_key(p) == rest), None)
            if leaf is None:
                raise KeyError(key)
            per = leaf[0].numel()
            e = rng.randrange(per)
            b = bit if bit is not None else rng.randrange(32)
            flip_bit(leaf, blk * per + e, b)
            u = self.alloc.owner.get(blk, -1)
        self.report.faults_injected += 1
        rid = self.slot_rid[u] if 0 <= u < self.S else None
        if rid is not None:
            self.report.injured_rids.add(rid)
        return u, key, b

    def corrupt_param(self, rng, key: Optional[str] = None,
                      bit: Optional[int] = None) -> Tuple[str, int]:
        """Flip one bit of one element of a parity-covered param leaf —
        the at-rest weight-rot adversary ``scrub_params`` exists for.  The
        flip goes into a copy of the leaf that replaces it in this
        engine's params tree, so another engine built over the same
        params is untouched.  Returns (leaf key, bit)."""
        if self.parity_store is None:
            raise ValueError("corrupt_param requires parity=True")
        plan = self.parity_store.plan
        if key is None:
            key = plan.keys[rng.randrange(len(plan.keys))]
        leaf = dict(zip(plan.keys, plan.leaves(self.params)))[key]
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
        are installed, so later decode steps use healthy weights.  Returns
        the scrub stats with the parity's ``memory_bytes``."""
        if self.parity_store is None:
            raise ValueError("scrub_params requires parity=True")
        new_params, stats = self.parity_store.scrub(self.params,
                                                    self._param_refs)
        if stats["repaired"]:
            self.params = new_params
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
        the engine clock (seconds; default: wall time since this call)."""
        queue = RequestQueue(requests)
        rep = self.report
        rep.requests += len(requests)
        t_start = time.perf_counter()
        clock = clock or (lambda: time.perf_counter() - t_start)
        next_inject = rep.tokens_out + inject_every
        while True:
            while True:
                free = self.free_slots()
                if not free:
                    break
                rq = queue.pop_ready(clock())
                if rq is None:
                    break
                evicted_at = rq.t_evicted_s
                try:
                    self.admit(rq, free[0], now_s=clock())
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
            if not self._by_slot:
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
