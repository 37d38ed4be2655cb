"""Recovery — ``repro/core/recover.py``: the training runtime's ladder
(single device) and the serving recovery policy.

``RecoveryRuntime`` is the paper's §3.5 runtime for the training loop: it
does nothing until a ``FaultReport`` arrives, then walks the leaf's
recovery ladder, and every repair is verified before the loop resumes (a
rung that cannot certify an exact repair escalates — exact-or-abort):

    rung 0  triage        classify the injured leaf BEFORE any repair: the
                          digest pair locates a single flipped bit, and a
                          certified-harmless flip (dead bytes, or a
                          below-epsilon mantissa change of an EMA moment)
                          is TOLERATED: the digest rows are re-armed, the
                          state is untouched, 0 bytes moved, 0 steps
                          replayed
    rung 1  eq1 / opt_iv  induction-state partner recovery (Eq. (1)): the
                          ``iv`` counters and the optimizer's ``t``
                          (affine), ``bc1``/``bc2`` recomputed from the
                          consensus iteration
    rung 3  replica_vote  bitwise TMR vote across DP replicas
                          (``ops.vote3`` → the ``vote3_tiles`` kernel);
                          reached when the caller hands the runtime
                          ``replicas=`` — ``launch/train.py`` has none
    rung 4  parity_xor    XOR parity reconstruction of the injured block
                          (``core/parity.py``): no snapshot read, no
                          step replayed
    rung 5  replay        pure-step replay from a verified micro-snapshot
    remesh                a HARD loss (``FaultReport.lost_rows``: the ranks
                          of whole data rows are gone): the elastic
                          handler (``launch/elastic.ElasticManager.hook``)
                          rebuilds the dead rows' blocks from the row-safe
                          parity, certifies the survivors' and shrinks the
                          mesh; the ladder of such a report is [remesh,
                          checkpoint]
    rung 6  checkpoint    classic disk restore + replay

Under donation (``donated=True``: the loop's step writes the state in
place) the ladder is replay, then checkpoint; parity_xor goes ahead of
them only for a checksum or external report with live buffers
(``consumed=False``, the donated pair checks before the step), and triage
ahead of everything under the same condition.  Every repair is written
into the live tensors (``copy_``), never into new ones: the canary's pack
schedules and the fused step's captured graphs read their addresses.

On a mesh (``shardings=``: the state's ``LeafSharding`` tree; every rank
runs its own runtime over its own blocks) a report carrying (leaf, shard)
attribution tries rung 2 first:

    rung 2  shard_patch   restore ONLY the injured (leaf, shard) blocks
                          from the version-matched snapshot; healthy
                          blocks keep their storage, ``bytes_moved`` is
                          the injured blocks' bytes

The ranks climb the same ladder in lockstep: every rank-local verdict
(the snapshot's certification, a rung's post-repair check, a triage
certificate, a parity repair's digests) is all-reduced before any rank
acts on it, so no rank takes a rung alone (a rank that replayed alone
would hang the others in the step's collectives).  Every rung but
remesh runs on the mesh.  Triage there certifies per shard: the
report's shard ids name the injured block (replicas of one box count
once; more than one distinct block, or a flip in only some replicas of
one block, escalates: replicas left unequal would break the mesh step's
norm), each rank holding it digests its block where it lies (one
``checksum_tiles`` launch), solves the flip against its row of the
fault-time reference and maps the candidate words to leaf-flat indices
through its box.  ``parity_xor`` rebuilds the injured block from the
mesh parity (``core/parity.MeshParityPlan``) and places it on every
rank holding it.  During a hard-loss recovery the lockstep verdicts are
agreed over the survivors' group (the dead ranks take no part), and a
remesh leaves the runtime on the degraded context.

``plan_serving_recovery`` is the serving engine's policy:

* ``slots`` — evict ONLY the injured slots to prefix replay; healthy slots
  keep decoding the very next engine step.

  - checksum: the canary checks each unit against the digest armed ONE
    step earlier, so a mismatch proves the corruption arose in the single
    inter-step gap just crossed; the only corrupt-derived token is the
    detection step's own output, which the engine discards for evicted
    slots — retract 0.
  - nonfinite: the free trap fires only once the poison reaches the
    logits; retract the last K-1 accepted tokens (the at-rest window the
    rotating canary leaves unchecked) as the conservative bound.
* ``engine`` — no slot attribution: evict every active slot with the full
  log retracted (replay from the prompt).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.detect import (ChecksumCanary, FaultReport,
                                     block_of_leaf)
from repro_torch.core.induction import IVRegistry, RecoveryAbort
from repro_torch.core.microcheckpoint import MicroCheckpointer
from repro_torch.core.parity import ParityStore
from repro_torch.core.recovery_table import (
    RUNG_CHECKPOINT,
    RUNG_EQ1,
    RUNG_OPT_IV,
    RUNG_PARITY,
    RUNG_REMESH,
    RUNG_REPLAY,
    RUNG_REPLICA,
    RUNG_SHARD,
    RUNG_TRIAGE,
    RecoveryTable,
)
from repro_torch.core.replay import copy_into, replay
from repro_torch.kernels import digest as kdigest
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as _ref
# elements per int8-moment quantisation block: the pad tail of the last
# block is dead
from repro_torch.optim.optimizers import QBLOCK
from repro_torch.tree import flatten_with_path, leaf_key, leaves, \
    replace_leaves

#: triage epsilon certificate: a mantissa perturbation of an EMA moment is
#: tolerable when |new - old| <= max(REL_EPS * max(|old|, |new|), ABS_FLOOR)
#: — the induced relative error in the update direction is of the same
#: order, far below the optimizer's own stochastic noise floor.
TRIAGE_REL_EPS = 1e-5
TRIAGE_ABS_FLOOR = 1e-12



@dataclass
class RecoveryEvent:
    """Telemetry for one recovery."""
    step: int
    report: FaultReport
    rung: str = ""                 # rung that succeeded
    attempted: List[str] = field(default_factory=list)
    wall_seconds: float = 0.0
    steps_replayed: int = 0
    bytes_moved: int = 0           # bytes reconstructed (parity_xor rung)
    recovered: bool = False
    phase_seconds: Dict[str, float] = field(default_factory=dict)


class RecoveryFailed(RuntimeError):
    """Every rung exhausted — the job must fall back to cold restart."""


class RecoveryRuntime:
    """Off-hot-path recovery engine for a functional training loop.

    step_fn     : step(state, batch) -> (state, metrics), functional
    batch_fn    : batch_fn(step) -> batch on the state's device
    iv_registry : ``IVRegistry`` from ``core.icp.promote``
    micro       : ``MicroCheckpointer`` (host snapshots)
    parity      : optional ``ParityStore`` over the state's params and
                  optimizer leaves, kept current by the canary; enables
                  the parity_xor rung
    replicas    : optional ``step -> [≥2 healthy replica state trees]``
                  (pure-DP deployments); enables the replica_vote rung
    checkpoint  : optional ``() -> (state, step)`` — disk restore
    table       : optional ``RecoveryTable`` choosing each leaf's ladder
    canary      : optional ``ChecksumCanary`` over the same state — the
                  parity rung localises a finite flip against the
                  digests its fired check compared with, and certifies
                  every reconstruction against them before resume
    triage      : enable rung 0 (needs the canary): classify a checksum
                  report's injured leaves against the canary's reference
                  digest pair and tolerate certified-harmless flips in
                  place; other reports fall straight through
    donated     : the loop's step updates the state in place; the ladder
                  pivots to replay (see the module docstring) and every
                  repair is written into the live tensors
    reuse_state : the caller drops the faulty state it hands ``recover``:
                  the replay and checkpoint rungs write into its tensors
                  rather than allocating a third state version beside
                  the snapshot's and the step's (implied by ``donated``)
    shardings   : the mesh's ``LeafSharding`` tree of the state (this
                  rank's blocks); enables shard_patch and lockstep
    elastic     : optional hard-loss handler ``(state, report, step) ->
                  ElasticResume`` (``launch/elastic.ElasticManager.hook``:
                  core/ takes a callable and imports nothing of launch/);
                  enables the remesh rung
    """

    def __init__(self, *, step_fn, batch_fn, iv_registry: IVRegistry,
                 micro: MicroCheckpointer,
                 parity: Optional[ParityStore] = None,
                 replicas: Optional[Callable] = None,
                 checkpoint: Optional[Callable] = None,
                 table: Optional[RecoveryTable] = None,
                 canary: Optional[ChecksumCanary] = None,
                 triage: bool = False, donated: bool = False,
                 reuse_state: bool = False, shardings=None, elastic=None):
        self.shardings = shardings
        self.ctx = next(iter(leaves(shardings))).ctx if shardings else None
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ivs = iv_registry
        self.micro = micro
        self.parity = parity
        self.replicas = replicas
        self.checkpoint = checkpoint
        self.table = table
        self.canary = canary
        self.triage = triage
        self.donated = donated
        self.reuse_state = reuse_state or donated
        self.elastic = elastic
        #: the remesh rung's resume bundle (new context, state, step,
        #: batch function, canary, parity) for the loop to swap in
        self.pending_remesh = None
        #: the survivors' group while a hard loss is being recovered
        self._survivors = None
        self.events: List[RecoveryEvent] = []
        self._last_replayed = 0
        self._last_patched_bytes = 0

    # -- rungs: each returns (repaired state, detail) or raises
    #    RecoveryAbort; the ladder driver verifies and escalates ---------

    def _rung_triage(self, state, report: FaultReport, step: int):
        """Classify the injured leaves BEFORE any repair and tolerate
        certified-harmless flips in place (FlipTracker, arXiv:1809.01362).
        Single-event-upset model: the Fletcher pair the canary already
        holds locates one flipped bit, so triage names the (bit, word)
        and the implied pre-flip bits with no second copy of the data.

        Certificates (EVERY injured leaf must certify, else abort):

        * dead region — the flip landed on bytes the update never reads
          (an int8-quantised moment's pad tail; the absmax scale of an
          all-pad block);
        * below-epsilon moment perturbation — a mantissa-tail flip in a
          float EMA moment whose old and new values differ by at most
          ``TRIAGE_REL_EPS`` relative.

        Tolerate = re-arm the injured rows (``canary.refresh(keys=...)``
        patches BOTH generations, no bump) and resume with the state
        untouched: 0 bytes moved, 0 steps replayed.  Anything
        uncertifiable escalates; tolerate never ALTERS state, it only
        re-certifies it, so exact-or-abort holds."""
        if not self.triage:
            raise RecoveryAbort("triage disabled")
        if self.canary is None:
            raise RecoveryAbort("triage needs a canary digest reference")
        if report.detector != "checksum":
            raise RecoveryAbort(
                "only digest-attributed faults are classifiable")
        if report.consumed:
            raise RecoveryAbort(
                "faulting buffers overwritten by the step — nothing to "
                "classify in place")
        injured = list(report.leaves or ())
        if not injured:
            raise RecoveryAbort("no leaf attribution to classify")
        live = _by_key(state)
        notes = []
        for key in injured:
            leaf = live.get(key)
            if leaf is None:
                raise RecoveryAbort(f"injured leaf {key} not in state")
            cert = self._certify_on_mesh(state, key, leaf, report) \
                if self.ctx is not None else \
                self._certify_tolerable(state, key, leaf)
            notes.append(f"{key}: {cert}")
        # the rows still describe the pre-flip bits: without the re-arm
        # every later check would fire on the value we decided to keep
        self.canary.refresh(state, keys=injured)
        return state, "tolerated without repair — " + "; ".join(notes)

    def _certify_on_mesh(self, state, key: str, leaf: torch.Tensor,
                         report: FaultReport) -> str:
        """The certificate of one injured leaf on a mesh, the same
        verdict on every rank.  The report's shard ids (gathered once the
        flag fired, the same on every rank) must name ONE block and every
        replica of it; each rank holding the block certifies it
        (``_certify_tolerable`` on its block, the candidates mapped to
        leaf-flat indices through its box), and the verdicts are
        agreed."""
        sh = _by_key(self.shardings)[key]
        ids = sorted((report.shards or {}).get(key, ()))
        if not ids:
            raise RecoveryAbort(f"{key}: no shard attribution")
        spans = {sh.span(d) for d in ids}
        if len(spans) > 1:
            raise RecoveryAbort(
                f"{key}: {len(spans)} blocks mismatch — more than one "
                f"event, escalate")
        span = spans.pop()
        holders = [d for d in range(self.ctx.n_devices)
                   if sh.span(d) == span]
        if ids != holders:
            raise RecoveryAbort(
                f"{key}: shards {ids} of the replicas {holders} of one "
                f"block mismatch — replicas disagree, escalate")
        ok, note = True, f"block of shards {holders}"
        if self.ctx.shard_id in holders:
            try:
                note = self._certify_tolerable(state, key, leaf, sh)
            except RecoveryAbort as e:
                ok, note = False, str(e)
        if not self._agree(ok):
            raise RecoveryAbort(note if not ok else
                                f"{key}: refused on another rank")
        return note

    def _certify_tolerable(self, state, key: str, leaf: torch.Tensor,
                           sharding=None) -> str:
        """The certificate of one injured leaf (on a mesh, of this rank's
        block of it, ``sharding`` its ``LeafSharding``): its note, or
        RecoveryAbort.  A high bit leaves many candidate words (every
        2^(32-bit)-th), so the candidates are judged as arrays."""
        bit, js, cur, old = self._localise_flip(key, leaf, sharding)
        start = self._dead_from(state, key)
        live = js < start if start is not None \
            else np.ones(js.shape, dtype=bool)
        if not live.any():
            return (f"dead-region flip (bit {bit}, "
                    f"{js.size} candidate word(s), never read)")
        if not self._moment_leaf(key):
            raise RecoveryAbort(
                f"{key} is not an EMA moment — no tolerance certificate")
        js = js[live]
        new_v = _word_values(leaf.dtype, cur[live])
        old_v = _word_values(leaf.dtype, old[live])
        finite = np.isfinite(new_v) & np.isfinite(old_v)
        if not finite.all():
            raise RecoveryAbort(
                f"{key}: non-finite endpoint at word "
                f"{js[np.argmin(finite)]} — escalate")
        delta = np.abs(new_v - old_v)
        tol = np.maximum(TRIAGE_REL_EPS * np.maximum(np.abs(new_v),
                                                     np.abs(old_v)),
                         TRIAGE_ABS_FLOOR)
        over = delta > tol
        if over.any():
            i = int(np.argmax(over))
            raise RecoveryAbort(
                f"{key}: |Δ|={delta[i]:.3e} at word {js[i]} exceeds the "
                f"epsilon certificate ({tol[i]:.3e}) — escalate")
        return (f"sub-epsilon moment perturbation (bit {bit}, "
                f"|Δ|≤{delta.max():.3e})")

    def _localise_flip(self, key: str, leaf: torch.Tensor, sharding=None):
        """``(bit, flat_elements, cur_words, old_words)`` (uint32 arrays)
        for the single flip the digest pair implies, or RecoveryAbort when
        the evidence fits no single-bit flip.  The leaf's digest is taken
        where it lies (one ``checksum_tiles`` launch on the card) and only
        the candidate words cross to the host.  ``to_i32`` packs one word
        per element, so a word index is a flat element index.  On a mesh
        ``leaf`` is this rank's block, the reference its row, and the
        block-local candidates are mapped through ``sharding``'s box to
        leaf-flat indices (the reference's recover.py:326-350)."""
        ref = np.asarray(self.canary.fault_reference_digest(key))
        cur = _digest(leaf)
        if np.array_equal(cur, ref):
            raise RecoveryAbort(
                f"{key}: digest matches the reference — stale attribution")
        sol = kdigest.locate_single_flip(ref, cur, leaf.numel())
        if sol is None:
            raise RecoveryAbort(
                f"{key}: digest deltas inconsistent with a single-bit "
                f"flip — escalate")
        bit, delta, cand = sol
        js = np.asarray(cand, dtype=np.int64)
        at = torch.from_numpy(js).to(leaf.device)
        words = kdigest.fetch(
            _ref.to_i32(leaf.detach().reshape(-1)[at])).view(np.uint32)
        if sharding is not None:
            box = sharding.box(self.ctx.shard_id)
            starts = [0 if b.start is None else b.start for b in box]
            local = np.unravel_index(js, tuple(leaf.shape))
            js = np.ravel_multi_index(
                tuple(a + s0 for a, s0 in zip(local, starts)),
                sharding.shape).astype(np.int64)
        return bit, js, words, words - np.uint32(delta)

    @staticmethod
    def _moment_leaf(key: str) -> bool:
        """Float EMA-moment leaves — the only state the epsilon
        certificate applies to (params and counters always escalate)."""
        return key.startswith(("opt/m/", "opt/v/", "opt/stats/")) \
            and not key.endswith("/q")

    def _dead_from(self, state, key: str) -> Optional[int]:
        """The first dead flat element of ``key`` (every later one is dead
        too), or None when none is: bytes the optimizer update never
        reads and rewrites wholesale each step.  An int8-quantised
        moment's ``/q`` leaf is padded to ``QBLOCK`` past its param's
        size, and the absmax ``/scale`` of an all-pad block is dead."""
        base = None
        for pre in ("opt/m/", "opt/v/"):
            if key.startswith(pre):
                base = key[len(pre):]
                break
        if base is None:
            return None
        # on a mesh the param's global size (the rank holds a block)
        sizes = _by_key(self.shardings) if self.shardings else \
            _by_key(state)
        for suffix, per in (("/q", 1), ("/scale", QBLOCK)):
            if base.endswith(suffix):
                p = sizes.get("params/" + base[:-len(suffix)])
                if p is None:
                    return None
                n = math.prod(p.shape) if self.shardings else p.numel()
                return -(-n // per)
        return None

    def _dead_element(self, state, key: str, j: int) -> bool:
        """Is flat element ``j`` of ``key`` dead (``_dead_from``)?"""
        start = self._dead_from(state, key)
        return start is not None and j >= start

    def _rung_eq1(self, state, report: FaultReport, step: int):
        """Repair induction state from healthy partners (registered as
        both ``eq1`` and ``opt_iv``): one Eq. (1) majority diagnosis over
        every affine counter, then affine outliers are rewritten to their
        value at the consensus iteration n*, and derived entries whose
        bits differ from their recomputation at n* are rewritten.  Scalar
        work only: zero snapshot bytes, zero replayed steps."""
        live = {leaf_key(p): t for p, t in flatten_with_path(state)}
        names = [n for n in self.ivs.specs if n in live]
        if not names:
            raise RecoveryAbort("no registered induction leaves in state")
        # one transfer for every counter
        vals = dict(zip(names, torch.stack([live[n] for n in names])
                        .cpu().tolist()))
        n_star, bad = self.ivs.diagnose(vals)
        if n_star is None:
            raise RecoveryAbort("no consensus among induction variables")
        swap: Dict[str, torch.Tensor] = {}
        for name in bad:
            leaf = live[name]
            swap[name] = torch.tensor(self.ivs.specs[name].value_at(n_star),
                                      dtype=leaf.dtype, device=leaf.device)
        derived_bad: List[str] = []
        for name in self.ivs.derived:
            leaf = live.get(name)
            if leaf is None:
                continue
            want = self.ivs.derived_value(name, n_star, leaf.device) \
                .to(leaf.dtype)
            if not _same_bits(want, leaf):
                derived_bad.append(name)
                swap[name] = want
        if not swap:
            raise RecoveryAbort(
                "induction state consistent — fault is elsewhere")
        repaired = sorted(bad) + sorted(derived_bad)
        return replace_leaves(state, swap), (
            f"repaired {repaired} via Eq.(1) consensus n={n_star}"
            + (f" (derived recompute: {sorted(derived_bad)})"
               if derived_bad else ""))

    def _rung_replica(self, state, report: FaultReport, step: int):
        """Bitwise TMR vote across DP replicas of the corrupted leaves
        (every leaf when the report names none)."""
        if self.replicas is None:
            raise RecoveryAbort("no replicas maintained")
        reps = self.replicas(step)
        if reps is None or len(reps) < 2:
            raise RecoveryAbort("fewer than 2 healthy replicas")
        bad = set(report.leaves)
        b, c = ({leaf_key(p): t for p, t in flatten_with_path(r)}
                for r in reps[:2])
        voted = {}
        for path, a in flatten_with_path(state):
            k = leaf_key(path)
            if not bad or k in bad:
                voted[k] = kops.vote3(a, b[k], c[k])
        return replace_leaves(state, voted), \
            f"replica vote over {len(reps)} replicas"

    def _rung_parity(self, state, report: FaultReport, step: int):
        """Reconstruct the injured block of each covered injured leaf from
        the XOR parity: 0 snapshot bytes read, 0 steps replayed, one
        block's bytes reconstructed.  Gates (abort → escalate, never
        guess): a parity store and live faulting buffers (a ``consumed``
        report aborts); at least one injured leaf covered; exactly ONE
        injured block per leaf (single parity reconstructs one); checksum
        and external reports are digest-certified against the canary's
        fault-time reference before resume."""
        store = self.parity
        if store is None:
            raise RecoveryAbort("no parity maintained")
        if report.consumed:
            raise RecoveryAbort(
                "faulting version consumed by the detecting step — "
                "survivors are dead, replay instead")
        injured = list(report.shards or ()) or list(report.leaves or ())
        if not injured:
            # free traps carry no leaf attribution: name suspects by the
            # non-finite scan (the only evidence a trap leaves; on a mesh
            # every rank's suspects, so every rank names the same)
            injured = _default_verify(state)
            if self.ctx is not None:
                from repro_torch.distributed import collectives as coll
                injured = sorted(set().union(
                    *coll.gather_objects(injured, self._group())))
        covered = [k for k in injured if store.covers(k)]
        if not covered:
            raise RecoveryAbort("no injured leaf is parity-covered")
        # the table generation the fired check compared against — not the
        # current read table, which check_and_arm has already advanced
        refs = self.canary.fault_reference_digests() \
            if self.canary is not None else None
        certifiable = report.detector in ("checksum", "external")
        live = {leaf_key(p): t for p, t in flatten_with_path(state)}
        moved = 0
        repaired: Dict[str, torch.Tensor] = {}
        for key in covered:
            leaf = live.get(key)
            if leaf is None:
                raise RecoveryAbort(f"injured leaf {key} not in state")
            shards = self._locate_shards(leaf, key, report, refs)
            if not shards:
                raise RecoveryAbort(
                    f"cannot localise the injured shard of {key}")
            if len(shards) > 1:
                raise RecoveryAbort(
                    f"{len(shards)} injured shards of {key} — a single "
                    f"parity shard reconstructs exactly one")
            d = shards[0]
            if self.ctx is not None:
                # every rank folds its share; the block goes to every
                # rank holding it (all replicas), the others keep theirs
                block = store.reconstruct_shard(leaf, key, d)
                holders = store.plan.block_devices(key, d)
                moved += block.numel() * block.element_size() * len(holders)
                new_leaf = block if self.ctx.shard_id in holders else leaf
            else:
                new_leaf = store.reconstruct_leaf(leaf, key, d)
                moved += 4 * store.plan.block_sizes[key][d]
            if certifiable and refs is not None and key in refs:
                # on a mesh each rank's block against its row, agreed
                ok = np.array_equal(_digest(new_leaf), refs[key])
                if not self._agree(ok):
                    raise RecoveryAbort(
                        f"reconstruction of {key} shard {d} failed digest "
                        f"certification — escalating")
            if new_leaf is not leaf:
                repaired[key] = new_leaf
        self._last_patched_bytes = moved
        return replace_leaves(state, repaired), (
            f"parity reconstruction of {len(covered)} shard(s) of "
            f"{len(covered)} leaf/leaves ({moved} B, no snapshot, no "
            f"replay)")

    def _locate_shards(self, leaf: torch.Tensor, key: str,
                       report: FaultReport, refs) -> List[int]:
        """Which block(s) of ``leaf`` are injured, by evidence quality:

        1. the report's own (leaf, shard) attribution;
        2. trial reconstruction against the canary's whole-leaf reference
           digest: reconstruct each block in turn and keep the ones whose
           repaired leaf digests back to the reference.  A UNIQUE match is
           required: a false candidate mirrors the XOR delta into its own
           block at the same offset; when the mirrored word holds the
           opposite bit b, the two word deltas cancel in Fletcher's sum and
           shift its weighted term by ``2^b · block_len · (i - j)``, which
           is 0 mod 2^32 for high enough b (at full width from bit 12 of
           an FFN leaf, bit 17 of the embedding).  Both repairs are then
           parity-consistent too, so several matches abort (replay
           decides);
        3. last resort: a per-block non-finite scan."""
        plan = self.parity.plan
        ids = (report.shards or {}).get(key)
        if ids:
            return sorted({plan.device_block[key][int(i)] for i in ids})
        ref = refs.get(key) if refs else None
        if self.ctx is not None:
            # each rank's block against its own reference row (or, with
            # no canary, a non-finite scan of it), gathered
            from repro_torch.distributed import collectives as coll
            if ref is not None:
                bad = not np.array_equal(_digest(leaf), ref)
            else:
                bad = leaf.is_floating_point() and not bool(
                    kdigest.fetch(torch.isfinite(leaf).all()))
            return sorted({plan.device_block[key][d] for d, b in
                           enumerate(coll.gather_objects(
                               bad, self._group())) if b})
        if ref is not None:
            matches = [d for d in range(plan.n_blocks[key])
                       if np.array_equal(_digest(
                           self.parity.reconstruct_leaf(leaf, key, d)), ref)]
            if len(matches) == 1:
                return matches
            if len(matches) > 1:
                raise RecoveryAbort(
                    f"{len(matches)} candidate shards of {key} digest-"
                    f"certify (Fletcher collision of the XOR-mirrored "
                    f"repair) — ambiguous, escalating")
        if leaf.is_floating_point():
            c = plan.block_len[key]
            flat = torch.nn.functional.pad(
                leaf.reshape(-1), (0, plan.n_shards * c - leaf.numel()))
            bad = kdigest.fetch(
                ~torch.isfinite(flat.view(plan.n_shards, c)).all(dim=1))
            return [int(i) for i in np.nonzero(bad)[0]]
        return []

    def _into(self, state):
        """The tensors a replay writes into: the live state's, where the
        runtime may reuse them, else none (a new state)."""
        return state if self.reuse_state else None

    def _group(self):
        """The group of the lockstep verdicts: the mesh's, or during a
        hard-loss recovery the survivors'."""
        if self._survivors is not None:
            return self._survivors
        return self.ctx.group(self.ctx.axis_names)

    def _agree(self, ok: bool) -> bool:
        """``ok`` on every rank (the identity off the mesh): each rank-local
        verdict goes through here before any rank acts on it."""
        if self.ctx is None:
            return ok
        from repro_torch.distributed import collectives as coll
        return coll.agree(ok, self.ctx.device, self._group())

    def _rung_shard_patch(self, state, report: FaultReport, step: int):
        """Restore ONLY the injured (leaf, shard) blocks from the snapshot.

        Gates (abort → escalate, never guess): (leaf, shard) attribution
        (the sharded canary's); live, undonated buffers; a VERSION-MATCHED
        snapshot (``snap.step == step``: the canary certified the live
        blocks against digests of this state version, and an older
        snapshot would mix versions); and the injured units certified in
        the snapshot on every rank that holds one.  Each rank replaces its
        injured blocks with new tensors from its own snapshot; healthy
        blocks (and every block of a rank the fault missed) keep their
        storage.  ``bytes_moved`` counts the injured blocks' bytes over
        the mesh, as the reference's host→device bytes."""
        if self.ctx is None:
            raise RecoveryAbort("no mesh: shard_patch needs shardings")
        shards = dict(report.shards or {})
        if not shards:
            raise RecoveryAbort("no (leaf, shard) attribution")
        if self.donated:
            raise RecoveryAbort("donated buffers are dead — replay instead")
        if all(k.startswith("iv/") for k in shards):
            raise RecoveryAbort("IV block repairs via Eq.(1)")
        snap = self.micro.latest(before=step)
        if snap is None:
            raise RecoveryAbort("no snapshot available")
        if snap.step != step:
            raise RecoveryAbort(
                f"no version-matched snapshot (have step {snap.step}, "
                f"fault is against version {step})")
        rotten = self.micro.verify_shards(snap, shards)
        if not self._agree(not rotten):
            raise RecoveryAbort(f"snapshot shards failed verification: "
                                f"{rotten[:3] or 'on another rank'}")
        host = _by_key(snap.state)
        sh = _by_key(self.shardings)
        me = self.ctx.shard_id
        patched: Dict[str, torch.Tensor] = {}
        moved = units = 0
        for key, ids in shards.items():
            moved += sh[key].nbytes_local * len(ids)
            units += len(ids)
            if me in ids:
                patched[key] = host[key].to(self.ctx.device, copy=True)
        self._last_patched_bytes = moved
        return replace_leaves(state, patched), (
            f"patched {units} shard(s) of {len(shards)} leaf/leaves "
            f"({moved} B moved) from snapshot @{snap.step}")

    def _rung_replay(self, state, report: FaultReport, step: int):
        """Replay from the newest digest-verified snapshot ≤ step."""
        snap = self.micro.latest(before=step)
        if snap is None:
            raise RecoveryAbort("no snapshot available")
        rotten = self.micro.verify(snap)
        if not self._agree(not rotten):
            raise RecoveryAbort(f"snapshot failed verification: "
                                f"{rotten[:3] or 'on another rank'}")
        res = replay(self.step_fn, self.batch_fn, snap.state, snap.step, step,
                     like_state=state, into=self._into(state))
        self._last_replayed = res.steps_replayed
        return res.state, f"replayed {res.steps_replayed} steps from " \
                          f"{snap.step}"

    def _rung_checkpoint(self, state, report: FaultReport, step: int):
        """Classic restore (digest-verified at load) + replay to ``step``."""
        if self.checkpoint is None:
            raise RecoveryAbort("no checkpoint loader configured")
        if report.lost_rows and self.ctx is not None:
            raise RecoveryAbort(
                "ranks of the mesh are gone: a restore needs a mesh they "
                "are not part of (restart the job)")
        ck_state, ck_step = self.checkpoint()
        res = replay(self.step_fn, self.batch_fn, ck_state, ck_step, step,
                     like_state=state, into=self._into(state))
        self._last_replayed = res.steps_replayed
        return res.state, f"restored step {ck_step} + replayed to {step}"

    def _rung_remesh(self, state, report: FaultReport, step: int):
        """HARD loss: ranks are gone, not corrupt — shrink the mesh and go
        on training.  Delegates to the elastic handler (survivor-honest
        gather and certification, parity reconstruction of the dead rows'
        blocks, eviction of the dead mesh's caches, the re-bind on the
        degraded context) and moves the runtime onto the new context, so
        every later rung and replay runs there.  The whole resume bundle
        is left on ``pending_remesh`` for the loop."""
        if self.elastic is None:
            raise RecoveryAbort("no elastic handler attached")
        if not report.lost_rows:
            raise RecoveryAbort("report names no lost rows")
        resume = self.elastic(state, report, step)
        self.pending_remesh = resume
        self.step_fn = resume.step
        self.batch_fn = resume.bfn
        self.shardings = resume.shardings
        self.ctx = resume.ctx
        if resume.canary is not None:
            self.canary = resume.canary
        if resume.pstore is not None:
            self.parity = resume.pstore
        ev = resume.event
        self._last_patched_bytes = ev.bytes_reconstructed
        return resume.state, (
            f"remeshed dp {ev.old_dp}->{ev.new_dp} (rows {ev.lost_rows} "
            f"lost), {ev.blocks_reconstructed} blocks "
            f"({ev.bytes_reconstructed} B) parity-reconstructed, "
            f"{ev.certified_blocks} survivor blocks certified, "
            f"re-bound in {ev.relower_seconds:.2f}s")

    _RUNGS = {
        RUNG_TRIAGE: _rung_triage,
        RUNG_EQ1: _rung_eq1,
        RUNG_OPT_IV: _rung_eq1,     # same consensus engine, opt-IV ladder
        RUNG_SHARD: _rung_shard_patch,
        RUNG_REPLICA: _rung_replica,
        RUNG_PARITY: _rung_parity,
        RUNG_REPLAY: _rung_replay,
        RUNG_REMESH: _rung_remesh,
        RUNG_CHECKPOINT: _rung_checkpoint,
    }

    # -- ladder driver ---------------------------------------------------

    def recover(self, state, report: FaultReport, step: int,
                verify: Optional[Callable] = None,
                ladder: Optional[Sequence[str]] = None):
        """Walk the ladder; return (repaired_state, RecoveryEvent).

        ``verify(state) -> List[str]`` names still-corrupt leaves (empty =
        verified); default: a non-finite scan over float leaves."""
        report.resolve()
        ladder = list(ladder) if ladder is not None else self._ladder(report)
        verify = verify or _default_verify
        if report.lost_rows and self.ctx is not None:
            self._survivors = self.ctx.survivors(
                d for r in report.lost_rows
                for d in self.ctx.row_devices(r))[1]
        try:
            return self._climb(state, report, step, verify, ladder)
        finally:
            self._survivors = None

    def _climb(self, state, report: FaultReport, step: int, verify,
               ladder: Sequence[str]):
        ev = RecoveryEvent(step=step, report=report)
        t0 = time.perf_counter()
        for rung in ladder:
            fn = self._RUNGS.get(rung)
            if fn is None:
                continue
            ev.attempted.append(rung)
            self._last_replayed = 0
            self._last_patched_bytes = 0
            tr = time.perf_counter()
            try:
                cand, detail = fn(self, state, report, step)
            except RecoveryAbort as e:
                ev.phase_seconds[rung] = time.perf_counter() - tr
                ev.report.detail += f" | {rung}: {e}"
                # on a mesh the other ranks learn of it here
                self._agree(False)
                continue
            bad = verify(cand)
            ev.phase_seconds[rung] = time.perf_counter() - tr
            if not self._agree(not bad):
                # exact-or-abort: the repair did not certify (on some
                # rank) — every rank escalates
                ev.report.detail += f" | {rung}: post-verify failed " \
                                    f"{bad[:2] or 'on another rank'}"
                continue
            if self.donated and rung != RUNG_REMESH:
                # the live tensors keep their addresses (a remesh makes a
                # state of other shapes)
                cand = copy_into(state, cand)
            ev.rung = rung
            ev.recovered = True
            ev.steps_replayed = self._last_replayed
            ev.bytes_moved = self._last_patched_bytes
            ev.wall_seconds = time.perf_counter() - t0
            ev.report.detail += f" | {rung}: {detail}"
            self.events.append(ev)
            return cand, ev
        ev.wall_seconds = time.perf_counter() - t0
        self.events.append(ev)
        raise RecoveryFailed(str(report))

    def _ladder(self, report: FaultReport) -> List[str]:
        """The ladder: a hard loss's, the donated pivot, else the Recovery
        Table, else by leaf class; triage ahead when it applies."""
        if report.lost_rows:
            # the ranks themselves are gone: nothing to patch into, and
            # the snapshots lie on the dead mesh — remesh onto the
            # survivors; only the disk checkpoint sits below it
            return [RUNG_REMESH, RUNG_CHECKPOINT]
        if self.donated:
            # the step writes the state in place: only the donated pair's
            # reports (consumed=False, checked before the step) leave live
            # buffers for the in-place rungs
            ladder = [RUNG_REPLAY, RUNG_CHECKPOINT]
            if (self.parity is not None
                    and report.detector in ("checksum", "external")
                    and not report.consumed):
                ladder.insert(0, RUNG_PARITY)
            if self._triage_applies(report):
                ladder.insert(0, RUNG_TRIAGE)
            return ladder
        if self.table is not None and report.leaves:
            entry = self.table.lookup(report.leaves[0])
            if entry is not None:
                return list(entry.ladder)
        if report.leaves and all(k.startswith("iv/") for k in report.leaves):
            return [RUNG_EQ1, RUNG_REPLAY, RUNG_CHECKPOINT]
        if report.leaves and all(k in self.ivs.specs or k in self.ivs.derived
                                 for k in report.leaves):
            # optimizer-owned induction leaves (opt/t, bias corrections)
            return [RUNG_OPT_IV, RUNG_REPLAY, RUNG_CHECKPOINT]
        ladder = [RUNG_EQ1, RUNG_REPLICA, RUNG_PARITY, RUNG_REPLAY,
                  RUNG_CHECKPOINT]
        if report.shards and self.ctx is not None:
            # mesh attribution: the byte-minimal shard patch first; its
            # gates abort cleanly into the generic ladder
            ladder.insert(0, RUNG_SHARD)
        if self._triage_applies(report):
            ladder.insert(0, RUNG_TRIAGE)
        return ladder

    def _triage_applies(self, report: FaultReport) -> bool:
        """Rung 0's gate: enabled, a canary to certify against, digest
        attribution and live buffers to classify."""
        return (self.triage and self.canary is not None
                and report.detector == "checksum"
                and not report.consumed and bool(report.leaves))

    # -- telemetry -------------------------------------------------------

    def summary(self) -> Dict:
        n = len(self.events)
        rec = [e for e in self.events if e.recovered]
        by_rung: Dict[str, int] = {}
        ms_by_rung: Dict[str, List[float]] = {}
        for e in rec:
            by_rung[e.rung] = by_rung.get(e.rung, 0) + 1
            ms_by_rung.setdefault(e.rung, []).append(1e3 * e.wall_seconds)
        return {
            "events": n,
            "recovered": len(rec),
            "recovery_rate": len(rec) / n if n else 1.0,
            "by_rung": by_rung,
            "mean_wall_ms": 1e3 * float(np.mean([e.wall_seconds
                                                 for e in rec]))
            if rec else 0.0,
            "mean_steps_replayed": float(np.mean([e.steps_replayed
                                                  for e in rec]))
            if rec else 0.0,
            # a storm mixes rungs of very different cost (parity_xor vs
            # replay): the median wall time of each
            "p50_wall_ms_by_rung": {r: float(np.median(ms))
                                    for r, ms in ms_by_rung.items()},
            # each shard_patch: the (leaf, shard) units and the bytes moved
            "shard_patches": [{"shards": e.report.shards,
                               "bytes_moved": e.bytes_moved}
                              for e in rec if e.rung == RUNG_SHARD],
        }


def _digest(x: torch.Tensor) -> np.ndarray:
    """Whole-leaf Fletcher pair on the host (one ``checksum_tiles`` launch
    and one fetch on the card) — comparable with the canary's rows."""
    return kdigest.fetch(kops.checksum(x))


def _word_values(dtype: torch.dtype, words: np.ndarray) -> np.ndarray:
    """Decode packed ``to_i32`` words (uint32) back to the floats they
    encode, as float64 (the triage certificate compares old and new
    VALUES, not bits)."""
    words = np.asarray(words, dtype=np.uint32)
    if dtype.itemsize == 4:
        return words.view(np.float32).astype(np.float64)
    if dtype.itemsize == 2 and dtype.is_floating_point:
        bits = (words & 0xFFFF).astype(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(dtype).double().numpy()
    raise RecoveryAbort(f"no value decoding for dtype {dtype}")


def _by_key(tree) -> Dict[str, torch.Tensor]:
    return {leaf_key(p): t for p, t in flatten_with_path(tree)}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (a value compare would call -0.0 == 0.0)."""
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _default_verify(state) -> List[str]:
    """Non-finite scan over float leaves, one flag per leaf and ONE
    ``fetch``; names the corrupt leaves."""
    flat = [(leaf_key(p), t) for p, t in flatten_with_path(state)
            if t.is_floating_point()]
    if not flat:
        return []
    mask = kdigest.fetch(torch.stack([~torch.isfinite(t).all()
                                      for _, t in flat]))
    return sorted(k for (k, _), b in zip(flat, mask) if b)


# ---------------------------------------------------------------------------
# serving recovery policy
# ---------------------------------------------------------------------------

@dataclass
class ServingRecoveryPlan:
    """What the engine must do about one FaultReport."""
    scope: str                     # 'slots' | 'engine'
    slots: List[int]               # slots to evict (scope='slots')
    retract: Optional[int] = None  # suspect tokens to rescind; None = all
    reason: str = ""


def plan_serving_recovery(report: Optional[FaultReport], *, n_slices: int,
                          nonfinite_slots: Sequence[int] = ()
                          ) -> ServingRecoveryPlan:
    """Slot-scoped eviction vs whole-engine eviction for a serving fault.

    ``n_slices``       : the canary's K (0 = no canary: free traps only).
    ``nonfinite_slots``: active slots whose logits went non-finite.
    """
    slots = set(report.injured_slots()) if report is not None else set()
    slots.update(nonfinite_slots)
    if report is not None and report.detector == "checksum":
        retract = 0
    else:
        retract = max(0, n_slices - 1) if n_slices else None
    if slots:
        return ServingRecoveryPlan(
            scope="slots", slots=sorted(slots), retract=retract,
            reason=f"slot attribution "
                   f"({report.detector if report else 'nonfinite'})")
    if report is not None:
        leaves = report.resolve()
        if leaves and all(block_of_leaf(k) is not None for k in leaves):
            # every corrupted unit is a pool block nobody owns: nothing to
            # evict, the engine only re-certifies the blocks' digests
            return ServingRecoveryPlan(
                scope="slots", slots=[], retract=0,
                reason="checksum attribution to unowned pool blocks — "
                       "no live victim")
    return ServingRecoveryPlan(
        scope="engine", slots=[], retract=None,
        reason="no slot attribution — evict all active slots")
