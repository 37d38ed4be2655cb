"""Fault-tolerant training driver of the port — counterpart of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch iterpro-100m \\
        --ckpt-dir /tmp/ckpt --inject 5
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 10 --batch 2 --seq 32 --inject 4 --canary-slices 1

It runs on the CUDA card unless ``--device`` names another device, and
raises when there is no card and no device is named.  Hot path per step,
in order:

    1. the train step                                  — the work
    2. one transfer of (loss, grad_norm); the free traps on them
    3. ``canary.check_and_arm(s, state, new_state)``   — slice s%K of the
       pre-step state checked, slice (s+1)%K of the new state armed: one
       ``row_checksums`` launch, one scalar fetch
    4. micro-checkpoint bookkeeping (an IV log every step, a host snapshot
       every ``snapshot_interval`` steps) and the async disk checkpoint

``--donate`` runs the in-place step (one state version, not two).  Step 3
then becomes the donated pair around it: ``arm_current`` at the top of the
loop body (one launch, no sync) and ``check`` just before the step (one
launch, one fetch), and recovery pivots to snapshot + replay written into
the live tensors.  ``--fused-detect`` makes steps 1-3 one unit per canary
rotation (``core/fused_step.py``): on the card one captured CUDA graph, so
a steady step is one graph replay and one fetch of the flag with the loss
and grad norm beside it; ``--fused-warm eager`` captures the 2K graphs
before the first step, ``lazy`` each on first use.  ``--triage`` puts
rung 0 ahead of the ladder: a certified-harmless flip is tolerated with
zero bytes moved and zero steps replayed.

With ``--parity`` the canary also keeps an XOR parity of the params and
optimizer state current inside step 3 (one ``xor_update_tiles`` launch,
gated on the check's flag; the donated pair rebuilds it at its arm), and
the ``parity_xor`` rung can rebuild an injured block in place with no
snapshot and no replay.

On a ``FaultReport`` the step's output is discarded and the recovery
ladder repairs the pre-step state; the step is then retried.

On the card the driver turns TF32 off (f32 parity with the reference) and
PyTorch's deterministic algorithms on (with ``CUBLAS_WORKSPACE_CONFIG``):
the embedding and tied-logits backward would otherwise accumulate with
atomics in a varying order, and a replayed step would not reproduce the
clean trajectory bit for bit.

``--arch`` takes every dense configuration (``iterpro-100m``,
``h2o-danube-1.8b``, ``gemma3-1b``, ``gemma3-27b``, ``command-r-35b``),
the MoE ones (``grok-1-314b``, ``kimi-k2-1t-a32b``, trained with their
Adafactor and bf16 stats), the xLSTM ``xlstm-350m``, the hybrid
``zamba2-7b``, the enc-dec ``seamless-m4t-large-v2``, whose batches
carry 64 source frames, and the VLM ``qwen2-vl-7b``, whose batches carry
16 patches and their m-rope positions (``batch_for``) (``--smoke
--device cpu`` on the CPU); without
``--smoke`` a config's ``microbatch`` (8 for all but gemma3-1b,
iterpro-100m and xlstm-350m) accumulates the gradients of that many
slices of the batch in its bf16 ``grad_reduce_dtype``, as the reference
does.  Every
optimizer of the reference runs: AdamW with f32, bf16 or int8 moments
(``TrainPlan(moment_dtype=...)``; the reference has no flag for it
either) and Adafactor.

``--mesh dp,tp`` (e.g. ``4,2``) runs the resilient loop on a device mesh:
one process per mesh device (``launch/mesh.spawn``; on a one-card machine
the ranks share the card over gloo), every rank holding only its own
blocks of the state (``launch/specs.bind_state``).  For every family
the model axis computes tensor-parallel (the rank's heads, FFN columns,
experts, recurrent projections and vocabulary rows from its blocks in
place; ``distributed/tensor_parallel.py``); only a mesh with no model
axis wider than 1 gathers the params whole for each step.  No flag
chooses between the two.  The canary goes
shard-local (each rank digests its own blocks; the one fetched flag is
all-reduced), snapshots carry per-(leaf, shard) metadata, and recovery
gains the shard_patch rung (restore only the injured blocks) ahead of the
generic ladder, every rank climbing it in lockstep.  Rank 0's summary is
returned (and printed by ``main``), with ``"mesh": {"shape": ...,
"devices": n}``.  ``--mesh 4,2 --device cpu`` spawns 8 gloo ranks on the
CPU.  Every mode composes on the mesh: ``--donate`` (the donated mesh
step writes each rank's blocks in place, guarded by the sharded canary's
donated pair), ``--fused-detect`` (each rank's check, step and arm as
one unit; on the card the device stretches between the step's
collectives are captured graphs, ``core/fused_step.py``), ``--triage``
(rung 0 with per-shard certificates) and ``--parity`` (the mesh parity:
each rank holds its row, kept current through one all-to-all and one
XOR kernel a step; the ``parity_xor`` rung rebuilds an injured block on
every rank holding it).

``--elastic`` (with ``--mesh`` and ``--parity``) arms the hard-loss path
(``launch/elastic.py``): the parity takes the row-safe placement (its rows
replicated over the data axis, so a lost data row never takes the parity
covering its own blocks), and a report with ``lost_rows`` takes the
``remesh`` rung: the survivors rebuild the dead rows' blocks from their
blocks and the parity, certify theirs against their own digest rows,
shrink the mesh along ``data`` and go on with the same global batch (the
new context's state, step, batch function, canary, parity, snapshots —
the first of the resumed state — and, with ``--fused-detect``,
re-captured graphs swapped in).
``--kill-row-at N`` is the drill: before step N the highest surviving
data row dies — its ranks drop their state and return at once, and take
no part in any collective but the launcher's exit barrier; the call
returns the summary of the first survivor, with ``elastic_events`` and
the mesh's new shape.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.detect import (LOSS_WINDOW, ChecksumCanary,
                                     FaultReport,
                                     trap_loss_spike, trap_nonfinite)
from repro_torch.core.faults import inject, sample_plan
from repro_torch.core.icp import promote
from repro_torch.core.microcheckpoint import MicroCheckpointer
from repro_torch.core.parity import ParityStore
from repro_torch.core.recover import RecoveryFailed, RecoveryRuntime
from repro_torch.core.recovery_table import RecoveryTable
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.sharding import gather_tree, global_struct
from repro_torch.kernels import digest as kdigest
from repro_torch.launch.mesh import (in_group, make_context, parse_mesh,
                                     rank_device, spawn)
from repro_torch.launch.specs import bind_state
from repro_torch.serving.engine import resolve_device
from repro_torch.train.loop import make_train_state, make_train_step
from repro_torch.tree import leaves, tree_map

SRC_LEN = 64        # source frames of an enc-dec batch (the reference's)
N_PATCHES = 16      # patches of a VLM batch (the reference's)


@dataclass
class LoopReport:
    steps: int = 0
    faults_injected: int = 0
    faults_detected: int = 0
    faults_recovered: int = 0
    losses: List[float] = field(default_factory=list)
    recovery_ms: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    #: the distinct (launches, fetches) of the digest subsystem over the
    #: steps taken
    digest_stats: set = field(default_factory=set)
    elastic_events: List[Dict] = field(default_factory=list)

    def summary(self) -> Dict:
        step_ms = 1e3 * np.asarray(self.step_seconds, np.float64)
        rec_ms = np.asarray(self.recovery_ms, np.float64)
        return {
            "steps": self.steps,
            "final_loss": self.losses[-1] if self.losses else None,
            "faults_injected": self.faults_injected,
            "faults_detected": self.faults_detected,
            "faults_recovered": self.faults_recovered,
            "mean_recovery_ms": float(rec_ms.mean()) if rec_ms.size else 0.0,
            "p50_recovery_ms": float(np.median(rec_ms)) if rec_ms.size
            else 0.0,
            "mean_step_ms": float(step_ms.mean()) if step_ms.size else 0.0,
            "p50_step_ms": float(np.median(step_ms)) if step_ms.size
            else 0.0,
            "digest_per_step": sorted(list(x) for x in self.digest_stats),
            **({"elastic_events": list(self.elastic_events)}
               if self.elastic_events else {}),
        }


@contextlib.contextmanager
def cuda_numerics(device: torch.device):
    """On the card: TF32 off, deterministic algorithms on (restored on
    exit).  A no-op elsewhere."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.are_deterministic_algorithms_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    # every output the port allocates is written in full: NaN-filling
    # torch.empty would only add launches
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.use_deterministic_algorithms(saved[2])
        torch.utils.deterministic.fill_uninitialized_memory = saved[3]


def batch_for(cfg, pipe, step: int) -> Dict[str, torch.Tensor]:
    """The step's batch on the host: tokens and targets, for an enc-dec
    config 64 source frames of ``src_embeds``, for a VLM 16
    ``patch_embeds`` and their ``positions`` (the reference's
    ``batch_for``), so a replayed step sees the same batch."""
    batch = pipe.batch_at(step)
    m = cfg.model
    if m.n_enc_layers:
        batch = pipe.with_src_embeds(batch, SRC_LEN, m.frontend_dim, step)
    if m.patch_dim:
        batch = pipe.with_patches(batch, N_PATCHES, m.patch_dim, step)
    return batch


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          seed: int = 0, snapshot_interval: int = 8,
          checkpoint_dir: Optional[str] = None, checkpoint_interval: int = 50,
          inject_every: int = 0, inject_target: str = "params",
          inject_armed_only: bool = False,
          canary_slices: int = 4, detectors: bool = True,
          donate: bool = False, fused_detect: bool = False,
          fused_warm: str = "eager", mesh: Optional[str] = None,
          parity: bool = False, triage: bool = False, elastic: bool = False,
          kill_row_at: Optional[int] = None, verbose: bool = True,
          device=None, return_state: bool = False, on_kill=None,
          _final: Optional[dict] = None):
    """Run the recovery-wrapped loop; returns the loop report dict (and
    the final state with ``return_state``: on a mesh, called from a rank,
    that rank's blocks; called off the mesh, the whole state on the
    host).  ``seed`` seeds the params
    init, the data and the injection storm.  ``inject_armed_only`` flips
    only leaves of the canary slice checked at the flip's step (as the
    serving engine's ``inject_armed_only``), so under a K-slice canary
    every storm flip is detected.  ``detectors=False`` runs
    without the traps and the canary (then ``parity``, ``triage`` and
    ``fused_detect`` raise, as in the reference).  ``elastic`` needs
    ``mesh`` and ``parity``, ``kill_row_at`` needs ``elastic``.
    ``on_kill(ctx, state, shardings, rows)``, the drill's hook, runs on
    every rank at the kill point, before any rank learns of the loss
    (an oracle reads the doomed blocks there; nothing of the recovery
    does); a callable it returns runs on each survivor with ``(ctx,
    state, shardings)`` of the resumed run, right after the remesh.
    ``_final``: a dict that receives the final shardings (the spawned
    rank's gather)."""
    if elastic and not mesh:
        raise ValueError("elastic requires mesh='dp,tp' (a hard loss "
                         "shrinks the data axis of a device mesh)")
    if elastic and not parity:
        raise ValueError("elastic requires parity=True (dead rows' "
                         "shards are rebuilt from the XOR parity)")
    if kill_row_at is not None and not elastic:
        raise ValueError("kill_row_at requires elastic=True")
    ctx = None
    if mesh:
        if not in_group():
            # one rank per mesh device; rank 0's result is the call's
            kw = dict(steps=steps, global_batch=global_batch,
                      seq_len=seq_len, seed=seed,
                      snapshot_interval=snapshot_interval,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_interval=checkpoint_interval,
                      inject_every=inject_every, inject_target=inject_target,
                      inject_armed_only=inject_armed_only,
                      canary_slices=canary_slices, detectors=detectors,
                      donate=donate, fused_detect=fused_detect,
                      fused_warm=fused_warm, parity=parity, triage=triage,
                      elastic=elastic, kill_row_at=kill_row_at,
                      mesh=mesh, verbose=verbose, device=device,
                      return_state=return_state, on_kill=on_kill)
            dev = resolve_device(device)
            ranks = spawn(_rank_train, parse_mesh(mesh)[0], (cfg, kw),
                          device=dev.type)
            # the first survivor's (a rank of a lost row has no run)
            return next(r for r in ranks if not (
                r[0] if return_state else r).get("dead"))
        device = rank_device(dist.get_rank(), resolve_device(device).type)
        ctx = make_context(mesh, device, fsdp=cfg.sharding.fsdp)
        verbose = verbose and ctx.shard_id == 0
    device = resolve_device(device)
    with cuda_numerics(device):
        return _train(cfg, steps=steps, global_batch=global_batch,
                      seq_len=seq_len, seed=seed,
                      snapshot_interval=snapshot_interval,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_interval=checkpoint_interval,
                      inject_every=inject_every, inject_target=inject_target,
                      inject_armed_only=inject_armed_only,
                      canary_slices=canary_slices, detectors=detectors,
                      donate=donate, fused_detect=fused_detect,
                      fused_warm=fused_warm, parity=parity, triage=triage,
                      elastic=elastic, kill_row_at=kill_row_at,
                      on_kill=on_kill, verbose=verbose, device=device,
                      return_state=return_state, ctx=ctx, final=_final)


def _train(cfg, *, steps, global_batch, seq_len, seed, snapshot_interval,
           checkpoint_dir, checkpoint_interval, inject_every, inject_target,
           inject_armed_only,
           canary_slices, detectors, donate, fused_detect, fused_warm,
           parity, triage, elastic, kill_row_at, on_kill, verbose, device,
           return_state, ctx=None, final=None):
    pipe = TokenPipeline(cfg.model.vocab_size, seq_len, global_batch,
                         seed=seed)
    state = make_train_state(cfg, seed, global_batch=global_batch,
                             device=device)
    step_fn = make_train_step(cfg, global_batch=global_batch, donate=donate)

    def global_batch_at(s):
        return batch_for(cfg, pipe, s)

    def bfn(s):
        return {k: v.to(device) for k, v in batch_for(cfg, pipe, s).items()}

    def host_batch(s):
        """The step's batch on the host (the fused step uploads it into
        its graphs' static inputs); on a mesh this rank's rows."""
        batch = batch_for(cfg, pipe, s)
        if batch_sh is None:
            return batch
        return tree_map(lambda t, sh: sh.local(t), batch, batch_sh)

    # a flip is sampled over the global shapes: on a mesh those of
    # ``sampled`` (meta tensors), else the live state's
    shardings = table = sampled = batch_sh = None
    if ctx is not None:
        # every rank built the same full state: keep this rank's blocks
        bound = bind_state(ctx, cfg, state, step_fn, global_batch_at)
        state, step_fn, bfn, shardings = bound
        batch_sh = bound.batch_shardings
        sampled = global_struct(shardings)
        ivs = promote(cfg, global_batch)
        # the reference's ladder on the mesh: triage ahead of shard_patch,
        # parity_xor ahead of replay (RecoveryRuntime._ladder)
        table = RecoveryTable.build(
            state, sharded=True, triage=triage, parity=parity,
            opt_ivs=tuple(k for k in (*ivs.specs, *ivs.derived)
                          if k.startswith("opt/")))
    micro = MicroCheckpointer(interval=snapshot_interval, ctx=ctx,
                              shardings=shardings)
    ckpt = CheckpointManager(checkpoint_dir, interval=checkpoint_interval,
                             ctx=ctx, shardings=shardings) \
        if checkpoint_dir else None
    canary = ChecksumCanary(state, n_slices=canary_slices, ctx=ctx) \
        if detectors else None
    pstore = None
    if parity:
        if canary is None:
            raise ValueError("parity requires detectors=True (parity "
                             "maintenance rides the canary's launches and "
                             "reconstruction certifies against its digests)")
        # maintenance rides the canary; reconstruction certifies against
        # the canary's digests.  Under elastic the row-safe placement: a
        # dead data row never takes the parity of its own blocks
        pstore = ParityStore(state, ctx=ctx, shardings=shardings,
                             row_safe=elastic)
        pstore.build(state)
        canary.attach_parity(pstore)
    if triage and canary is None:
        raise ValueError("triage requires detectors=True (rung 0 "
                         "classifies against the canary's digest pair)")
    emgr = None
    if elastic:
        from repro_torch.launch.elastic import ElasticManager
        emgr = ElasticManager(ctx, verbose=verbose)

    def elastic_hook():
        return emgr.hook(raw_step=step_fn, cfg=cfg, batch_fn=global_batch_at,
                         canary=canary, pstore=pstore,
                         shardings=shardings) if emgr is not None else None
    runtime = RecoveryRuntime(
        step_fn=step_fn, batch_fn=bfn,
        iv_registry=promote(cfg, global_batch), micro=micro,
        parity=pstore, checkpoint=ckpt.loader(state) if ckpt else None,
        canary=canary, triage=triage, donated=donate,
        shardings=shardings, table=table, elastic=elastic_hook(),
        # the faulty state is replaced by the repaired one: a replay
        # writes into its tensors, two state versions on the card
        reuse_state=True)
    fused = None
    if fused_detect and canary is None:
        raise ValueError("fused_detect requires detectors=True "
                         "(the canary IS the in-step detector)")

    def fuse(state, s):
        """The fused unit on the current canary and step, its graphs
        captured (``eager``) for step ``s``'s batch; ``(unit, state in
        its storage)``."""
        # the batch goes in from the host: the factory uploads it into
        # the graphs' static inputs
        unit = canary.fuse_into_step(step_fn, donate=donate,
                                     warm=fused_warm,
                                     host_metrics=("loss", "grad_norm"))
        if fused_warm == "eager":
            unit.warm(state, host_batch(s))
        return unit, unit.load(state)
    if fused_detect:
        fused, state = fuse(state, 0)
    pair = donate and canary is not None and fused is None
    # a donated loop keeps every tensor of its state, recoveries included
    pointers = [t.data_ptr() for t in leaves(state)] if donate else None

    rng = random.Random(seed + 7)
    rep = LoopReport()
    n_snapshots, snapshot_seconds = 0, 0.0
    history = deque(maxlen=LOSS_WINDOW)   # the spike trap's window
    last_inject = -1
    on_resume = None

    s = 0
    while s < steps:
        stats0 = kdigest.STATS.snapshot()
        if pair:
            # donated pair, arm half: slice s%K of the state the previous
            # step produced (one launch, no sync)
            canary.arm_current(s, state)
        micro.record_iv(s, state["iv"])
        t0 = time.perf_counter()
        if micro.maybe_snapshot(s, state):
            n_snapshots += 1
            snapshot_seconds += time.perf_counter() - t0
        if ckpt:
            ckpt.maybe_save(s, state)

        # adversary: one bit flip before the step (evaluation only; once
        # per step — a recovery retry must not be hit again)
        if inject_every and s and s % inject_every == 0 and last_inject != s:
            only = None
            if inject_armed_only and canary is not None:
                only = {canary._keys[i] for i in canary._slice_indices(s)}
            inject(state, sample_plan(rng, state if sampled is None
                                      else sampled, max_step=1,
                                      target=inject_target, only=only),
                   shardings=shardings)
            rep.faults_injected += 1
            last_inject = s

        report = None
        if emgr is not None and s == kill_row_at and not emgr.dead:
            # the drill: the highest surviving data row dies here.  Its
            # ranks drop their state and leave; the survivors take an
            # external hard-loss report straight to the remesh rung
            rows = (emgr.kill_target(),)
            if on_kill is not None:
                on_resume = on_kill(ctx, state, shardings, rows)
            if ctx.coords(ctx.shard_id)[ctx.data_axis] in rows:
                if fused is not None:
                    fused.close()
                del state, fused
                out = rep.summary()
                out.update(dead=True, mesh={"shape": ctx.shape,
                                            "devices": ctx.n_devices})
                return (out, None) if return_state else out
            report = FaultReport(
                s, "external", lost_rows=rows,
                detail=f"simulated hard loss of data row {rows[0]}")
        # donated pair, check half: the step is about to overwrite the
        # state, so this is its last readable moment (one launch, one
        # fetch)
        if report is None and pair:
            report = canary.check(s, state)
        if report is None:
            t0 = time.perf_counter()
            if fused is not None:
                # check of slice s%K, the step and the arm of slice
                # (s+1)%K as one unit: one graph replay and one fetch
                new_state, metrics, report = fused.step(
                    s, state, host_batch(s))
                loss, grad_norm = metrics["loss"], metrics["grad_norm"]
            else:
                new_state, metrics = step_fn(state, bfn(s))
                loss, grad_norm = torch.stack(
                    [metrics["loss"], metrics["grad_norm"]]).tolist()
            rep.step_seconds.append(time.perf_counter() - t0)

            host = {"loss": loss, "grad_norm": grad_norm}
            if detectors and report is None:
                report = trap_nonfinite(s, host) or \
                    trap_loss_spike(s, host, history)
                if report is None and not donate and fused is None:
                    # slice s%K of the pre-step state (armed last step)
                    # and slice (s+1)%K of the fresh output: 1 launch + 1
                    # sync
                    report = canary.check_and_arm(s, state, new_state)

            if report is None:
                state = new_state
                history.append(loss)
                rep.losses.append(loss)
                if verbose and s % max(1, steps // 10) == 0:
                    print(f"[train] step {s:5d} loss {loss:.4f}")
                rep.digest_stats.add(tuple(b - a for a, b in zip(
                    stats0, kdigest.STATS.snapshot())))
                s += 1
                rep.steps += 1
                continue
            del new_state                   # corrupt-derived

        # ---------------- recovery path (off the hot path) --------------
        rep.faults_detected += 1
        # a fused report defers its leaf attribution to the fault path
        report.resolve()
        if verbose:
            print(f"[train] FAULT at step {s}: {report}")
        if fused is not None:
            # a replay steps eagerly: its temporaries may need the room
            # the graphs' pool holds (grok-1-314b at one card's width)
            fused.make_room()
        try:
            t0 = time.perf_counter()
            state, ev = runtime.recover(state, report, s)
            rep.faults_recovered += 1
            rep.recovery_ms.append(1e3 * (time.perf_counter() - t0))
            if verbose:
                print(f"[train] recovered via {ev.rung} in "
                      f"{rep.recovery_ms[-1]:.1f} ms")
        except RecoveryFailed:
            if ckpt is None or report.lost_rows:
                raise
            state, s = ckpt.restore(state)
            if verbose:
                print(f"[train] cold restore to step {s}")
        resume = runtime.pending_remesh
        if resume is not None:
            # a hard loss: the remesh rung rebuilt everything on the
            # degraded context — swap the loop's working set wholesale;
            # the canary and parity come freshly armed
            runtime.pending_remesh = None
            ctx, state, step_fn = resume.ctx, resume.state, resume.step
            bfn, shardings = resume.bfn, resume.shardings
            batch_sh, sampled = resume.batch_shardings, \
                global_struct(resume.shardings)
            canary, pstore = resume.canary, resume.pstore
            micro = runtime.micro = MicroCheckpointer(
                interval=snapshot_interval, ctx=ctx, shardings=shardings)
            if ckpt:
                # shard 0 of the degraded mesh writes
                ckpt.ctx, ckpt.shardings = ctx, shardings
                runtime.checkpoint = ckpt.loader(state)
            # a second loss composes (the manager is on the new context)
            runtime.elastic = elastic_hook()
            ev = resume.event
            if fused is not None:
                # the old unit went with the old mesh's caches
                t0 = time.perf_counter()
                fused, state = fuse(state, s)
                dt = time.perf_counter() - t0
                ev.relower_seconds += dt
                ev.downtime_seconds += dt
            if pointers is not None:
                pointers = [t.data_ptr() for t in leaves(state)]
            if s % snapshot_interval:
                # the old snapshots lay on the dead mesh: without one of
                # the resumed (certified) state a fault before the next
                # interval could not replay (the loop's top takes it at
                # an interval step)
                micro.snapshot(s, state)
            if on_resume is not None:
                on_resume(ctx, state, shardings)
            verbose = verbose and ctx.shard_id == 0
            rep.elastic_events.append(ev.to_dict())
            continue
        # a repaired, replayed or restored state is the new reference:
        # stale digests would fire a spurious fault on the next step
        if canary is not None:
            canary.refresh(state)
        if pstore is not None:
            pstore.rebuild(state, s)
        if fused is not None:
            # into the graphs' storage, without re-capturing
            state = fused.load(state)

    if ckpt:
        ckpt.wait()
    out = rep.summary()
    out["recovery"] = runtime.summary()
    out["snapshots"] = {"count": n_snapshots, "seconds": snapshot_seconds}
    if ckpt:
        out["checkpoints"] = {"count": ckpt.saves,
                              "blocking_seconds": ckpt.save_seconds_blocking,
                              "write_seconds": ckpt.write_seconds}
    if fused is not None:
        out["fused"] = {"captures" if device.type == "cuda" else "builds":
                        fused.n_compiles,
                        "seconds": fused.compile_seconds}
        if device.type == "cuda":
            out["fused"]["pool_bytes"] = fused.pool_bytes()
    if pointers is not None:
        out["pointers_kept"] = pointers == [t.data_ptr()
                                            for t in leaves(state)]
    if ctx is not None:
        out["mesh"] = {"shape": ctx.shape, "devices": ctx.n_devices}
    if elastic:
        out["losses"] = list(rep.losses)
    if final is not None:
        final["shardings"] = shardings
    return (out, state) if return_state else out


def _rank_train(cfg, kw):
    """One spawned rank of ``train(mesh=...)`` called off the mesh; a
    state it returns is the whole state, gathered from every (surviving)
    rank's blocks, on the host."""
    if not kw.get("return_state"):
        return train(cfg, **kw)
    final = {}
    out, state = train(cfg, **kw, _final=final)
    if state is None:                       # a rank of a lost row
        return out, None
    return out, tree_map(lambda t: t.cpu(),
                         gather_tree(state, final["shardings"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="iterpro-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params init, the data and the storm")
    ap.add_argument("--inject", type=int, default=0,
                    help="inject a bit flip every N steps")
    ap.add_argument("--inject-target", default="params",
                    choices=["params", "opt", "iv"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--snapshot-interval", type=int, default=8)
    ap.add_argument("--canary-slices", type=int, default=4,
                    help="canary rotation period K (1 = digest the whole "
                         "state every step)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--parity", action="store_true",
                    help="XOR parity over the params and optimizer state, "
                         "kept current by the canary; enables the "
                         "parity_xor rung (repair in place, no replay)")
    ap.add_argument("--donate", action="store_true",
                    help="in-place train step (one state version), "
                         "guarded by the donated canary pair; recovery "
                         "pivots to snapshot + replay into the live state")
    ap.add_argument("--fused-detect", action="store_true",
                    help="canary check, step and arm as one unit per "
                         "rotation: one captured CUDA graph on the card "
                         "(1 replay + 1 fetch per step)")
    ap.add_argument("--fused-warm", default="eager",
                    choices=["eager", "lazy"],
                    help="capture the fused step's graphs before the first "
                         "step (eager) or each on first use (lazy)")
    ap.add_argument("--triage", action="store_true",
                    help="recovery rung 0: tolerate certified-harmless "
                         "flips (dead bytes, sub-epsilon moment "
                         "perturbations) in place, zero bytes moved")
    ap.add_argument("--elastic", action="store_true",
                    help="arm the hard-loss remesh path (needs --mesh and "
                         "--parity): row-safe parity placement, and a "
                         "lost_rows report shrinks the data axis, rebuilds "
                         "the dead rows' blocks from the parity and resumes "
                         "with the same global batch")
    ap.add_argument("--mesh", default=None,
                    help="dp,tp (e.g. 4,2): one process per mesh device, "
                         "the state sharded over them, shard-local "
                         "detection and the shard_patch rung")
    ap.add_argument("--kill-row-at", type=int, default=None,
                    metavar="STEP",
                    help="drill: the highest surviving data row dies just "
                         "before STEP (needs --elastic)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    out = train(cfg, steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, seed=args.seed,
                snapshot_interval=args.snapshot_interval,
                checkpoint_dir=args.ckpt_dir, inject_every=args.inject,
                inject_target=args.inject_target,
                canary_slices=args.canary_slices, donate=args.donate,
                fused_detect=args.fused_detect, fused_warm=args.fused_warm,
                mesh=args.mesh,
                parity=args.parity, triage=args.triage,
                elastic=args.elastic, kill_row_at=args.kill_row_at,
                device=args.device)
    print(json.dumps(out, indent=1) if args.json else out)
    return out


if __name__ == "__main__":
    main()
