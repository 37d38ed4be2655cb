"""Serving recovery policy — ``plan_serving_recovery`` of
``repro/core/recover.py``.

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

from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.detect import FaultReport, block_of_leaf


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
