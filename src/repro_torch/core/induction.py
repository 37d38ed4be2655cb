"""Induction-variable registry and Eq. (1) partner recovery — a copy of
``repro/core/induction.py`` (numpy only); derived entries are recomputed
on the device the caller names.

The paper (§3.2): for induction variables i, k updated as ``i += s_i``,
``k += s_k`` in the same loop, a corrupted i is recovered from k via

    i = (k - k0) / s_k * s_i + i0                                   Eq. (1)

Here the "loop" is the training loop and the IVs are the counters in
``TrainState['iv']`` (step, data_offset, rng_counter, sched_pos,
micro_count) — kept *independent* by ICP (see ``core/icp.py``) precisely so
this recovery is possible.

Beyond the paper's pairwise recovery we implement *majority diagnosis*: each
IV implies an iteration index n_x = (x - x0)/s_x; with ≥3 registered IVs the
modal n identifies every corrupted counter at once (the paper's exact-or-
abort rule falls out naturally: no modal majority -> abort to next rung).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class IVSpec:
    name: str
    init: int
    step: int  # per-iteration increment (loop-invariant, may be any int != 0)

    def value_at(self, n: int) -> int:
        return self.init + n * self.step

    def iteration_of(self, value: int) -> Optional[int]:
        """Implied iteration index, or None if value is inconsistent with
        this IV's affine family (non-divisible residue)."""
        delta = int(value) - self.init
        if self.step == 0:
            return None
        n, r = divmod(delta, self.step)
        return int(n) if r == 0 else None


class IVRegistry:
    """The Recovery-Table fragment for induction variables.

    Two entry classes:

    * **affine** (``specs``): counters following ``x(n) = init + n*step`` —
      the Eq. (1) family.  These vote in ``diagnose`` and repair each other.
    * **derived** (``derived``): values that are not affine in n but are a
      pure function of it (bias-correction factors ``1 - beta^n``,
      Adafactor's decay ``1 - n^-0.8``, …).  They carry no vote — a flip in
      one is repaired by recomputing ``derived[name](n*)`` from the affine
      consensus iteration.
    """

    def __init__(self, specs: Dict[str, Tuple[int, int]],
                 derived: Optional[Dict[str, Callable]] = None):
        """specs: name -> (init, step); derived: name -> fn(n, device)."""
        self.specs: Dict[str, IVSpec] = {
            name: IVSpec(name, int(init), int(step))
            for name, (init, step) in specs.items()
        }
        self.derived: Dict[str, Callable] = dict(derived or {})
        if not self.specs:
            raise ValueError("empty IV registry")
        overlap = set(self.specs) & set(self.derived)
        if overlap:
            raise ValueError(f"IV names both affine and derived: {overlap}")

    # -- Eq. (1): pairwise recovery ----------------------------------------

    def eq1(self, target: str, partner: str, partner_value: int) -> int:
        """Recover ``target``'s value from a healthy ``partner`` value.

        Exact-or-abort: a partner whose value has a non-zero residue mod its
        step is NOT on its affine family — it is itself corrupted, and
        "repairing" from it would manufacture a silently wrong value.
        """
        ps = self.specs[partner]
        ts = self.specs[target]
        if ps.step == 0:
            raise RecoveryAbort(f"partner {partner} has zero step")
        n, r = divmod(int(partner_value) - ps.init, ps.step)
        if r != 0:
            raise RecoveryAbort(
                f"partner {partner}={int(partner_value)} is off its affine "
                f"family (residue {r} mod step {ps.step}) — refusing Eq.(1)")
        return ts.init + n * ts.step

    # -- derived entries -----------------------------------------------------

    def is_derived(self, name: str) -> bool:
        return name in self.derived

    def derived_value(self, name: str, n: int, device="cpu"):
        """Recompute a derived entry at consensus iteration ``n`` on
        ``device`` — the exact expression the optimizer update writes at
        state version n (on the device the state lives on: the card's f32
        ``pow`` may differ from the CPU's in the last place)."""
        return self.derived[name](int(n), device)

    # -- majority diagnosis --------------------------------------------------

    def implied_iterations(self, values: Dict[str, int]) -> Dict[str, Optional[int]]:
        return {name: self.specs[name].iteration_of(values[name])
                for name in self.specs if name in values}

    def diagnose(self, values: Dict[str, int]) -> Tuple[Optional[int], List[str]]:
        """Returns (consensus iteration n or None, corrupted IV names).

        Majority vote over implied iteration indices.  A strict majority of
        registered IVs must agree, else (None, all names) — the
        exact-or-abort escalation signal.
        """
        implied = self.implied_iterations(values)
        votes = Counter(n for n in implied.values() if n is not None)
        if not votes:
            return None, sorted(implied)
        n_star, count = votes.most_common(1)[0]
        if count * 2 <= len(implied):
            return None, sorted(implied)
        bad = [name for name, n in implied.items() if n != n_star]
        return n_star, sorted(bad)

    def recover(self, values: Dict[str, int]) -> Tuple[Dict[str, int], List[str]]:
        """Repair all corrupted IVs from the consensus iteration.

        Returns (repaired values, names repaired).  Raises RecoveryAbort if
        no consensus exists (the abort-instead-of-SDC rule).
        """
        n_star, bad = self.diagnose(values)
        if n_star is None:
            raise RecoveryAbort("no consensus among induction variables")
        fixed = dict(values)
        for name in bad:
            fixed[name] = self.specs[name].value_at(n_star)
        return fixed, bad


class RecoveryAbort(RuntimeError):
    """Raised when a recovery rung cannot certify an exact repair —
    the runtime escalates to the next rung instead of risking an SDC."""
