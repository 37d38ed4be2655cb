"""Independent Compute Promotion (ICP) — the paper's Algorithm 1, applied to
training-loop state.  A copy of ``repro/core/icp.py``.

The paper's compiler pass promotes *derived* induction values (``i + 1``
inside an unrolled body) into *independent* induction variables with their
own PHI/update, because only independent copies can recover each other.

The training-loop analogue: counters like ``tokens_seen`` or
``data_offset`` are naturally *derived* (``step * global_batch``) — a
corruption of ``step`` corrupts every derived value computed from it.  ICP
here rewrites a derived-counter specification into independent state that
advances by its own literal increment each iteration (see
``train/loop.py:advance_iv``), and registers the (init, step) pair with the
IVRegistry so Eq. (1) applies.

``promote`` is the framework's ICP entry point: given the loop description
(global batch, microbatch count), it returns the registry of independent
IVs — the moral equivalent of running Algorithm 1 over the loop body.

Registry keys are FULL train-state leaf paths (``iv/step``, ``opt/t``, …)
so the recovery runtime can match a ``FaultReport``'s injured leaves against
the registry directly.  Two fragments are merged:

* the loop's own counters under ``iv/`` (``derived_counters`` +
  ``optim.schedules.induction_specs`` for the schedule position);
* the optimizer-owned induction state under ``opt/`` — the step counter
  ``t`` as an affine IV, and bias-correction / decay factors as *derived*
  entries recomputable from the consensus iteration (an ICP-exposed side
  effect: because the affine counters are independent, the consensus n is
  always available to recompute any pure function of it in place).
"""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.induction import IVRegistry
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import \
    induction_specs as schedule_induction_specs


def derived_counters(global_batch: int, n_micro: int) -> Dict[str, Tuple[int, int]]:
    """The affine family each counter belongs to: name -> (init, step).

    Before ICP these would be *expressions* over ``step``; after ICP each is
    independent loop state with the same affine semantics.
    """
    counters = {
        "step": (0, 1),
        "data_offset": (0, global_batch),
        "rng_counter": (0, 1),
        "micro_count": (0, max(n_micro, 1)),
    }
    counters.update(schedule_induction_specs())
    return counters


def optimizer_iv_specs(arch_cfg):
    """(affine, derived) optimizer-state induction specs, keyed by full
    ``opt/…`` leaf path — exported by the optimizer that owns the state."""
    opt = make_optimizer(arch_cfg.train)
    affine = {f"opt/{name}": spec for name, spec in opt.affine_ivs.items()}
    derived = {f"opt/{name}": fn for name, fn in opt.derived_ivs.items()}
    return affine, derived


def promote(arch_cfg, global_batch: int) -> IVRegistry:
    """ICP: emit the independent-IV registry for this training loop,
    covering both the ``iv/`` counter block and the optimizer's own
    induction state (keys are full train-state leaf paths)."""
    n_micro = max(arch_cfg.train.microbatch, 1)
    specs = {f"iv/{name}": spec
             for name, spec in derived_counters(global_batch, n_micro).items()}
    opt_affine, opt_derived = optimizer_iv_specs(arch_cfg)
    specs.update(opt_affine)
    return IVRegistry(specs, derived=opt_derived)


def recoverable_iv_count(arch_cfg, global_batch: int,
                         icp_enabled: bool = True) -> int:
    """How many IVs are recoverable — the Table-6 metric.

    Without ICP only ``step`` exists as true loop state (everything else is
    derived from it), so a corruption of the one counter has *no partner* to
    recover from: 0 recoverable.  With ICP every promoted counter has ≥1
    independent partner, and every derived optimizer entry is recomputable
    from the consensus: all are recoverable.
    """
    reg = promote(arch_cfg, global_batch)
    return len(reg.specs) + len(reg.derived) if icp_enabled else 0
