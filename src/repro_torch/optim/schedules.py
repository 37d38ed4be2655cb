"""LR schedules as pure functions of a step tensor — counterpart of
``repro/optim/schedules.py``.

The schedule position is one of the IterPro induction variables: it is
kept as independent state (``iv/sched_pos``) rather than re-derived from
``step``, so a corrupted schedule position is recoverable from any partner
IV via Eq. (1).  The schedule reads it on the device, as the reference's
traced step did: the learning rate is a 0-dim f32 tensor beside the state.
"""

from __future__ import annotations

import math

import torch


def induction_specs(start_step: int = 0):
    """Affine induction spec of the state the schedule owns: the schedule
    position advances +1 per outer step from ``start_step`` (mounted at
    ``iv/sched_pos`` by ``core/icp.promote``)."""
    return {"sched_pos": (int(start_step), 1)}


def warmup_cosine(peak_lr: float, warmup_steps: int,
                  total_steps: int = 100_000, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor·peak``;
    the reference's f32 expression, evaluated on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr
