"""Pure-step replay — the RSI (Recoverable Sequence of Instructions)
rung; counterpart of ``repro/core/replay.py``.

The whole step is pure, ``state_t = step(state_{t-1}, batch(t-1))`` with
``batch(t) = f(seed, t)``, so from any verified snapshot at ``t0 <= t``
the exact state at ``t`` is recomputed by replaying ``t - t0``
deterministic steps — bit-exact on the same device (on the card the
training entry point turns on PyTorch's deterministic algorithms, so the
embedding and logits backward do not accumulate with atomics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.tree import tree_map


@dataclass
class ReplayResult:
    state: object
    steps_replayed: int
    from_step: int
    to_step: int


def device_put_like(host_state, like_state=None, device=None):
    """Copy a host snapshot onto the device of ``like_state``'s leaves
    (or ``device``) — always a copy, so the snapshot never aliases live
    state that is later written in place."""
    if like_state is not None:
        return tree_map(lambda h, l: h.to(l.device, copy=True), host_state,
                        like_state)
    if device is None:
        raise ValueError("device_put_like: give like_state or device")
    return tree_map(lambda h: h.to(device, copy=True), host_state)


def replay(step_fn: Callable, batch_fn: Callable, snapshot_state,
           from_step: int, to_step: int, *, like_state=None, device=None,
           on_step: Optional[Callable] = None) -> ReplayResult:
    """Replay ``step_fn`` from the state snapshotted before step
    ``from_step`` up to (not including) ``to_step``."""
    if to_step < from_step:
        raise ValueError(f"replay backwards: {from_step} -> {to_step}")
    state = device_put_like(snapshot_state, like_state, device)
    for s in range(from_step, to_step):
        state, _ = step_fn(state, batch_fn(s))
        if on_step is not None:
            on_step(s, state)
    return ReplayResult(state=state, steps_replayed=to_step - from_step,
                        from_step=from_step, to_step=to_step)
