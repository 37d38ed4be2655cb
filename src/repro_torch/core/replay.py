"""Pure-step replay — the RSI (Recoverable Sequence of Instructions)
rung; counterpart of ``repro/core/replay.py``.

The whole step is pure, ``state_t = step(state_{t-1}, batch(t-1))`` with
``batch(t) = f(seed, t)``, so from any verified snapshot at ``t0 <= t``
the exact state at ``t`` is recomputed by replaying ``t - t0``
deterministic steps — bit-exact on the same device (on the card the
training entry point turns on PyTorch's deterministic algorithms, so the
embedding and logits backward do not accumulate with atomics).

On a mesh every rank replays its own blocks in lockstep through the mesh
step: its snapshot holds those blocks, so the upload needs no
shardings (the live blocks, ``like_state`` or ``into``, place them).

A donated loop replays ``into`` its live state: the snapshot is copied
into the live tensors and the steps (in place) run there, so the state
keeps every ``data_ptr`` — the canary's pack schedules and the captured
graphs of the fused step read those addresses.  A functional step
replays ``into`` a state its caller drops anyway (the faulty one): each
replayed step's output is copied back into those tensors and freed, so a
replay holds two state versions, as a step does, and not three.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.tree import flatten_with_path, tree_map


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


def copy_into(live, tree):
    """Write every leaf of ``tree`` into the same-path leaf of ``live``
    (``copy_``; a leaf that already is the live tensor is skipped) and
    return ``live``."""
    for (_, dst), (_, src) in zip(flatten_with_path(live),
                                  flatten_with_path(tree)):
        if src is not dst:
            dst.copy_(src)
    return live


def replay(step_fn: Callable, batch_fn: Callable, snapshot_state,
           from_step: int, to_step: int, *, like_state=None, device=None,
           into=None, on_step: Optional[Callable] = None) -> ReplayResult:
    """Replay ``step_fn`` from the state snapshotted before step
    ``from_step`` up to (not including) ``to_step``.  With ``into`` (a
    live state, or one its caller drops) the snapshot is copied into its
    tensors, each step's output is copied back into them (a no-op for an
    in-place step) and the result is ``into`` itself."""
    if to_step < from_step:
        raise ValueError(f"replay backwards: {from_step} -> {to_step}")
    if into is not None:
        state = copy_into(into, snapshot_state)
    else:
        state = device_put_like(snapshot_state, like_state, device)
    for s in range(from_step, to_step):
        state, _ = step_fn(state, batch_fn(s))
        if into is not None:
            state = copy_into(into, state)
        if on_step is not None:
            on_step(s, state)
    return ReplayResult(state=state, steps_replayed=to_step - from_step,
                        from_step=from_step, to_step=to_step)
