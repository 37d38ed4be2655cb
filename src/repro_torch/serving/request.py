"""Request/queue front end of the continuous-batching serving engine
(a copy of ``repro/serving/request.py``; it uses numpy only).

A ``Request`` carries everything the engine needs to (re)build its decode
state from scratch: the prompt and the accepted-token log.  The log IS the
serving RSI — prefix replay (prefill + forced decode over the log) rebuilds
a bit-identical cache, so a request survives the eviction of its slot with
no state beyond a few hundred int32s.

The ``RequestQueue`` is FIFO over arrival order with one extra operation,
``requeue_front``: a fault-evicted request re-enters at the FRONT of the
queue so its replay starts as soon as a slot frees (its arrival time has
long passed; making it wait behind fresh arrivals would double-charge it
for the fault).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32 prompt tokens
    max_new_tokens: int
    arrival_s: float = 0.0              # open-loop arrival (engine clock)
    #: extra per-request prefill features (B=1 leading axis), e.g.
    #: ``src_tokens`` / ``patch_embeds`` for encoder-decoder / VLM families
    features: dict = field(default_factory=dict)

    #: token log — log[0] is the prefill's argmax token (the first decode
    #: INPUT), log[1:] are accepted decode outputs.  Replay re-feeds
    #: log[:-1] and forces each step's output to the next log entry.
    log: List[int] = field(default_factory=list)
    #: outputs still to be forced during an in-progress prefix replay
    #: (drained by the engine; empty once the request is caught up)
    forced: Deque[int] = field(default_factory=deque)

    state: str = "queued"               # queued | active | done | dropped
    slot: Optional[int] = None
    replays: int = 0                    # fault-evictions survived
    retracted: int = 0                  # suspect tokens rescinded (total)

    # engine-clock timestamps (seconds since run start; -1 = not yet)
    t_admit_s: float = -1.0
    t_first_s: float = -1.0             # first generated token
    t_done_s: float = -1.0
    #: set at fault eviction; cleared (and accounted) at re-admission
    t_evicted_s: float = -1.0

    @property
    def n_out(self) -> int:
        """Accepted generated tokens (prefill token excluded)."""
        return max(0, len(self.log) - 1)

    @property
    def done(self) -> bool:
        return self.n_out >= self.max_new_tokens

    def retract(self, n: int) -> int:
        """Rescind the last ``n`` accepted outputs (suspect window after a
        fault; never touches log[0], the prefill token).  Returns how many
        were actually removed."""
        n = min(n, self.n_out)
        if n:
            del self.log[-n:]
            self.retracted += n
        return n


class RequestQueue:
    """Arrival-ordered FIFO with front-requeue for fault-evicted requests."""

    def __init__(self, requests=()):
        self._q: Deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid)))

    def __len__(self) -> int:
        return len(self._q)

    def push(self, rq: Request) -> None:
        self._q.append(rq)

    def requeue_front(self, rq: Request) -> None:
        rq.state = "queued"
        rq.slot = None
        self._q.appendleft(rq)

    def pop_ready(self, now_s: float) -> Optional[Request]:
        """Next request whose arrival time has passed (None if the head is
        still in the future or the queue is empty)."""
        if self._q and self._q[0].arrival_s <= now_s:
            return self._q.popleft()
        return None

    def next_arrival(self) -> Optional[float]:
        return self._q[0].arrival_s if self._q else None


class VirtualClock:
    """Deterministic engine clock for benchmarks and tests.

    ``clock()`` reads the current virtual time; ``clock.sleep(dt)``
    advances it.  ``ServingEngine.run`` waits for the next arrival via
    the clock's own ``sleep`` when it has one, so an idle engine on a
    virtual clock jumps straight to the next arrival instead of
    busy-spinning wall time that the virtual clock never sees."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, float(dt))
