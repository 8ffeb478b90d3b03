"""Virtual clock + deterministic discrete-event queue for the fleet
simulator (a copy of the JAX package's ``core/fleet/clock.py``).

Real-socket benchmarks top out at a handful of concurrent edges a host;
studying a 1k-10k-edge deployment needs a *virtual* clock — the same
device the single-edge ``SimChannel`` already keeps (``elapsed_s``),
promoted to fleet scope. ``EventQueue`` is a classic discrete-event
core: a heap of ``(time, seq, callback)`` entries popped in time order,
with a monotonically increasing sequence number breaking ties in
*insertion order*, so two events scheduled for the same instant always
fire in the same order — the property the determinism regression test
(same scenario seed, bit-identical metrics) leans on. Nothing in this
module (or anything it schedules) may read the wall clock; all time is
``now`` and all randomness comes from seeded ``random.Random`` streams
owned by the scenario (``repro_torch.core.fleet.scenario``).
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Tuple


class EventQueue:
    """A virtual-clock discrete-event queue.

    ``push(t, fn)`` schedules ``fn`` at virtual time ``t`` (>= ``now``);
    ``run_until(horizon)`` pops and fires events in ``(time, seq)``
    order, advancing ``now`` to each event's timestamp, until the queue
    is empty or the next event lies beyond the horizon. Events may push
    further events (that is how the whole simulation unrolls).
    """

    def __init__(self) -> None:
        self.now = 0.0
        self._seq = 0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []

    def push(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at virtual time ``t`` (clamped to ``now`` —
        the past is immutable in a discrete-event world)."""
        heapq.heappush(self._heap, (max(t, self.now), self._seq, fn))
        self._seq += 1

    def __len__(self) -> int:
        return len(self._heap)

    def run_until(self, horizon: float = float("inf")) -> int:
        """Fire events in timestamp order up to (and including)
        ``horizon``; returns the number of events fired. ``now`` ends at
        the last fired event (or ``horizon`` if finite and later)."""
        fired = 0
        while self._heap and self._heap[0][0] <= horizon:
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
            fired += 1
        if horizon < float("inf"):
            self.now = max(self.now, horizon)
        return fired
