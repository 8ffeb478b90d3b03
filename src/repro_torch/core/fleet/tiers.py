"""The cloudlet and cloud tiers of the simulated hierarchy (a copy of
the JAX package's ``core/fleet/tiers.py``).

The hierarchical-FL plant-disease line of work motivates an
intermediate *cloudlet* between the field devices and the datacenter:
close enough for tight deadlines, big enough to batch. ``TierServer``
models one such aggregation point as a virtual-clock analogue of the
``DynamicBatcher``: per-lane queues keyed by the layer segment a
batch will run (requests of different splits never fuse — their
tensors have different shapes), a batching window while the server is
idle, padding to the ``BatchingPolicy``'s bucket shapes, and ONE
modeled invocation per fused batch priced by
``latency_model.batched_segment_time`` — the same single formula the
measured batching engine charges through ``simulate_server``, so fleet
numbers and socket-bench numbers can never drift apart.

Hardware defaults mirror the calibrated registry: a cloudlet is the
Jetson-class aggregation box (``profiles.CLOUDLET_SERVER``), the cloud
is the batched-sustained 3090 calibration (``PAPER_SERVER_BATCHED``),
and the cloudlet->cloud backhaul is a metro-fiber ``LinkProfile``
built by ``backhaul_link``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.collab.batching import BatchingPolicy, bucket_for
from repro_torch.core.fleet.clock import EventQueue
from repro_torch.core.partition.latency_model import (LayerCost,
                                                batched_segment_time)
from repro_torch.core.partition.profiles import (CLOUDLET_SERVER, ComputeProfile,
                                           LinkProfile,
                                           PAPER_SERVER_BATCHED)

#: the cloud tier's accelerator: the batched-sustained calibration the
#: cross-client batching benchmarks validated
CLOUD_SERVER = PAPER_SERVER_BATCHED


def backhaul_link(mbps: float, rtt_ms: float) -> LinkProfile:
    """The cloudlet->cloud metro link as a ``LinkProfile`` (wired, so a
    static profile rather than a wireless ``LinkTrace``)."""
    return LinkProfile(f"backhaul {mbps:g} Mbps", bandwidth=mbps * 1e6 / 8,
                       rtt_s=rtt_ms * 1e-3)


@dataclass
class TierStats:
    """Per-server accounting the metrics rollup aggregates."""
    busy_s: float = 0.0
    rows: int = 0
    batches: int = 0
    padded_rows: int = 0
    shed: int = 0
    max_queue: int = 0
    queue_samples: int = 0
    queue_sum: int = 0

    @property
    def avg_batch(self) -> float:
        """Mean real rows per fused invocation."""
        return self.rows / self.batches if self.batches else 0.0

    @property
    def padding_waste(self) -> float:
        """Fraction of computed rows that were bucket padding."""
        total = self.rows + self.padded_rows
        return self.padded_rows / total if total else 0.0

    @property
    def mean_queue(self) -> float:
        """Queue depth averaged over arrival instants."""
        return (self.queue_sum / self.queue_samples
                if self.queue_samples else 0.0)


class TierServer:
    """One batched accelerator of a tier, on the fleet virtual clock.

    Lanes are keyed by the ``(start, stop)`` layer segment their
    requests run (the fleet analogue of the batching engine's
    ``(split, wire-lane, compact)`` key); the server serializes all
    lanes on one modeled accelerator, exactly like the measured
    ``DynamicBatcher`` over a single device. ``submit`` returns False
    when the queue bound is hit (the caller sheds). Completion
    callbacks fire on the event queue, which is what chains the
    hierarchy together.

    Chaos lifecycle (the scenario's ``chaos`` events): ``drain`` stops
    admission while queued batches keep flushing (the rolling-restart
    half of the serving stack's DRAIN frame); ``kill`` crashes the
    server — queued and in-flight entries are handed to ``on_orphan``
    (the simulator reroutes them to another admitting cloudlet);
    ``revive`` puts it back in service.
    """

    def __init__(self, name: str, profile: ComputeProfile,
                 policy: BatchingPolicy, costs: Sequence[LayerCost],
                 events: EventQueue, max_queue: Optional[int] = None):
        self.name = name
        self.profile = profile
        self.policy = policy
        self.costs = costs
        self.events = events
        self.max_queue = max_queue
        self.stats = TierStats()
        #: chaos state: a drained server stops admitting, a killed one
        #: is gone until revive()
        self.admitting = True
        self.alive = True
        #: where orphaned entries go on kill (set by the simulator);
        #: None silently drops them
        self.on_orphan: Optional[Callable[[object], None]] = None
        self._lanes: Dict[Tuple[int, int], List] = {}
        self._busy = False
        self._busy_until = 0.0
        self._start_pending = False

    # -- queue state --------------------------------------------------------
    @property
    def pending_rows(self) -> int:
        """Rows queued across all lanes right now."""
        return sum(len(q) for q in self._lanes.values())

    def backlog_s(self, now: float) -> float:
        """A deterministic service-backlog estimate for admission
        control: full batches ahead of a new arrival, each priced at
        the policy's max bucket over the deepest lane's segment. An
        estimate, not ground truth — the admission controller is a
        heuristic operator, not an oracle."""
        remainder = max(self._busy_until - now, 0.0) if self._busy else 0.0
        pending = self.pending_rows
        if pending == 0:
            return remainder
        seg = max(self._lanes, key=lambda k: (len(self._lanes[k]), k))
        t_batch = batched_segment_time(self.costs, seg[0], seg[1],
                                       self.profile,
                                       self.policy.max_batch)
        n_batches = (pending + self.policy.max_batch - 1) \
            // self.policy.max_batch
        return remainder + n_batches * t_batch

    # -- request flow -------------------------------------------------------
    def submit(self, segment: Tuple[int, int], payload,
               done: Callable[[object, float], None]) -> bool:
        """Queue one request (``payload``) for layers ``segment`` =
        ``(start, stop)``; ``done(payload, t)`` fires when its fused
        batch completes. Returns False (nothing queued) when the
        tier's queue bound is hit — the shed is the caller's to
        account. A dead or draining server admits nothing (the caller
        checks ``alive``/``admitting`` first to reroute instead)."""
        if not (self.alive and self.admitting):
            return False
        depth = self.pending_rows
        self.stats.queue_samples += 1
        self.stats.queue_sum += depth
        if self.max_queue is not None and depth >= self.max_queue:
            self.stats.shed += 1
            return False
        self._lanes.setdefault(segment, []).append((payload, done))
        self.stats.max_queue = max(self.stats.max_queue, depth + 1)
        if not self._busy and not self._start_pending:
            # idle server: open the batching window — immediately when a
            # full batch is already waiting, else hold max_wait_ms for
            # concurrent arrivals to fuse (the DynamicBatcher window)
            wait = (0.0 if self.pending_rows >= self.policy.max_batch
                    else self.policy.max_wait_ms * 1e-3)
            self._start_pending = True
            self.events.push(self.events.now + wait, self._start)
        return True

    def _start(self) -> None:
        self._start_pending = False
        if self._busy or not self._lanes:
            return
        # deepest lane first (deterministic tie-break on the key)
        seg = max(self._lanes, key=lambda k: (len(self._lanes[k]),
                                              (-k[0], -k[1])))
        lane = self._lanes[seg]
        batch = lane[:self.policy.max_batch]
        del lane[:self.policy.max_batch]
        if not lane:
            del self._lanes[seg]
        bucket = bucket_for(len(batch), self.policy.resolved_buckets)
        t_serve = batched_segment_time(self.costs, seg[0], seg[1],
                                       self.profile, bucket)
        self._busy = True
        self._busy_until = self.events.now + t_serve
        self.stats.busy_s += t_serve
        self.stats.batches += 1
        self.stats.rows += len(batch)
        self.stats.padded_rows += bucket - len(batch)
        self.events.push(self.events.now + t_serve,
                         lambda b=batch: self._finish(b))

    def _finish(self, batch) -> None:
        self._busy = False
        now = self.events.now
        if not self.alive:
            # the server died while this batch was on the accelerator:
            # its work is lost — orphan the entries for rerouting
            for payload, _done in batch:
                if self.on_orphan is not None:
                    self.on_orphan(payload)
            return
        for payload, done in batch:
            done(payload, now)
        if self._lanes and not self._start_pending:
            # completion path: fuse whatever queued meanwhile, no window
            # (matches the engine's drain-on-completion behaviour)
            self._start_pending = True
            self.events.push(now, self._start)

    # -- chaos lifecycle ----------------------------------------------------
    def drain(self) -> None:
        """Rolling-restart drain: stop admitting; queued batches keep
        flushing to completion."""
        self.admitting = False

    def kill(self) -> None:
        """Crash: stop admitting, drop every queued lane entry to
        ``on_orphan`` (in-flight batch entries follow when their modeled
        invocation would have completed)."""
        self.alive = False
        self.admitting = False
        orphans = [entry for q in self._lanes.values() for entry in q]
        self._lanes.clear()
        for payload, _done in orphans:
            if self.on_orphan is not None:
                self.on_orphan(payload)

    def revive(self) -> None:
        """Bring a drained/killed server back into service."""
        self.alive = True
        self.admitting = True
