"""Fleet front tier — multi-server routing, health tracking, failover (a
copy of the JAX package's ``repro.core.collab.cluster``, which uses only
the standard library).

One ``CloudServer`` cannot carry a million-edge deployment: a single
process restart would drop every connected edge, and the only refuge
is degrading to edge-only inference. This module spreads edges
across N fleet servers and keeps collaborative serving available
through server loss, rolling restarts, and overload:

* ``RoutingPolicy`` — the serializable fleet description folded into
  ``DeploymentPlan`` (the ``routing`` section): the member ports plus
  the health thresholds (miss counts, dead-server retry interval).
* ``FleetRouter`` — the edge-side router. Assignment is
  rendezvous (highest-random-weight) hashing over the edge's wire
  **lane** key (``protocol.frame_lane`` vocabulary: ``"raw"``,
  ``"fp16+packed"``, ...), so every edge speaking one wire encoding
  lands on the same server and the dynamic batching engine's per-lane
  queues stay hot on one member instead of fragmenting fleet-wide.
  Health is tracked from observed transport outcomes (connect/request
  failures and heartbeat misses): ``miss count >= suspect`` demotes to
  *suspect* (still routable), ``>= dead`` removes the server from the
  ring; a dead server is re-probed after ``retry_dead_s`` so a
  restarted member heals back in without operator action.
* Degradation ladder (top to bottom): **reroute** to the next healthy
  member on death or a BUSY backpressure reply; **drain-migrate** on a
  DRAIN announcement (rolling restart, zero failed requests);
  **edge-only fallback** only when the whole fleet is gone
  (``FleetExhaustedError`` → the ``SplitFnBank`` c=N pair).

All ``FleetRouter`` shared-mutable state is guarded by one lock and
registered with the static analysis gate's lock-discipline check.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Tuple

#: health states of a fleet member, in degradation order
STATE_HEALTHY = "healthy"
STATE_SUSPECT = "suspect"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"
#: states the router will still hand out connections to
ROUTABLE_STATES = (STATE_HEALTHY, STATE_SUSPECT)


class FleetExhaustedError(ConnectionError):
    """Every fleet member is dead or draining — there is no server left
    to route to. The edge client catches this and serves the request
    locally (edge-only fallback), exactly like a single-server cloud
    death with the retry budget spent."""


@dataclass(frozen=True)
class RoutingPolicy:
    """Serializable fleet-routing contract (the plan's ``routing``
    section): which servers exist and when the router declares one
    suspect or dead.

    ``ports`` — fleet member ports (all on the plan's host).
    ``suspect_after_count`` / ``dead_after_count`` — consecutive
    transport misses (failed connects/requests, missed heartbeats)
    after which a member is demoted to suspect / removed from the
    routing ring.  ``retry_dead_s`` — seconds after which a dead member
    is offered again as a probe target, so a restarted server heals
    back into the ring.
    """

    ports: Tuple[int, ...] = ()
    suspect_after_count: int = 1
    dead_after_count: int = 2
    retry_dead_s: float = 5.0

    def __post_init__(self):
        object.__setattr__(self, "ports", tuple(int(p) for p in self.ports))
        if len(set(self.ports)) != len(self.ports):
            raise ValueError(f"duplicate fleet ports: {self.ports}")
        if self.suspect_after_count < 1:
            raise ValueError("suspect_after_count must be >= 1")
        if self.dead_after_count < self.suspect_after_count:
            raise ValueError(
                "dead_after_count must be >= suspect_after_count")
        if self.retry_dead_s <= 0:
            raise ValueError("retry_dead_s must be positive")

    def to_json(self) -> Dict:
        """JSON form for ``plan.json`` / the deployment contract."""
        return {
            "ports": list(self.ports),
            "suspect_after_count": self.suspect_after_count,
            "dead_after_count": self.dead_after_count,
            "retry_dead_s": self.retry_dead_s,
        }

    @classmethod
    def from_json(cls, doc: Dict) -> "RoutingPolicy":
        """Inverse of :meth:`to_json`."""
        return cls(ports=tuple(doc["ports"]),
                   suspect_after_count=int(doc["suspect_after_count"]),
                   dead_after_count=int(doc["dead_after_count"]),
                   retry_dead_s=float(doc["retry_dead_s"]))


def _rendezvous_score(key: str, port: int) -> int:
    """Deterministic highest-random-weight score of (lane key, member)."""
    h = hashlib.sha256(f"{key}|{port}".encode("ascii")).digest()
    return int.from_bytes(h[:8], "big")


class FleetRouter:
    """Edge-side fleet membership ring: consistent-hash routing plus
    miss-count health tracking (healthy → suspect → dead) and the
    drain/revive lifecycle used by rolling restarts.

    Thread-safe: every mutation of the per-server health maps happens
    under one internal lock (registered with the analysis gate), so a
    pipelined edge client's sender/receiver threads and the synchronous
    path can share one router.
    """

    def __init__(self, policy: RoutingPolicy, host: str = "127.0.0.1",
                 clock=time.monotonic):
        if not policy.ports:
            raise ValueError("RoutingPolicy has no fleet ports to route to")
        self.policy = policy
        self.host = host
        self._clock = clock
        self._lock = threading.Lock()
        self._state: Dict[int, str] = {p: STATE_HEALTHY for p in policy.ports}
        self._miss: Dict[int, int] = {p: 0 for p in policy.ports}
        self._dead_at_s: Dict[int, float] = {}
        self._routed: Dict[int, int] = {p: 0 for p in policy.ports}
        self._reroutes = 0

    # -- routing ------------------------------------------------------
    def _routable(self, now_s: float) -> Tuple[int, ...]:
        out = []
        for p in self.policy.ports:
            st = self._state[p]
            if st in ROUTABLE_STATES:
                out.append(p)
            elif (st == STATE_DEAD
                  and now_s - self._dead_at_s.get(p, now_s)
                  >= self.policy.retry_dead_s):
                out.append(p)      # probe: maybe it was restarted
        return tuple(out)

    def route(self, key: str,
              exclude: Tuple[int, ...] = ()) -> Tuple[str, int]:
        """Pick the fleet member for a lane key -> ``(host, port)``.

        Rendezvous hashing over the routable members: the same key maps
        to the same server until that server leaves the ring, and a
        member loss only remaps the lanes that lived there. ``exclude``
        deprioritizes members for this call (the server that just
        failed or answered BUSY) — a *preference*, not a filter: a
        lone routable member is still handed out so a single-server
        fleet keeps retrying it. Raises ``FleetExhaustedError`` only
        when nothing at all is routable — the caller degrades to
        edge-only inference.
        """
        now_s = self._clock()
        with self._lock:
            routable = self._routable(now_s)
            if not routable:
                raise FleetExhaustedError(
                    f"no routable fleet member for lane {key!r} "
                    f"(states: {dict(self._state)})")
            cands = [p for p in routable if p not in exclude] or list(routable)
            port = max(cands, key=lambda p: (_rendezvous_score(key, p), p))
            self._routed[port] += 1
            if exclude and port not in exclude:
                self._reroutes += 1
        return self.host, port

    # -- health tracking ----------------------------------------------
    def note_ok(self, port: int) -> None:
        """A request/heartbeat to ``port`` succeeded: reset its miss
        count and (unless draining) restore it to the healthy ring —
        this is how a dead-but-restarted member heals back in."""
        with self._lock:
            if port not in self._state:
                return
            self._miss[port] = 0
            if self._state[port] != STATE_DRAINING:
                self._state[port] = STATE_HEALTHY
                self._dead_at_s.pop(port, None)

    def note_miss(self, port: int) -> str:
        """A transport attempt to ``port`` failed (connect error, torn
        request, missed heartbeat): bump the miss count and demote
        through suspect to dead per the policy thresholds. Returns the
        member's new state."""
        now_s = self._clock()
        with self._lock:
            if port not in self._state:
                return STATE_DEAD
            self._miss[port] += 1
            if self._state[port] != STATE_DRAINING:
                if self._miss[port] >= self.policy.dead_after_count:
                    self._state[port] = STATE_DEAD
                    self._dead_at_s[port] = now_s
                elif self._miss[port] >= self.policy.suspect_after_count:
                    self._state[port] = STATE_SUSPECT
            return self._state[port]

    def note_drain(self, port: int) -> None:
        """The member announced DRAIN (rolling restart): take it out of
        the routing ring without counting it as a fault."""
        with self._lock:
            if port in self._state:
                self._state[port] = STATE_DRAINING

    def revive(self, port: int) -> None:
        """A drained/dead member finished restarting: put it straight
        back into the healthy ring."""
        with self._lock:
            if port in self._state:
                self._state[port] = STATE_HEALTHY
                self._miss[port] = 0
                self._dead_at_s.pop(port, None)

    # -- introspection ------------------------------------------------
    def state(self, port: int) -> str:
        """Current health state of one member."""
        with self._lock:
            return self._state.get(port, STATE_DEAD)

    def healthy_ports(self) -> Tuple[int, ...]:
        """Members the router would currently hand out (healthy or
        suspect; dead members past the retry window count as probes)."""
        now_s = self._clock()
        with self._lock:
            return self._routable(now_s)

    def stats(self) -> Dict:
        """Per-member rollup: state, miss/routed counts, plus the
        fleet-wide reroute count — merged into the serving benchmarks'
        fleet metrics."""
        with self._lock:
            return {
                "reroutes_count": self._reroutes,
                "servers": {
                    p: {"state": self._state[p],
                        "miss_count": self._miss[p],
                        "routed_count": self._routed[p]}
                    for p in self.policy.ports
                },
            }
