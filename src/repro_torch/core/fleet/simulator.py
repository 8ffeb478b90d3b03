"""The fleet simulator: 1k-10k heterogeneous edges through the
edge -> cloudlet -> cloud hierarchy on one virtual clock (a copy of the
JAX package's ``core/fleet/simulator.py``, pricing the port's own
AlexNet cost table).

Every request walks the same path the real serving stack implements,
priced by the same models the single-edge benchmarks calibrate:

1. *Arrival* — the edge's seeded inhomogeneous-Poisson stream fires.
2. *Admission* — ``AdmissionController`` routes it (collab / degrade
   to edge-only / shed) against its SLO class's ``FaultPolicy``.
3. *Edge compute* — layers ``[0, c1)`` at the device's Eq. 5 time.
4. *Wireless uplink* — ``SimChannel`` piecewise trace accounting, the
   channel clock pinned to the fleet clock plus the edge's phase.
5. *Cloudlet* — its ``TierServer`` fuses the ``[c1, c2)`` segment into
   dynamic batches (or is skipped when ``c2 == c1``).
6. *Backhaul* — wired metro link to the datacenter (skipped when
   ``c2 == N``).
7. *Cloud* — the big batched tier runs ``[c2, N)`` and completes.

On completion the edge's battery pays ``EnergyProfile.request_energy``
for its compute, radio, and wait time; an exhausted edge sheds every
subsequent request it originates. All timing is virtual — wall-clock
only bounds how fast the heap drains, never what the metrics say —
so the whole run is bit-reproducible from ``FleetScenario.seed``.

Chaos (the scenario's ``chaos`` events, mirroring the serving stack's
failover drills): a killed or draining cloudlet stops admitting, and
requests bound for it — new arrivals and orphaned in-flight work —
reroute to the next admitting cloudlet (counted in the rollup's
``chaos_reroutes_count``), shedding with reason ``"queue"`` only when
every cloudlet is gone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.fleet.admission import (AdmissionController, RoutePlan,
                                        SplitPlanner)
from repro_torch.core.fleet.clock import EventQueue
from repro_torch.core.fleet.metrics import FleetMetrics, RequestRecord
from repro_torch.core.fleet.population import SimEdge, build_population
from repro_torch.core.fleet.scenario import FleetScenario
from repro_torch.core.fleet.tiers import (CLOUD_SERVER, CLOUDLET_SERVER,
                                    TierServer)
from repro_torch.core.partition.latency_model import (LayerCost, cnn_input_bytes,
                                                cnn_layer_costs)
from repro_torch.models.cnn import alexnet_config


@dataclass
class _Request:
    """In-flight request context threaded through the tier callbacks."""
    edge: SimEdge
    t_arrive: float
    plan: RoutePlan
    t_tx_s: float = 0.0
    tx_bytes: float = 0.0
    rtt_s: float = 0.0


class FleetSimulator:
    """Drives one ``FleetScenario`` to completion and rolls up metrics.

    ``run()`` returns the flat BENCH_fleet rollup dict. The network
    defaults to the paper's AlexNet/PlantVillage configuration (the
    same cost table every other subsystem prices), overridable for
    tests via ``costs``/``input_bytes``.
    """

    def __init__(self, scenario: FleetScenario,
                 costs: Optional[Sequence[LayerCost]] = None,
                 input_bytes: Optional[float] = None):
        if costs is None:
            cfg = alexnet_config()
            costs = cnn_layer_costs(cfg)
            input_bytes = cnn_input_bytes(cfg)
        if input_bytes is None:
            raise ValueError("input_bytes is required with custom costs")
        self.scenario = scenario
        self.costs = list(costs)
        self.input_bytes = float(input_bytes)
        self.events = EventQueue()
        self.edges = build_population(scenario)
        self.planner = SplitPlanner(scenario, self.costs, self.input_bytes)
        self.admission = AdmissionController(self.planner)
        self.cloudlets = [
            TierServer(f"cloudlet{i}", CLOUDLET_SERVER,
                       scenario.cloudlet_batching, self.costs, self.events,
                       max_queue=scenario.max_queue)
            for i in range(scenario.n_cloudlets)]
        self.cloud = TierServer("cloud", CLOUD_SERVER,
                                scenario.cloud_batching, self.costs,
                                self.events,
                                max_queue=scenario.max_queue
                                * scenario.n_cloudlets)
        for srv in self.cloudlets:
            srv.on_orphan = self._reroute
        self.metrics = FleetMetrics(scenario)

    # -- lifecycle ----------------------------------------------------------
    def run(self) -> Dict[str, float]:
        """Simulate ``duration_s`` of virtual time (arrivals stop at the
        horizon; in-flight requests drain to completion) and return the
        rollup."""
        for edge in self.edges:
            t0 = edge.next_arrival(0.0, self.scenario.arrival)
            if t0 < self.scenario.duration_s:
                self.events.push(t0, lambda e=edge: self._arrive(e))
        for ev in self.scenario.chaos:
            self.events.push(ev.t_s, lambda e=ev: self._chaos(e))
        self.events.run_until()
        return self.metrics.rollup(
            [c.stats for c in self.cloudlets], self.cloud.stats,
            exhausted_edges=sum(1 for e in self.edges if e.exhausted))

    # -- request pipeline ---------------------------------------------------
    def _arrive(self, edge: SimEdge) -> None:
        now = self.events.now
        nxt = edge.next_arrival(now, self.scenario.arrival)
        if nxt < self.scenario.duration_s:
            self.events.push(nxt, lambda e=edge: self._arrive(e))
        cloudlet = self.cloudlets[edge.cloudlet_id]
        plan = self.admission.decide(edge, now,
                                     cloudlet.backlog_s(now),
                                     self.cloud.backlog_s(now))
        if plan.route == "shed":
            self.metrics.add(RequestRecord(
                slo=edge.slo.name, route="shed", shed_reason=plan.reason,
                deadline_s=edge.slo.deadline_s,
                device_class=edge.device_class))
            return
        if plan.route == "edge":
            # local-only: no queueing, completes after the device time
            e_j = edge.energy.request_energy(plan.t_edge_s, 0.0, 0.0)
            edge.drain(e_j)
            self.metrics.add(RequestRecord(
                slo=edge.slo.name, route="edge", latency_s=plan.t_edge_s,
                deadline_s=edge.slo.deadline_s, e_edge_j=e_j,
                device_class=edge.device_class))
            return
        # collaborative: edge computes [0, c1), then ships the boundary
        req = _Request(edge=edge, t_arrive=now, plan=plan)
        t_ready = now + plan.t_edge_s
        req.tx_bytes = self.planner.boundary_bytes(plan.c1)
        _, req.rtt_s = edge.link_state(t_ready)
        req.t_tx_s = edge.send(req.tx_bytes, t_ready)
        self.events.push(t_ready + req.t_tx_s,
                         lambda r=req: self._at_cloudlet(r))

    def _at_cloudlet(self, req: _Request) -> None:
        plan = req.plan
        if plan.c2 == plan.c1:
            # nothing for the cloudlet to run — straight to backhaul
            self._to_cloud(req, self.events.now)
            return
        server = self.cloudlets[req.edge.cloudlet_id]
        if not (server.alive and server.admitting):
            self._reroute(req)
            return
        if not server.submit((plan.c1, plan.c2), req,
                             lambda r, t: self._cloudlet_done(r, t)):
            self._shed_inflight(req, "queue")

    # -- chaos --------------------------------------------------------------
    def _chaos(self, ev) -> None:
        """Apply one scheduled ``ChaosEvent`` to its target cloudlet."""
        srv = self.cloudlets[ev.cloudlet % len(self.cloudlets)]
        if ev.kind == "kill":
            srv.kill()
        elif ev.kind == "drain":
            srv.drain()
        else:
            srv.revive()

    def _next_admitting(self, home: int):
        """The nearest admitting cloudlet after ``home`` in ring order,
        or None when the whole tier is down."""
        n = len(self.cloudlets)
        for k in range(1, n):
            srv = self.cloudlets[(home + k) % n]
            if srv.alive and srv.admitting:
                return srv
        return None

    def _reroute(self, req: _Request) -> None:
        """Move a request whose home cloudlet is dead/draining to the
        next admitting one (the simulator analogue of the serving
        stack's fleet reroute); shed with reason ``"queue"`` only when
        no cloudlet admits."""
        server = self._next_admitting(req.edge.cloudlet_id)
        if server is None:
            self._shed_inflight(req, "queue")
            return
        self.metrics.note_reroute()
        plan = req.plan
        if not server.submit((plan.c1, plan.c2), req,
                             lambda r, t: self._cloudlet_done(r, t)):
            self._shed_inflight(req, "queue")

    def _cloudlet_done(self, req: _Request, t: float) -> None:
        self._to_cloud(req, t)

    def _to_cloud(self, req: _Request, now: float) -> None:
        plan = req.plan
        n = len(self.costs)
        if plan.c2 >= n:
            self._complete(req, now)
            return
        link = self.planner.backhaul
        t_bh = link.rtt_s + self.planner.boundary_bytes(plan.c2) \
            / link.bandwidth
        self.events.push(now + t_bh, lambda r=req: self._submit_cloud(r))

    def _submit_cloud(self, req: _Request) -> None:
        plan = req.plan
        if not self.cloud.submit((plan.c2, len(self.costs)), req,
                                 lambda r, t: self._complete(r, t)):
            self._shed_inflight(req, "queue")

    # -- terminal states ----------------------------------------------------
    def _complete(self, req: _Request, t_done: float) -> None:
        edge, plan = req.edge, req.plan
        latency = t_done - req.t_arrive
        # the edge waited (radio idle) from the end of its uplink until
        # the answer came back — that idle time costs joules too
        t_wait = max(latency - plan.t_edge_s - req.t_tx_s, 0.0)
        e_j = edge.energy.request_energy(plan.t_edge_s, req.t_tx_s,
                                         t_wait, rtt_s=req.rtt_s)
        edge.drain(e_j)
        self.metrics.add(RequestRecord(
            slo=edge.slo.name, route="collab", latency_s=latency,
            deadline_s=edge.slo.deadline_s, e_edge_j=e_j,
            tx_bytes=req.tx_bytes, device_class=edge.device_class))

    def _shed_inflight(self, req: _Request, reason: str) -> None:
        """A tier queue bound rejected the request after the edge already
        spent compute + uplink joules — charge the battery, count the
        shed."""
        edge, plan = req.edge, req.plan
        e_j = edge.energy.request_energy(plan.t_edge_s, req.t_tx_s, 0.0,
                                         rtt_s=req.rtt_s)
        edge.drain(e_j)
        self.metrics.add(RequestRecord(
            slo=edge.slo.name, route="shed", shed_reason=reason,
            deadline_s=edge.slo.deadline_s, e_edge_j=e_j,
            tx_bytes=req.tx_bytes, device_class=edge.device_class))


def simulate_fleet(scenario: FleetScenario, **kw) -> Dict[str, float]:
    """One-call convenience: build, run, roll up."""
    return FleetSimulator(scenario, **kw).run()
