"""SLO-driven admission control for the fleet hierarchy (a copy of the
JAX package's ``core/fleet/admission.py``).

Every arrival is triaged before any tier spends cycles on it, the same
way the real serving stack's ``FaultPolicy`` triages a straggling
request — and deliberately *with* the same policy type: an
``SLOClass`` wraps a ``FaultPolicy`` whose ``request_deadline_s``
is the class deadline and whose ``fallback`` selects what a
deadline-infeasible request degrades to (``"edge"`` -> run the whole
network locally, ``"fail"`` -> shed). No forked enum, no parallel
semantics to keep in sync.

Split decisions are not invented here either. ``SplitPlanner`` calls
the partition subsystem's own optimizers — ``energy_aware_split`` with
the adaptive controller's urgency-scaled battery weight for the
edge->cloudlet point ``c1``, ``greedy_split`` restricted to candidates
``>= c1`` for the cloudlet->cloud point ``c2`` — and memoizes by
(device class, link state, battery decile), which stays small because
``LinkTrace``s are piecewise constant: a 10k-edge fleet resolves to a
few dozen distinct planning states.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.collab.protocol import CODEC_TX_SCALE
from repro_torch.core.fleet.population import SimEdge
from repro_torch.core.fleet.scenario import FleetScenario
from repro_torch.core.fleet.tiers import (CLOUD_SERVER, CLOUDLET_SERVER,
                                    backhaul_link)
from repro_torch.core.partition.energy_model import (EnergyPolicy,
                                               urgency_scaled_weight)
from repro_torch.core.partition.latency_model import (LayerCost,
                                                batched_segment_time)
from repro_torch.core.partition.profiles import LinkProfile, TwoTierProfile
from repro_torch.core.partition.splitter import energy_aware_split, greedy_split


@dataclass(frozen=True)
class RoutePlan:
    """The admission verdict for one request.

    ``route`` is ``"collab"`` (edge runs ``[0, c1)``, cloudlet
    ``[c1, c2)``, cloud ``[c2, N)``; ``c2 == c1`` encodes the
    spillover bypass — a backlogged cloudlet forwards straight to the
    cloud), ``"edge"`` (deadline-degraded
    local-only execution, the ``FaultPolicy(fallback="edge")``
    semantics), or ``"shed"`` with ``reason`` saying why
    (``"battery"``, ``"deadline"``, or a tier ``"queue"`` later in the
    pipeline). Latency fields are the *planning estimates* Eq. 5
    produced; the simulator then charges actual queueing/batching on
    top.
    """
    route: str
    reason: str = ""
    c1: int = 0
    c2: int = 0
    t_edge_s: float = 0.0
    t_tx_s: float = 0.0
    t_rest_est_s: float = 0.0


class SplitPlanner:
    """Memoized per-tier split decisions over the scenario's network.

    The edge decision prices the device against the *cloudlet* server
    (that is the machine its features land on), battery urgency scaling
    the energy weight exactly as ``AdaptiveSplitController`` does. The
    cloudlet decision then places ``c2`` for the remaining layers
    against the cloud over the wired backhaul — cached per ``c1``
    because the backhaul is static.
    """

    def __init__(self, scenario: FleetScenario,
                 costs: Sequence[LayerCost], input_bytes: float):
        self.scenario = scenario
        self.costs = costs
        self.input_bytes = input_bytes
        self.tx_scale = CODEC_TX_SCALE[scenario.codec]
        self.backhaul = backhaul_link(scenario.backhaul_mbps,
                                      scenario.backhaul_rtt_ms)
        self._edge_cache: Dict[Tuple, Tuple[int, float, float, float]] = {}
        self._cloudlet_cache: Dict[int, int] = {}

    def edge_decision(self, edge: SimEdge,
                      now: float) -> Tuple[int, float, float, float]:
        """(c1, T_D, T_TX, T_edge_only) for this edge's link/battery
        state at fleet time ``now``. Battery urgency is bucketed to
        deciles so the cache stays finite while still shifting the
        split as the budget drains."""
        bw, rtt = edge.link_state(now)
        decile = min(int(edge.battery_fraction * 10), 10)
        key = (edge.device_class, bw, rtt, decile)
        hit = self._edge_cache.get(key)
        if hit is None:
            profile = TwoTierProfile(
                edge.compute, CLOUDLET_SERVER,
                LinkProfile("fleet-link", bandwidth=bw, rtt_s=rtt))
            policy = EnergyPolicy(
                profile=edge.energy,
                energy_weight_s_per_j=self.scenario.energy_weight_s_per_j)
            # urgency at the decile's midpoint, not the exact fraction —
            # the cache key is the decile, so the cached decision must
            # not depend on which edge populated it first
            frac = 1.0 if decile >= 10 else (decile + 0.5) / 10.0
            weight = urgency_scaled_weight(
                self.scenario.energy_weight_s_per_j, frac)
            dec = energy_aware_split(self.costs, profile, self.input_bytes,
                                     policy, energy_weight=weight,
                                     tx_scale=self.tx_scale)
            local = next(r for r in dec.table
                         if r["split"] == len(self.costs))
            hit = (dec.split_point, dec.latency["T_D"],
                   dec.latency["T_TX"], local["T_D"])
            self._edge_cache[key] = hit
        return hit

    def cloudlet_decision(self, c1: int) -> int:
        """c2 >= c1: where the cloudlet hands the tail of the network to
        the cloud. ``sweep_splits``' device time over ``[0, c2)`` differs
        from the cloudlet's true ``[c1, c2)`` only by the constant
        ``[0, c1)`` prefix, so the restricted argmin is exact."""
        c2 = self._cloudlet_cache.get(c1)
        if c2 is None:
            profile = TwoTierProfile(CLOUDLET_SERVER, CLOUD_SERVER,
                                     self.backhaul)
            dec = greedy_split(self.costs, profile, self.input_bytes,
                               candidates=range(c1, len(self.costs) + 1),
                               tx_scale=self.tx_scale)
            c2 = dec.split_point
            self._cloudlet_cache[c1] = c2
        return c2

    def boundary_bytes(self, c: int) -> float:
        """Wire bytes crossing split ``c`` (codec-scaled)."""
        raw = (self.input_bytes if c == 0
               else self.costs[c - 1].out_bytes)
        return raw * self.tx_scale


class AdmissionController:
    """Deadline triage at the fleet's front door.

    ``decide`` builds the request's ``RoutePlan``: shed exhausted
    batteries outright, estimate the collaborative path end-to-end
    (edge compute + wireless tx + cloudlet backlog + cloudlet segment +
    backhaul + cloud backlog + cloud segment), and compare against the
    SLO deadline; an infeasible request degrades to edge-only when its
    ``FaultPolicy`` says ``fallback="edge"`` *and* local execution
    meets the deadline, else it is shed. The backlog terms come from
    the tiers' ``backlog_s`` estimates — a heuristic operator, so the
    met-deadline fraction in the rollup is the honest scoreboard.
    """

    def __init__(self, planner: SplitPlanner):
        self.planner = planner
        self.costs = planner.costs

    def decide(self, edge: SimEdge, now: float,
               cloudlet_backlog_s: float,
               cloud_backlog_s: float) -> RoutePlan:
        if edge.exhausted:
            return RoutePlan(route="shed", reason="battery")
        deadline = edge.slo.deadline_s
        c1, t_d, t_tx, t_local = self.planner.edge_decision(edge, now)
        c2 = self.planner.cloudlet_decision(c1)
        n = len(self.costs)
        link = self.planner.backhaul

        def t_backhaul(c: int) -> float:
            return (link.rtt_s
                    + self.planner.boundary_bytes(c) / link.bandwidth)

        # path A: cloudlet runs [c1, c2), cloud the rest (if any)
        t_cloudlet = batched_segment_time(self.costs, c1, c2,
                                          CLOUDLET_SERVER, 1) \
            if c2 > c1 else 0.0
        via_cloudlet = cloudlet_backlog_s + t_cloudlet
        if c2 < n:
            via_cloudlet += (t_backhaul(c2) + cloud_backlog_s
                             + batched_segment_time(self.costs, c2, n,
                                                    CLOUD_SERVER, 1))
        # path B: bypass a backlogged cloudlet, cloud runs [c1, N) —
        # the spillover that keeps an under-provisioned cloudlet tier
        # from dragging every deadline down with it
        via_cloud = (t_backhaul(c1) + cloud_backlog_s
                     + batched_segment_time(self.costs, c1, n,
                                            CLOUD_SERVER, 1)) \
            if c1 < n else float("inf")
        if via_cloud < via_cloudlet:
            c2, t_rest = c1, via_cloud      # c2 == c1 encodes the bypass
        else:
            t_rest = via_cloudlet
        est = t_d + t_tx + t_rest
        if c1 < n and est <= deadline:
            return RoutePlan(route="collab", c1=c1, c2=c2, t_edge_s=t_d,
                             t_tx_s=t_tx, t_rest_est_s=t_rest)
        if c1 == n:
            # the optimizer itself chose local-only — not a degradation
            return RoutePlan(route="edge", c1=n, c2=n, t_edge_s=t_local)
        # collaborative path infeasible: degrade per the SLO's
        # FaultPolicy fallback semantics, or shed
        if edge.slo.policy.fallback == "edge" and t_local <= deadline:
            return RoutePlan(route="edge", reason="deadline", c1=n, c2=n,
                             t_edge_s=t_local)
        return RoutePlan(route="shed", reason="deadline")
