"""Heterogeneous edge population for the fleet simulator (a copy of the
JAX package's ``core/fleet/population.py``).

``build_population`` instantiates ``FleetScenario.n_edges`` simulated
edges from the scenario's seeded mixes: each edge gets a device class
(compute + energy profile pair from ``DEVICE_CLASSES``), its own
``LinkTrace`` replayed through a private ``SimChannel`` (the *same*
piecewise trace accounting the single-edge benchmarks measure, with a
seeded phase offset so a fleet on ``wifi_degrading`` does not degrade in
lockstep), a battery budget in joules, an SLO class, and a seeded RNG
stream for its inhomogeneous-Poisson arrivals. Same scenario seed =>
byte-identical population, forever.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.collab.channel import SimChannel
from repro_torch.core.fleet.scenario import ArrivalPattern, FleetScenario, SLOClass
from repro_torch.core.partition.energy_model import (ENERGY_PROFILES,
                                               EnergyProfile)
from repro_torch.core.partition.profiles import (ComputeProfile, LinkTrace,
                                           MCU_EDGE, PHONE_EDGE, PI_EDGE,
                                           TRACES)

#: device-class registry: name -> (compute profile, energy profile) —
#: the heterogeneous hardware the fleet mixes (the phone
#: class joins the MCU/Pi pair from the energy subsystem)
DEVICE_CLASSES: Dict[str, Tuple[ComputeProfile, EnergyProfile]] = {
    "mcu": (MCU_EDGE, ENERGY_PROFILES["mcu"]),
    "pi": (PI_EDGE, ENERGY_PROFILES["pi"]),
    "phone": (PHONE_EDGE, ENERGY_PROFILES["phone"]),
}


def _weighted_pick(mix: Tuple[Tuple[str, float], ...],
                   u: float) -> str:
    """Deterministic cumulative-share pick: ``u`` in [0, 1)."""
    acc = 0.0
    for name, share in mix:
        acc += share
        if u < acc:
            return name
    return mix[-1][0]


@dataclass
class SimEdge:
    """One simulated edge device (mutable run state).

    ``channel`` replays the edge's ``LinkTrace`` with ``SimChannel``'s
    piecewise accounting — the simulator sets ``channel.elapsed_s`` to
    the fleet's virtual clock (plus this edge's ``trace_phase``) before
    each send, so a transmission straddling a bandwidth change pays
    exactly the blended cost. ``battery_left_j`` is drained through
    ``EnergyProfile.request_energy`` per served request; an exhausted
    edge sheds everything it originates.
    """
    eid: int
    device_class: str
    compute: ComputeProfile
    energy: EnergyProfile
    trace: LinkTrace
    trace_phase: float
    slo: SLOClass
    battery_j: float
    battery_left_j: float
    cloudlet_id: int
    rng: random.Random = field(repr=False)
    channel: SimChannel = field(repr=False)

    @property
    def battery_fraction(self) -> float:
        """Remaining battery as a fraction of the budget (>= 0)."""
        return max(self.battery_left_j, 0.0) / self.battery_j

    @property
    def exhausted(self) -> bool:
        """True once the battery budget has fully drained."""
        return self.battery_left_j <= 0.0

    def drain(self, e_j: float) -> None:
        """Subtract one request's edge joules from the battery."""
        self.battery_left_j = max(self.battery_left_j - e_j, 0.0)

    def link_state(self, now: float) -> Tuple[float, float]:
        """(bandwidth bytes/s, rtt_s) this edge's link shows at fleet
        virtual time ``now`` (phase-shifted into its trace)."""
        return self.trace.state_at(now + self.trace_phase)

    def send(self, nbytes: int, now: float) -> float:
        """Piecewise-accounted uplink cost (seconds, incl. one RTT) of
        sending ``nbytes`` at fleet virtual time ``now`` — a
        ``SimChannel.send`` with the channel clock pinned to the fleet
        clock first."""
        self.channel.elapsed_s = now + self.trace_phase
        return self.channel.send(nbytes)

    def next_arrival(self, t: float, pattern: ArrivalPattern) -> float:
        """The edge's next request time after ``t``: inhomogeneous
        Poisson by thinning against the diurnal peak rate, drawn from
        this edge's private seeded RNG stream."""
        lam = pattern.peak_rate_hz
        while True:
            t += self.rng.expovariate(lam)
            if (self.rng.random() * lam
                    <= pattern.rate_at(t, self.trace_phase)):
                return t


def build_population(scenario: FleetScenario) -> List[SimEdge]:
    """Instantiate the scenario's edges, deterministically.

    One master ``random.Random(scenario.seed)`` draws every class/trace/
    SLO assignment, phase offset, and per-edge child seed in a fixed
    order, so the population (and everything downstream of its RNG
    streams) is bit-reproducible per seed. Edges are spread over
    cloudlets round-robin — deterministic, and near-balanced for any
    mix.
    """
    rng = random.Random(scenario.seed)
    edges: List[SimEdge] = []
    for eid in range(scenario.n_edges):
        device = _weighted_pick(scenario.device_mix, rng.random())
        trace_name = _weighted_pick(scenario.trace_mix, rng.random())
        slo = scenario.slo_classes[_slo_pick(scenario.slo_classes,
                                             rng.random())]
        trace = TRACES[trace_name]
        # phase over one trace cycle (or arrival period for terminal
        # traces) — the fleet must not move in lockstep
        span = (trace.duration_s if trace.loop
                else scenario.arrival.period_s)
        if not math.isfinite(span):
            span = scenario.arrival.period_s
        phase = rng.random() * span
        compute, energy = DEVICE_CLASSES[device]
        budget = scenario.battery_for(device)
        child = random.Random(rng.randrange(1 << 32))
        edges.append(SimEdge(
            eid=eid, device_class=device, compute=compute, energy=energy,
            trace=trace, trace_phase=phase, slo=slo, battery_j=budget,
            battery_left_j=budget,
            cloudlet_id=eid % scenario.n_cloudlets, rng=child,
            channel=SimChannel(trace.link_at(0.0), trace=trace)))
    return edges


def _slo_pick(classes: Tuple[SLOClass, ...], u: float) -> int:
    acc = 0.0
    for i, s in enumerate(classes):
        acc += s.share
        if u < acc:
            return i
    return len(classes) - 1
