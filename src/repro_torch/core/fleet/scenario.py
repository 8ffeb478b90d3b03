"""``FleetScenario`` — the serializable description of one simulated
fleet (the plan's optional ``fleet`` section); a copy of the JAX
package's ``core/fleet/scenario.py`` whose ``to_json`` is the same byte
for byte, since it folds into the plan's digest.

A scenario is to the fleet simulator what a ``DeploymentPlan`` is to one
edge/cloud pair: everything needed to reproduce a run, as pure data —
fleet size, the heterogeneous device mix (MCU / Pi / phone classes),
per-class link-trace mix and battery budgets, the diurnal arrival
pattern, the cloudlet tier's size and batching knobs, and the SLO
classes traffic is admitted under. Same scenario + same ``seed`` =>
bit-identical metrics (the determinism contract
``tests/test_fleet.py`` pins down).

The policy types are deliberately *reused*, not forked:

- an ``SLOClass`` wraps a ``FaultPolicy`` — its
  ``request_deadline_s`` is the deadline and its ``fallback`` field is
  the admission controller's degradation semantics (``"edge"`` =>
  degrade to edge-only when the deadline cannot be met
  collaboratively, ``"fail"`` => shed);
- the cloudlet and cloud tiers batch with the ``BatchingPolicy``
  and are priced by ``latency_model.batched_segment_time``;
- per-edge energy is priced through
  ``energy_model.EnergyProfile.request_energy`` — one formula, every
  call site.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

from repro_torch.core.collab.batching import BatchingPolicy
from repro_torch.core.collab.faults import FaultPolicy

#: device classes a scenario may mix (profiles resolved in
#: ``repro_torch.core.fleet.population.DEVICE_CLASSES``)
DEVICE_CLASS_NAMES = ("mcu", "pi", "phone")

#: chaos-event kinds a scenario may schedule against a cloudlet
CHAOS_KINDS = ("kill", "drain", "revive")


def _coerce_floats(obj, *names: str) -> None:
    """Store each named field of the frozen dataclass ``obj`` as a
    ``float``. ``to_json`` folds the field into the plan's digest and
    ``from_json`` reads it back as a float, so an int given here (``30``)
    would save as ``30`` and reload as ``30.0``, and the saved plan would
    fail ``load``'s digest check."""
    for name in names:
        object.__setattr__(obj, name, float(getattr(obj, name)))


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled cloudlet-tier chaos event on the virtual clock —
    the simulator analogue of the serving stack's failover drills.

    ``kind``: ``"kill"`` crashes the cloudlet (queued and in-flight
    work is orphaned and rerouted to the next admitting cloudlet, or
    shed when none is left); ``"drain"`` stops admission for a rolling
    restart (queued work still flushes; new arrivals reroute);
    ``"revive"`` puts the cloudlet back in service. ``cloudlet`` is the
    target index (modulo the scenario's ``n_cloudlets``)."""
    t_s: float
    kind: str
    cloudlet: int = 0

    def __post_init__(self) -> None:
        _coerce_floats(self, "t_s")
        if self.t_s < 0:
            raise ValueError("chaos event t_s must be >= 0")
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"chaos kind must be one of {CHAOS_KINDS}")
        if self.cloudlet < 0:
            raise ValueError("chaos event cloudlet must be >= 0")

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` (the digest-folded form)."""
        return {"t_s": self.t_s, "kind": self.kind,
                "cloudlet": self.cloudlet}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ChaosEvent":
        """Rebuild from its ``to_json`` dict."""
        return cls(t_s=float(d["t_s"]), kind=str(d["kind"]),
                   cloudlet=int(d["cloudlet"]))


@dataclass(frozen=True)
class SLOClass:
    """One service-level class: a share of the traffic and the
    recovery contract it is admitted under.

    ``policy.request_deadline_s`` is the class deadline (seconds);
    ``policy.fallback`` is what the admission controller does when the
    collaborative path cannot meet it: ``"edge"`` degrades the request
    to edge-only execution (the same graceful-degradation semantics
    ``EdgeClient.infer`` applies when its retry budget exhausts),
    ``"fail"`` sheds it.
    """
    name: str
    share: float
    policy: FaultPolicy

    def __post_init__(self) -> None:
        _coerce_floats(self, "share")
        if not 0.0 < self.share <= 1.0:
            raise ValueError("SLO class share must be in (0, 1]")

    @property
    def deadline_s(self) -> float:
        """The class deadline in seconds (the policy's request
        deadline)."""
        return self.policy.request_deadline_s

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` (the digest-folded form)."""
        return {"name": self.name, "share": self.share,
                "policy": self.policy.to_json()}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SLOClass":
        """Rebuild from its ``to_json`` dict."""
        return cls(name=str(d["name"]), share=float(d["share"]),
                   policy=FaultPolicy.from_json(d["policy"]))


#: the default traffic mix: latency-critical scans, ordinary requests,
#: and bulk uploads that tolerate seconds but must not be dropped
DEFAULT_SLO_CLASSES = (
    SLOClass("interactive", 0.30,
             FaultPolicy(request_deadline_s=0.25, fallback="edge",
                         max_retries=0)),
    SLOClass("standard", 0.50,
             FaultPolicy(request_deadline_s=1.0, fallback="edge")),
    SLOClass("bulk", 0.20,
             FaultPolicy(request_deadline_s=10.0, fallback="fail")),
)


@dataclass(frozen=True)
class ArrivalPattern:
    """Seeded inhomogeneous-Poisson arrivals with a diurnal rate.

    Per-edge instantaneous rate at virtual time ``t``::

        rate(t) = base_rate_hz * (1 + diurnal_amplitude
                                  * sin(2*pi * (t + phase) / period_s))

    Each edge draws a seeded ``phase`` so the fleet's load swells and
    ebbs like a day of field traffic instead of moving in lockstep.
    Arrivals are generated by thinning against ``peak_rate_hz``
    (deterministic given the edge's RNG stream).
    """
    base_rate_hz: float = 0.08
    diurnal_amplitude: float = 0.6
    period_s: float = 60.0

    def __post_init__(self) -> None:
        _coerce_floats(self, "base_rate_hz", "diurnal_amplitude", "period_s")
        if self.base_rate_hz <= 0:
            raise ValueError("base_rate_hz must be > 0")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if self.period_s <= 0:
            raise ValueError("period_s must be > 0")

    @property
    def peak_rate_hz(self) -> float:
        """The thinning envelope: the diurnal maximum of ``rate(t)``."""
        return self.base_rate_hz * (1.0 + self.diurnal_amplitude)

    def rate_at(self, t: float, phase: float = 0.0) -> float:
        """Instantaneous per-edge arrival rate (requests/s) at ``t``."""
        return self.base_rate_hz * (
            1.0 + self.diurnal_amplitude
            * math.sin(2.0 * math.pi * (t + phase) / self.period_s))

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` (the digest-folded form)."""
        return {"base_rate_hz": self.base_rate_hz,
                "diurnal_amplitude": self.diurnal_amplitude,
                "period_s": self.period_s}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ArrivalPattern":
        """Rebuild from its ``to_json`` dict."""
        return cls(base_rate_hz=float(d["base_rate_hz"]),
                   diurnal_amplitude=float(d["diurnal_amplitude"]),
                   period_s=float(d["period_s"]))


def _mix_to_json(mix: Tuple[Tuple[str, float], ...]):
    return [[name, share] for name, share in mix]


def _mix_from_json(doc) -> Tuple[Tuple[str, float], ...]:
    return tuple((str(name), float(share)) for name, share in doc)


@dataclass(frozen=True)
class FleetScenario:
    """Everything one fleet simulation needs, as pure data.

    ``device_mix`` / ``trace_mix`` are ``(name, share)`` tuples over the
    registries (``population.DEVICE_CLASSES`` / ``profiles.TRACES``);
    ``battery_j`` gives each device class its per-edge battery budget in
    joules (drained through ``EnergyProfile.request_energy``);
    ``energy_weight_s_per_j`` is the fleet-wide exchange rate of the
    energy-aware split objective (urgency-scaled per edge as its battery
    drains, same formula as the adaptive controller);
    ``cloudlet_batching`` / ``cloud_batching`` are the per-tier dynamic
    batching knobs; ``backhaul_mbps`` / ``backhaul_rtt_ms`` the
    cloudlet->cloud metro link; ``max_queue`` the per-cloudlet admission
    bound (arrivals beyond it are shed at the cloudlet tier);
    ``chaos`` schedules cloudlet kill/drain/revive events on the
    virtual clock (default none — the section serializes only when
    set, so pre-chaos scenario digests are unchanged).
    """
    name: str
    seed: int = 0
    n_edges: int = 1000
    n_cloudlets: int = 8
    duration_s: float = 60.0
    device_mix: Tuple[Tuple[str, float], ...] = (
        ("mcu", 0.25), ("pi", 0.35), ("phone", 0.40))
    trace_mix: Tuple[Tuple[str, float], ...] = (
        ("wifi_steady", 0.40), ("wifi_degrading", 0.20),
        ("lte_handover", 0.20), ("congested_sawtooth", 0.20))
    slo_classes: Tuple[SLOClass, ...] = DEFAULT_SLO_CLASSES
    arrival: ArrivalPattern = field(default_factory=ArrivalPattern)
    battery_j: Tuple[Tuple[str, float], ...] = (
        ("mcu", 40.0), ("pi", 250.0), ("phone", 120.0))
    energy_weight_s_per_j: float = 0.02
    cloudlet_batching: BatchingPolicy = field(
        default_factory=lambda: BatchingPolicy(max_batch=16, max_wait_ms=5.0))
    cloud_batching: BatchingPolicy = field(
        default_factory=lambda: BatchingPolicy(max_batch=64, max_wait_ms=5.0))
    backhaul_mbps: float = 1000.0
    backhaul_rtt_ms: float = 10.0
    max_queue: int = 128
    codec: str = "fp32"
    chaos: Tuple[ChaosEvent, ...] = ()

    def __post_init__(self) -> None:
        _coerce_floats(self, "duration_s", "energy_weight_s_per_j",
                       "backhaul_mbps", "backhaul_rtt_ms")
        for name in ("device_mix", "trace_mix", "battery_j"):
            object.__setattr__(self, name, tuple(
                (key, float(value)) for key, value in getattr(self, name)))
        if self.n_edges < 1 or self.n_cloudlets < 1:
            raise ValueError("n_edges and n_cloudlets must be >= 1")
        if self.duration_s <= 0:
            raise ValueError("duration_s must be > 0")
        for label, mix in (("device_mix", self.device_mix),
                           ("trace_mix", self.trace_mix)):
            if not mix:
                raise ValueError(f"{label} must not be empty")
            total = sum(share for _, share in mix)
            if abs(total - 1.0) > 1e-6:
                raise ValueError(f"{label} shares sum to {total}, not 1")
        for name, _ in self.device_mix:
            if name not in DEVICE_CLASS_NAMES:
                raise ValueError(f"unknown device class {name!r}; expected "
                                 f"one of {DEVICE_CLASS_NAMES}")
        slo_total = sum(s.share for s in self.slo_classes)
        if not self.slo_classes or abs(slo_total - 1.0) > 1e-6:
            raise ValueError(f"SLO class shares sum to {slo_total}, not 1")
        battery = dict(self.battery_j)
        for name, _ in self.device_mix:
            if battery.get(name, 0.0) <= 0:
                raise ValueError(f"device class {name!r} needs a positive "
                                 f"battery_j budget")
        if self.backhaul_mbps <= 0 or self.backhaul_rtt_ms < 0:
            raise ValueError("backhaul needs bandwidth > 0 and rtt >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.energy_weight_s_per_j < 0:
            raise ValueError("energy_weight_s_per_j must be >= 0")
        for ev in self.chaos:
            if not isinstance(ev, ChaosEvent):
                raise ValueError("chaos must hold ChaosEvent entries")

    def battery_for(self, device_class: str) -> float:
        """The per-edge battery budget (joules) of one device class."""
        return dict(self.battery_j)[device_class]

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` — the digest-folded form of the
        plan's ``fleet`` section (keys unit-suffixed where scalar; the
        ``chaos`` list appears only when events are scheduled, so
        pre-chaos digests are byte-for-byte unchanged)."""
        out = {
            "name": self.name, "seed": self.seed,
            "n_edges": self.n_edges, "n_cloudlets": self.n_cloudlets,
            "duration_s": self.duration_s,
            "device_mix": _mix_to_json(self.device_mix),
            "trace_mix": _mix_to_json(self.trace_mix),
            "slo_classes": [s.to_json() for s in self.slo_classes],
            "arrival": self.arrival.to_json(),
            "battery_j": _mix_to_json(self.battery_j),
            "energy_weight_s_per_j": self.energy_weight_s_per_j,
            "cloudlet_batching": self.cloudlet_batching.to_json(),
            "cloud_batching": self.cloud_batching.to_json(),
            "backhaul_mbps": self.backhaul_mbps,
            "backhaul_rtt_ms": self.backhaul_rtt_ms,
            "max_queue": self.max_queue, "codec": self.codec,
        }
        if self.chaos:
            out["chaos"] = [ev.to_json() for ev in self.chaos]
        return out

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "FleetScenario":
        """Rebuild a scenario from its ``to_json`` dict."""
        return cls(
            name=str(d["name"]), seed=int(d["seed"]),
            n_edges=int(d["n_edges"]), n_cloudlets=int(d["n_cloudlets"]),
            duration_s=float(d["duration_s"]),
            device_mix=_mix_from_json(d["device_mix"]),
            trace_mix=_mix_from_json(d["trace_mix"]),
            slo_classes=tuple(SLOClass.from_json(s)
                              for s in d["slo_classes"]),
            arrival=ArrivalPattern.from_json(d["arrival"]),
            battery_j=_mix_from_json(d["battery_j"]),
            energy_weight_s_per_j=float(d["energy_weight_s_per_j"]),
            cloudlet_batching=BatchingPolicy.from_json(
                d["cloudlet_batching"]),
            cloud_batching=BatchingPolicy.from_json(d["cloud_batching"]),
            backhaul_mbps=float(d["backhaul_mbps"]),
            backhaul_rtt_ms=float(d["backhaul_rtt_ms"]),
            max_queue=int(d["max_queue"]), codec=str(d["codec"]),
            chaos=tuple(ChaosEvent.from_json(ev)
                        for ev in d.get("chaos", ())),
        )

    def describe(self) -> str:
        """One-line human summary of the scenario."""
        mix = "/".join(f"{n}:{s:.0%}" for n, s in self.device_mix)
        slo = "/".join(f"{s.name}@{s.deadline_s:g}s"
                       for s in self.slo_classes)
        return (f"FleetScenario[{self.name}] {self.n_edges} edges "
                f"({mix}) -> {self.n_cloudlets} cloudlets -> cloud, "
                f"{self.duration_s:g}s virtual, SLO {slo}, seed "
                f"{self.seed}")
