"""Energy model for the edge device of a split deployment (joules); a
copy of the JAX package's ``core/partition/energy_model.py``, plain Python.

The paper motivates collaborative inference with *both* "inference
latency" and "high energy consumption" on resource-limited embedded
devices, and claims pruning "reduce[s] energy consumption" — yet Eq. 5
prices latency only. This module closes that gap: it prices every
candidate split into a ``(T_total, E_edge)`` pair so the splitter can
optimize a weighted latency·energy objective, report the Pareto front,
and — through the adaptive controller — shift the partition toward the
low-energy end as a battery budget drains.

State machine behind the numbers (one request at split ``c``):

  1. **compute** — layers [0, c) run on the edge SoC for ``T_D`` seconds
     at ``compute_power_w`` (the radio draws its ``idle_power_w``);
  2. **transmit** — the radio spends ``tx_bytes / bandwidth`` seconds in
     the active TX state at ``tx_power_w`` (the SoC has finished; it
     draws ``idle_power_w``);
  3. **wait** — for one RTT plus the cloud's ``T_S`` the SoC idles and
     the radio listens for the logits downlink at ``rx_power_w``.

Every term is therefore a *time x power* product over the same latency
breakdown Eq. 5 produces, which keeps the analytic sweep
(``split_energy`` / ``sweep_splits(energy=...)``) and the runtimes'
per-request accounting (``EnergyProfile.request_energy`` fed with the
measured/modeled ``t_device`` / ``t_tx`` / ``t_server``) numerically
consistent by construction — one formula, two call sites.

Cloud energy is *optionally* priced for completeness
(``cloud_power_w > 0`` adds an ``E_cloud`` column) but never enters the
edge objective: the paper's constraint is the embedded device's battery,
not the datacenter's meter.

All JSON keys carry unit suffixes (``*_power_w`` watts, ``*_j`` joules,
``*_s_per_j`` seconds-per-joule) so they can never collide with the
batching section's power-of-two bucket vocabulary (``buckets``,
``max_batch``) in ``plan.json`` or ``LaneStats`` records.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.partition.latency_model import (LayerCost,
                                                      split_latency)
from repro_torch.core.partition.profiles import TwoTierProfile


@dataclass(frozen=True)
class RadioProfile:
    """Power draw of the edge radio per state (watts).

    ``tx_power_w`` while actively transmitting bytes; ``rx_power_w``
    while listening for / receiving the response; ``idle_power_w`` the
    baseline draw while the SoC computes and the radio merely stays
    associated.
    """
    name: str
    tx_power_w: float
    rx_power_w: float
    idle_power_w: float = 0.0

    def __post_init__(self) -> None:
        if min(self.tx_power_w, self.rx_power_w, self.idle_power_w) < 0:
            raise ValueError("radio power draws must be >= 0 W")


@dataclass(frozen=True)
class EnergyProfile:
    """Per-state power model of one edge device (watts in, joules out).

    ``compute_power_w`` is the SoC's active draw while running edge
    layers; ``idle_power_w`` its draw while blocked on the link/cloud;
    ``radio`` the radio's per-state draws. ``cloud_power_w`` optionally
    prices the server side (reported as ``E_cloud``, never part of the
    edge objective).
    """
    name: str
    compute_power_w: float
    idle_power_w: float
    radio: RadioProfile
    cloud_power_w: float = 0.0

    def __post_init__(self) -> None:
        if min(self.compute_power_w, self.idle_power_w,
               self.cloud_power_w) < 0:
            raise ValueError("power draws must be >= 0 W")

    def energy_breakdown(self, t_device: float, t_tx: float,
                         t_server: float, rtt_s: float = 0.0
                         ) -> Dict[str, float]:
        """Edge energy (joules) of one request from its latency breakdown.

        The single pricing formula shared by the analytic sweep and the
        runtimes' per-request accounting. ``t_tx`` is the uplink term as
        every channel charges it — ``tx_bytes / bandwidth`` *plus one
        RTT* — so the RTT portion is peeled off and billed as waiting
        (SoC idle + radio listening), not as radio-active transmission.

        Returns ``e_comp_j`` / ``e_tx_j`` / ``e_wait_j`` / ``e_edge_j``
        (their sum), all in joules.
        """
        tx_active = max(t_tx - rtt_s, 0.0)
        t_wait = (t_tx - tx_active) + max(t_server, 0.0)
        e_comp = max(t_device, 0.0) * (self.compute_power_w
                                       + self.radio.idle_power_w)
        e_tx = tx_active * self.radio.tx_power_w
        e_wait = t_wait * (self.idle_power_w + self.radio.rx_power_w)
        return {"e_comp_j": e_comp, "e_tx_j": e_tx, "e_wait_j": e_wait,
                "e_edge_j": e_comp + e_tx + e_wait}

    def request_energy(self, t_device: float, t_tx: float, t_server: float,
                       rtt_s: float = 0.0) -> float:
        """Total edge energy of one request (joules) — the scalar the
        sessions report as ``e_edge_j``."""
        return self.energy_breakdown(t_device, t_tx, t_server,
                                     rtt_s)["e_edge_j"]

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` — every key unit-suffixed
        (``*_power_w`` watts)."""
        return {"name": self.name,
                "compute_power_w": self.compute_power_w,
                "idle_power_w": self.idle_power_w,
                "radio": {"name": self.radio.name,
                          "tx_power_w": self.radio.tx_power_w,
                          "rx_power_w": self.radio.rx_power_w,
                          "idle_power_w": self.radio.idle_power_w},
                "cloud_power_w": self.cloud_power_w}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "EnergyProfile":
        return cls(name=d["name"],
                   compute_power_w=float(d["compute_power_w"]),
                   idle_power_w=float(d["idle_power_w"]),
                   radio=RadioProfile(name=d["radio"]["name"],
                                      tx_power_w=float(
                                          d["radio"]["tx_power_w"]),
                                      rx_power_w=float(
                                          d["radio"]["rx_power_w"]),
                                      idle_power_w=float(
                                          d["radio"]["idle_power_w"])),
                   cloud_power_w=float(d.get("cloud_power_w", 0.0)))


# --- canned device energy profiles ------------------------------------------
#: MCU-class embedded board with an on-module Wi-Fi radio (ESP32/Cortex-M
#: class): sub-watt SoC, a radio whose TX burst dwarfs the compute draw —
#: the battery-constrained class the paper's "resource-limited embedded
#: devices" motivation names.
MCU_ENERGY = EnergyProfile(
    "mcu", compute_power_w=0.30, idle_power_w=0.04,
    radio=RadioProfile("wifi-module", tx_power_w=0.80, rx_power_w=0.40,
                       idle_power_w=0.02))
#: Pi-class single-board computer: the SoC dominates the radio, so
#: offloading compute (earlier splits) saves energy even when it ships
#: more bytes.
PI_ENERGY = EnergyProfile(
    "pi", compute_power_w=5.5, idle_power_w=2.2,
    radio=RadioProfile("usb-wifi", tx_power_w=1.3, rx_power_w=0.9,
                       idle_power_w=0.1))
#: Phone-class edge (mid-range smartphone). Calibration: a big.LITTLE
#: SoC under sustained NN load draws ~3-4 W before thermal throttling
#: (compute clusters + LPDDR), idles near ~0.9 W with the screen's
#: share excluded; the Wi-Fi/LTE modem bursts ~1.2 W on TX and ~0.85 W
#: in active RX. Between MCU (radio-dominated) and Pi (SoC-dominated):
#: compute and radio costs are comparable, so the energy-optimal split
#: genuinely moves with the link. Pairs with ``profiles.PHONE_EDGE``.
PHONE_ENERGY = EnergyProfile(
    "phone", compute_power_w=3.5, idle_power_w=0.9,
    radio=RadioProfile("phone-modem", tx_power_w=1.2, rx_power_w=0.85,
                       idle_power_w=0.08))
#: the paper's i7-6700 edge box (mains-powered — energy pricing for
#: completeness, with the 3090 server's draw as E_cloud)
PAPER_EDGE_ENERGY = EnergyProfile(
    "i7-6700", compute_power_w=65.0, idle_power_w=20.0,
    radio=RadioProfile("wifi-nic", tx_power_w=2.5, rx_power_w=1.5,
                       idle_power_w=0.5),
    cloud_power_w=350.0)

ENERGY_PROFILES = {
    "mcu": MCU_ENERGY,
    "pi": PI_ENERGY,
    "phone": PHONE_ENERGY,
    "paper_edge": PAPER_EDGE_ENERGY,
}


def urgency_scaled_weight(weight_s_per_j: float,
                          battery_fraction: Optional[float],
                          floor: float = 1e-3) -> float:
    """The battery-urgency curve shared by the adaptive controller and
    the fleet simulator: the static s/J exchange rate scaled by the
    inverse *square* of the remaining battery fraction (clamped at
    ``floor``). A full battery optimizes latency; at half charge the
    device already pays 4x more seconds per joule saved — the walk
    toward the low-energy splits happens while meaningful budget
    remains, not at exhaustion. ``battery_fraction=None`` (unmetered)
    returns the static weight unchanged."""
    if battery_fraction is None:
        return weight_s_per_j
    return weight_s_per_j / max(battery_fraction, floor) ** 2


@dataclass(frozen=True)
class EnergyPolicy:
    """Serializable energy knobs (the plan's ``energy`` section).

    ``profile`` is the edge device's power model;
    ``energy_weight_s_per_j`` the exchange rate of the weighted
    objective ``score = latency_weight * T + energy_weight_s_per_j *
    E_edge`` (0 keeps the latency-only paper objective while still
    *reporting* joules); ``battery_j`` an optional remaining-energy
    budget — when set, the adaptive controller scales the energy weight
    up as the battery drains, shifting the partition toward the
    low-energy end of the Pareto front before the budget runs out.
    """
    profile: EnergyProfile
    latency_weight: float = 1.0
    energy_weight_s_per_j: float = 0.0
    battery_j: Optional[float] = None

    def __post_init__(self) -> None:
        if self.latency_weight < 0 or self.energy_weight_s_per_j < 0:
            raise ValueError("objective weights must be >= 0")
        if self.battery_j is not None and not self.battery_j > 0:
            raise ValueError("battery_j must be > 0 joules when set")

    def score(self, row: Dict[str, float],
              energy_weight: Optional[float] = None) -> float:
        """Weighted latency·energy objective of one priced sweep row
        (seconds-equivalents; lower is better). ``energy_weight``
        overrides the static knob — the battery-aware controller passes
        its urgency-scaled weight here."""
        w = (self.energy_weight_s_per_j if energy_weight is None
             else energy_weight)
        return self.latency_weight * row["T"] + w * row["E_edge"]

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` (the digest-folded form): watts
        inside ``profile``, ``battery_j`` joules, the weight in s/J."""
        return {"profile": self.profile.to_json(),
                "latency_weight": self.latency_weight,
                "energy_weight_s_per_j": self.energy_weight_s_per_j,
                "battery_j": self.battery_j}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "EnergyPolicy":
        return cls(profile=EnergyProfile.from_json(d["profile"]),
                   latency_weight=float(d["latency_weight"]),
                   energy_weight_s_per_j=float(d["energy_weight_s_per_j"]),
                   battery_j=(None if d.get("battery_j") is None
                              else float(d["battery_j"])))


def price_energy(row: Dict[str, float], energy: EnergyProfile,
                 rtt_s: float) -> Dict[str, float]:
    """Add the energy columns to one Eq. 5 latency row *in place* style:
    returns a new dict with ``E_comp``/``E_tx``/``E_wait``/``E_edge``
    (joules) — and ``E_cloud`` when the profile prices the server —
    derived from the row's ``T_D``/``T_TX``/``T_S``."""
    br = energy.energy_breakdown(row["T_D"], row["T_TX"], row["T_S"],
                                 rtt_s=rtt_s)
    out = dict(row, E_comp=br["e_comp_j"], E_tx=br["e_tx_j"],
               E_wait=br["e_wait_j"], E_edge=br["e_edge_j"])
    if energy.cloud_power_w > 0:
        out["E_cloud"] = row["T_S"] * energy.cloud_power_w
    return out


def split_energy(costs: Sequence[LayerCost], c: int,
                 profile: TwoTierProfile, energy: EnergyProfile,
                 input_bytes: float, tx_scale: float = 1.0,
                 **latency_kw) -> Dict[str, float]:
    """Eq. 5 latency breakdown at split ``c`` plus its edge energy
    (joules): the ``(T_total, E_edge)`` pair of one candidate split.
    Extra keyword arguments are forwarded to ``split_latency``."""
    row = split_latency(costs, c, profile, input_bytes, tx_scale=tx_scale,
                        **latency_kw)
    return price_energy(row, energy, profile.link.rtt_s)


def pareto_front(table: Sequence[Dict[str, float]], t_key: str = "T",
                 e_key: str = "E_edge") -> List[Dict[str, float]]:
    """Non-dominated (latency, energy) rows of a priced sweep table,
    sorted by ascending latency (``T`` seconds, ``E_edge`` joules).

    A row is kept iff no other row is at least as good on both axes and
    strictly better on one. Along the returned front, latency increases
    monotonically while energy strictly decreases — the menu of
    operating points the weighted objective (or a battery-aware
    controller) picks from.
    """
    rows = sorted(table, key=lambda r: (r[t_key], r[e_key]))
    front: List[Dict[str, float]] = []
    best_e = float("inf")
    for r in rows:
        if r[e_key] < best_e:
            front.append(r)
            best_e = r[e_key]
    return front
