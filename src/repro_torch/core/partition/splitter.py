"""Split-point selection — Algorithm 1, lines 20-27 (the greedy argmin of
Eq. 5 over every candidate split), from the JAX package's
``core/partition/splitter.py``.

``balanced_split`` (beyond the paper) minimizes max(T_D, T_TX, T_S) — the
steady-state bottleneck when requests stream and device, link and server
overlap. ``energy_aware_split`` minimizes the weighted latency·energy
objective of an ``EnergyPolicy`` (``core.partition.energy_model``): handed
an ``EnergyProfile``, ``sweep_splits`` prices every candidate into a
``(T_total, E_edge)`` pair, and ``pareto_front`` reports the non-dominated
menu. ``joint_two_stage`` wires Eq. 6's two-stage decomposition: DDPG
pruning first, then the split sweep on the pruned network."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.partition.energy_model import (EnergyPolicy,
                                                     EnergyProfile,
                                                     pareto_front,
                                                     price_energy)
from repro_torch.core.partition.latency_model import LayerCost, split_latency
from repro_torch.core.partition.profiles import TwoTierProfile

__all__ = ["SplitDecision", "sweep_splits", "greedy_split",
           "balanced_split", "energy_aware_split", "pareto_front",
           "joint_two_stage"]


@dataclass
class SplitDecision:
    split_point: int
    latency: Dict[str, float]
    table: List[Dict[str, float]]     # per-candidate breakdown (paper Table 2)


def sweep_splits(costs: Sequence[LayerCost], profile: TwoTierProfile,
                 input_bytes: float,
                 measured_device_s: Optional[Sequence[float]] = None,
                 measured_server_s: Optional[Sequence[float]] = None,
                 candidates: Optional[Sequence[int]] = None,
                 tx_scale: Union[float, Callable[[int], float]] = 1.0,
                 round_trip: bool = False,
                 energy: Optional[EnergyProfile] = None
                 ) -> List[Dict[str, float]]:
    """Eq. 5 at every candidate split. ``tx_scale`` may be a callable
    ``split -> scale`` (``wire_tx_scale``), since the packing discount
    depends on which channels survive at each boundary. Measured
    per-layer seconds replace the analytic device / server terms when
    given. With an ``energy`` profile every row also carries
    ``E_comp``/``E_tx``/``E_wait``/``E_edge`` in joules (and ``E_cloud``
    when the profile prices the server)."""
    n = len(costs)
    cands = list(candidates) if candidates is not None else list(range(n + 1))
    table = []
    for c in cands:
        scale = tx_scale(c) if callable(tx_scale) else tx_scale
        row = split_latency(costs, c, profile, input_bytes,
                            measured_device_s, measured_server_s,
                            tx_scale=scale, round_trip=round_trip)
        row["split"] = c
        if energy is not None:
            row = price_energy(row, energy, profile.link.rtt_s)
        table.append(row)
    return table


def greedy_split(costs: Sequence[LayerCost], profile: TwoTierProfile,
                 input_bytes: float, **kw) -> SplitDecision:
    """Algorithm 1 lines 20-27: T_min = T(G',1); for j=2..N keep argmin."""
    table = sweep_splits(costs, profile, input_bytes, **kw)
    best = min(table, key=lambda r: r["T"])
    return SplitDecision(int(best["split"]), best, table)


def balanced_split(costs: Sequence[LayerCost], profile: TwoTierProfile,
                   input_bytes: float, **kw) -> SplitDecision:
    """Beyond-paper: minimize the pipeline bottleneck max(T_D, T_TX, T_S)."""
    table = sweep_splits(costs, profile, input_bytes, **kw)
    best = min(table, key=lambda r: max(r["T_D"], r["T_TX"], r["T_S"]))
    return SplitDecision(int(best["split"]), best, table)


def energy_aware_split(costs: Sequence[LayerCost], profile: TwoTierProfile,
                       input_bytes: float, policy: EnergyPolicy,
                       energy_weight: Optional[float] = None,
                       **kw) -> SplitDecision:
    """Argmin of ``latency_weight * T + energy_weight_s_per_j * E_edge``
    over the candidate splits (Eq. 5 extended with the device's joules).
    A zero energy weight gives the paper's greedy latency argmin (with
    the energy columns still reported); ``energy_weight`` overrides the
    policy's static knob (the battery-aware controller passes its
    urgency-scaled weight). The table's rows carry ``T`` (seconds) and
    ``E_edge`` (joules), ready for ``pareto_front``."""
    table = sweep_splits(costs, profile, input_bytes,
                         energy=policy.profile, **kw)
    best = min(table, key=lambda r: policy.score(r, energy_weight))
    return SplitDecision(int(best["split"]), best, table)


def joint_two_stage(search_pruning: Callable[[], Sequence[float]],
                    costs_for_ratios: Callable[[Sequence[float]],
                                               Sequence[LayerCost]],
                    profile: TwoTierProfile, input_bytes: float,
                    mode: str = "greedy") -> Dict:
    """Eq. 6 two-stage solver: S* from DRL, then c* from the split sweep."""
    ratios = list(search_pruning())
    costs = costs_for_ratios(ratios)
    split = (greedy_split if mode == "greedy" else balanced_split)(
        costs, profile, input_bytes)
    return {"ratios": ratios, "split": split}
