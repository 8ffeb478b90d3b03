"""Split-point selection — Algorithm 1, lines 20-27 (the greedy argmin of
Eq. 5 over every candidate split), from the JAX package's
``core/partition/splitter.py``.

``balanced_split`` (beyond the paper) minimizes max(T_D, T_TX, T_S) — the
steady-state bottleneck when requests stream and device, link and server
overlap. ``joint_two_stage`` wires Eq. 6's two-stage decomposition: DDPG
pruning first, then the split sweep on the pruned network. The
energy-aware objective comes with the energy slice."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.partition.latency_model import LayerCost, split_latency
from repro_torch.core.partition.profiles import TwoTierProfile


@dataclass
class SplitDecision:
    split_point: int
    latency: Dict[str, float]
    table: List[Dict[str, float]]     # per-candidate breakdown (paper Table 2)


def sweep_splits(costs: Sequence[LayerCost], profile: TwoTierProfile,
                 input_bytes: float,
                 candidates: Optional[Sequence[int]] = None,
                 tx_scale: Union[float, Callable[[int], float]] = 1.0,
                 round_trip: bool = False) -> List[Dict[str, float]]:
    """Eq. 5 at every candidate split. ``tx_scale`` may be a callable
    ``split -> scale`` (``wire_tx_scale``), since the packing discount
    depends on which channels survive at each boundary."""
    n = len(costs)
    cands = list(candidates) if candidates is not None else list(range(n + 1))
    table = []
    for c in cands:
        scale = tx_scale(c) if callable(tx_scale) else tx_scale
        row = split_latency(costs, c, profile, input_bytes,
                            tx_scale=scale, round_trip=round_trip)
        row["split"] = c
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
