"""Fleet metrics: per-request records in, one flat rollup out (a copy of
the JAX package's ``core/fleet/metrics.py``).

The rollup is the BENCH_fleet.json payload — every key unit-suffixed
per the bench-record convention, every value derived from the virtual
clock and the analytic models. No wall-clock second ever lands here:
two runs of the same scenario seed must produce byte-identical
rollups, and the determinism regression test holds us to it.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.fleet.scenario import FleetScenario
from repro_torch.core.fleet.tiers import TierStats


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]) — pure
    Python so the rollup never depends on numpy float modes."""
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class RequestRecord:
    """One finished (or shed) request, as the simulator saw it."""
    slo: str
    route: str                    # "collab" | "edge" | "shed"
    shed_reason: str = ""         # "battery" | "deadline" | "queue"
    latency_s: float = 0.0        # virtual-clock end-to-end, served only
    deadline_s: float = 0.0
    e_edge_j: float = 0.0
    tx_bytes: float = 0.0
    device_class: str = ""


@dataclass
class FleetMetrics:
    """Accumulates ``RequestRecord``s and rolls them up."""
    scenario: FleetScenario
    records: List[RequestRecord] = field(default_factory=list)
    chaos_reroutes: int = 0

    def add(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    def note_reroute(self) -> None:
        """Count one chaos reroute (a request moved off a dead or
        draining cloudlet to another admitting one)."""
        self.chaos_reroutes += 1

    # -- rollup -------------------------------------------------------------
    def rollup(self, cloudlet_stats: List[TierStats],
               cloud_stats: TierStats,
               exhausted_edges: int = 0) -> Dict[str, float]:
        """The flat, unit-suffixed summary dict for BENCH_fleet.json.

        Served = collab + degraded-edge; deadline attainment is judged
        over *arrivals* (a shed request is a missed deadline — hiding
        sheds from the denominator would let the admission controller
        game its own scoreboard).
        """
        recs = self.records
        served = [r for r in recs if r.route != "shed"]
        lat = [r.latency_s for r in served]
        met = sum(1 for r in served if r.latency_s <= r.deadline_s)
        n = len(recs)
        out: Dict[str, float] = {
            "n_edges": self.scenario.n_edges,
            "n_cloudlets": self.scenario.n_cloudlets,
            "sim_duration_s": self.scenario.duration_s,
            "seed": self.scenario.seed,
            "arrivals": n,
            "served": len(served),
            "served_collab": sum(1 for r in recs if r.route == "collab"),
            "served_edge_only": sum(1 for r in recs if r.route == "edge"),
            "shed": sum(1 for r in recs if r.route == "shed"),
            "shed_frac": _frac(sum(1 for r in recs if r.route == "shed"), n),
            "shed_battery_frac": _frac(
                sum(1 for r in recs if r.shed_reason == "battery"), n),
            "shed_deadline_frac": _frac(
                sum(1 for r in recs if r.shed_reason == "deadline"), n),
            "shed_queue_frac": _frac(
                sum(1 for r in recs if r.shed_reason == "queue"), n),
            "deadline_met_frac": _frac(met, n),
            "latency_p50_s": percentile(lat, 50),
            "latency_p99_s": percentile(lat, 99),
            "latency_mean_s": (sum(lat) / len(lat)) if lat else 0.0,
            "edge_joules_per_request": (
                sum(r.e_edge_j for r in served) / len(served)
                if served else 0.0),
            "uplink_mb_total": sum(r.tx_bytes for r in recs) / 1e6,
            "exhausted_edges": exhausted_edges,
            "chaos_reroutes_count": self.chaos_reroutes,
        }
        # per-SLO-class attainment and tails
        by_slo: Dict[str, List[RequestRecord]] = defaultdict(list)
        for r in recs:
            by_slo[r.slo].append(r)
        for cls in self.scenario.slo_classes:
            rs = by_slo.get(cls.name, [])
            sv = [r for r in rs if r.route != "shed"]
            ls = [r.latency_s for r in sv]
            k = cls.name
            out[f"{k}_arrivals"] = len(rs)
            out[f"{k}_deadline_met_frac"] = _frac(
                sum(1 for r in sv if r.latency_s <= r.deadline_s), len(rs))
            out[f"{k}_shed_frac"] = _frac(
                sum(1 for r in rs if r.route == "shed"), len(rs))
            out[f"{k}_latency_p50_s"] = percentile(ls, 50)
            out[f"{k}_latency_p99_s"] = percentile(ls, 99)
        # per-tier utilization / batching efficiency
        dur = self.scenario.duration_s
        cl_busy = sum(s.busy_s for s in cloudlet_stats)
        out.update({
            "cloudlet_util": _frac(cl_busy, dur * max(len(cloudlet_stats),
                                                      1)),
            "cloudlet_rows": sum(s.rows for s in cloudlet_stats),
            "cloudlet_batches": sum(s.batches for s in cloudlet_stats),
            "cloudlet_avg_batch": _frac(
                sum(s.rows for s in cloudlet_stats),
                sum(s.batches for s in cloudlet_stats)),
            "cloudlet_padding_waste": _frac(
                sum(s.padded_rows for s in cloudlet_stats),
                sum(s.rows + s.padded_rows for s in cloudlet_stats)),
            "cloudlet_max_queue": max(
                (s.max_queue for s in cloudlet_stats), default=0),
            "cloudlet_mean_queue": _frac(
                sum(s.queue_sum for s in cloudlet_stats),
                sum(s.queue_samples for s in cloudlet_stats)),
            "cloud_util": _frac(cloud_stats.busy_s, dur),
            "cloud_rows": cloud_stats.rows,
            "cloud_batches": cloud_stats.batches,
            "cloud_avg_batch": cloud_stats.avg_batch,
            "cloud_padding_waste": cloud_stats.padding_waste,
            "cloud_max_queue": cloud_stats.max_queue,
            "cloud_mean_queue": cloud_stats.mean_queue,
        })
        return out


def _frac(num: float, den: float) -> float:
    return num / den if den else 0.0
