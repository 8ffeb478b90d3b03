"""Adaptive split control under time-varying wireless links (a copy of
the JAX package's ``core/collab/adaptive.py``, plain Python).

The paper's Algorithm 1 picks the split once, for the bandwidth measured
at deployment time. A *wireless* link does not hold still — the edge
device roams, the cell hands over, the evening uplink congests — and the
greedy optimum moves with it. This module closes the loop at run time:

  * ``BandwidthEstimator`` — an EWMA over the per-request uplink
    observations every executor already produces (``tx_bytes`` payload
    size and ``t_tx`` transmission wall-clock), yielding a running
    estimate of the link the deployment is *actually* experiencing;
  * ``AdaptiveSplitController`` — re-runs the Eq. 5 greedy sweep
    (``sweep_splits``) against the measured link over the plan's
    candidate splits and emits a ``SplitSwitch`` decision, guarded by
    hysteresis (a switch must promise a minimum relative improvement)
    and a dwell period (minimum requests between switches) so estimator
    noise cannot make the partition flap;
  * ``AdaptivePolicy`` — the serializable knobs of the above, carried in
    ``DeploymentPlan.adaptive`` and folded into the plan digest so both
    peers agree on the candidate set before the first RESPLIT frame.

Execution of a switch lives in the runtimes: ``CollabRunner.set_split``
(in-process) and ``EdgeClient.resplit`` (RESPLIT control frame on the
live socket); ``repro_torch.serving`` wires observation -> decision -> switch
per request.

**Battery-aware re-planning** (the energy subsystem's control hook): a
controller built with an ``EnergyPolicy`` prices every sweep row into a
``(T, E_edge)`` pair and scores candidates with the weighted
latency·energy objective instead of raw latency. When the policy
carries a ``battery_j`` budget, each request's reported ``e_edge_j``
drains it (``drain``), and the effective energy weight scales with
*urgency* — the inverse square of the remaining battery fraction — so
a full battery optimizes latency and a draining one walks the Pareto
front toward the low-energy splits (typically earlier splits on
compute-dominated devices: offload more, burn less) while meaningful
budget remains. Same hysteresis + dwell guards apply, on the scored
objective.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs.base import CNNConfig
from repro_torch.core.partition.energy_model import (EnergyPolicy,
                                                     urgency_scaled_weight)
from repro_torch.core.partition.latency_model import (
    cnn_input_bytes, cnn_layer_costs, compacted_cnn_layer_costs,
    wire_tx_scale)
from repro_torch.core.partition.profiles import LinkProfile, TwoTierProfile
from repro_torch.core.partition.splitter import sweep_splits


@dataclass(frozen=True)
class AdaptivePolicy:
    """Serializable adaptive-split knobs (the plan's ``adaptive`` section).

    ``candidates`` are the split points both peers pre-arm in their
    ``SplitFnBank``; ``ewma_alpha``/``min_samples`` shape the bandwidth
    estimator; ``hysteresis`` is the minimum relative latency improvement
    a switch must promise (0.1 = predicted T at the new split must be at
    least 10% below the current split's predicted T); ``dwell`` is the
    minimum number of requests between switches.
    """
    candidates: Tuple[int, ...]
    ewma_alpha: float = 0.4
    min_samples: int = 2
    hysteresis: float = 0.1
    dwell: int = 3

    def __post_init__(self) -> None:
        if not self.candidates:
            raise ValueError("AdaptivePolicy needs at least one candidate "
                             "split")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")

    def to_json(self) -> Dict[str, Any]:
        """Serialize for ``plan.json`` (the digest-folded form)."""
        return {"candidates": [int(c) for c in self.candidates],
                "ewma_alpha": self.ewma_alpha,
                "min_samples": self.min_samples,
                "hysteresis": self.hysteresis, "dwell": self.dwell}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "AdaptivePolicy":
        return cls(candidates=tuple(int(c) for c in d["candidates"]),
                   ewma_alpha=d["ewma_alpha"],
                   min_samples=d["min_samples"],
                   hysteresis=d["hysteresis"], dwell=d["dwell"])


class BandwidthEstimator:
    """EWMA uplink-bandwidth estimate from per-request (bytes, seconds).

    Each observation is one transmitted feature frame: ``tx_bytes``
    payload over ``t_tx`` wall-clock. The configured ``rtt_s`` is
    subtracted before dividing, since the per-send cost every channel
    charges is ``bytes/bandwidth + rtt``.

    EWMA state is lock-guarded: the serving loop's observation path and
    an outage report from a recovery thread may race (``serve_cloud``
    handlers and ``EdgeClient`` worker threads both feed controllers).
    """

    def __init__(self, alpha: float = 0.4, min_samples: int = 2,
                 rtt_s: float = 0.0):
        self.alpha = alpha
        self.min_samples = max(1, min_samples)
        self.rtt_s = rtt_s
        self.n_samples = 0
        self._ewma: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, tx_bytes: float, t_tx: float) -> None:
        """Feed one uplink observation (payload bytes over send
        seconds); edge-only requests (no uplink) are ignored."""
        if tx_bytes <= 0 or t_tx <= 0:
            return                       # edge-only request: no uplink signal
        sample = tx_bytes / max(t_tx - self.rtt_s, 1e-9)
        with self._lock:
            self._ewma = (sample if self._ewma is None else
                          self.alpha * sample
                          + (1 - self.alpha) * self._ewma)
            self.n_samples += 1

    #: bytes/s an outage forces the estimate to — effectively "link dead"
    #: (≈1 kbit/s) without dividing by zero anywhere downstream.
    OUTAGE_BANDWIDTH = 125.0

    def note_outage(self) -> None:
        """Collapse the estimate to ``OUTAGE_BANDWIDTH`` (link presumed
        dead) and mark the estimator ready, so the very next controller
        decision sees bandwidth→0 instead of the stale pre-outage EWMA.
        Subsequent healthy observations pull the EWMA back up at the
        usual ``alpha`` rate — that is the heal-back path."""
        with self._lock:
            self._ewma = self.OUTAGE_BANDWIDTH
            self.n_samples = max(self.n_samples, self.min_samples)

    @property
    def ready(self) -> bool:
        return self.n_samples >= self.min_samples

    @property
    def bandwidth(self) -> Optional[float]:
        """Estimated uplink bytes/s, or None before the first sample."""
        return self._ewma


@dataclass
class SplitSwitch:
    """One re-split decision, for logs and benchmark tables."""
    request_index: int
    old_split: int
    new_split: int
    est_bandwidth: float            # bytes/s the decision was based on
    current_T: float                # predicted Eq. 5 latency, old split
    predicted_T: float              # predicted Eq. 5 latency, new split
    current_E: Optional[float] = None    # predicted edge joules, old split
    predicted_E: Optional[float] = None  # predicted edge joules, new split
    battery_j: Optional[float] = None    # remaining budget at decision time

    def describe(self) -> str:
        """One-line human summary (ms, Mbps, mJ, remaining joules)."""
        energy = ""
        if self.predicted_E is not None:
            energy = (f", {self.current_E * 1e3:.1f} -> "
                      f"{self.predicted_E * 1e3:.1f} mJ")
            if self.battery_j is not None:
                energy += f", battery {self.battery_j * 1e3:.1f} mJ"
        return (f"resplit c={self.old_split}->{self.new_split} at request "
                f"{self.request_index} (est link "
                f"{self.est_bandwidth * 8 / 1e6:.1f} Mbps, predicted "
                f"{self.current_T * 1e3:.1f} -> "
                f"{self.predicted_T * 1e3:.1f} ms{energy})")


class AdaptiveSplitController:
    """Observation -> greedy re-sweep -> hysteresis-guarded switch.

    ``step(tx_bytes, t_tx)`` is the per-request entry point: feed the
    uplink observation, get back a ``SplitSwitch`` when the measured link
    has drifted far enough that a different candidate split wins by more
    than the hysteresis margin (and the dwell period has passed), else
    ``None``. The caller executes the switch (``CollabRunner.set_split``
    / ``EdgeClient.resplit``) — the controller only decides.

    Decision state (``split``, ``battery_j``, request/dwell counters) is
    lock-guarded: the request path and an outage report from a recovery
    thread may mutate it concurrently.
    """

    def __init__(self, costs, profile: TwoTierProfile, input_bytes: float,
                 policy: AdaptivePolicy, split: int, tx_scale=1.0,
                 energy: Optional[EnergyPolicy] = None):
        if split not in policy.candidates:
            raise ValueError(f"initial split {split} not among the "
                             f"candidates {policy.candidates}")
        self.costs = costs
        self.profile = profile
        self.input_bytes = input_bytes
        self.policy = policy
        self.split = split
        self.tx_scale = tx_scale            # scalar or callable(split)
        self.energy = energy
        #: remaining battery budget in joules (None = unmetered)
        self.battery_j = energy.battery_j if energy is not None else None
        self._battery_j_init = self.battery_j
        self.estimator = BandwidthEstimator(policy.ewma_alpha,
                                            policy.min_samples,
                                            rtt_s=profile.link.rtt_s)
        self.n_requests = 0
        self._since_switch = 0
        self.history: List[SplitSwitch] = []
        self._lock = threading.Lock()

    @classmethod
    def for_deployment(cls, cfg: CNNConfig, policy: AdaptivePolicy,
                       split: int, profile: TwoTierProfile, masks=None,
                       compact: bool = False, codec: Optional[str] = None,
                       pack: bool = False,
                       energy: Optional[EnergyPolicy] = None
                       ) -> "AdaptiveSplitController":
        """Build the controller for a concrete deployment: layer costs
        priced on the deployed (compacted/masked) shapes and a
        per-candidate ``wire_tx_scale`` so predicted T_TX matches what the
        runtime will actually put on the wire at each candidate.
        ``energy`` (the plan's ``energy`` section) arms the battery-aware
        weighted objective."""
        costs = (compacted_cnn_layer_costs(cfg, masks) if compact
                 else cnn_layer_costs(cfg, masks))
        return cls(costs, profile, cnn_input_bytes(cfg), policy, split,
                   tx_scale=lambda c: wire_tx_scale(
                       cfg, masks, c, codec=codec, pack=pack,
                       compact=compact),
                   energy=energy)

    # -- battery accounting --------------------------------------------------
    @property
    def battery_fraction(self) -> Optional[float]:
        """Remaining battery as a fraction of the configured budget
        (None when the deployment is unmetered)."""
        if self.battery_j is None or not self._battery_j_init:
            return None
        return max(self.battery_j, 0.0) / self._battery_j_init

    @property
    def effective_energy_weight(self) -> float:
        """The s/J exchange rate the scorer uses *right now*: the
        policy's static knob, scaled by battery urgency — the inverse
        *square* of the remaining fraction — when a ``battery_j``
        budget is armed. A full battery optimizes latency; at half
        charge the device already pays 4x more seconds per joule saved,
        so the walk toward the low-energy splits happens while there is
        still meaningful budget left, not at the moment of exhaustion.
        The curve itself is ``energy_model.urgency_scaled_weight`` —
        one formula shared with the fleet simulator's per-edge split
        decisions."""
        if self.energy is None:
            return 0.0
        return urgency_scaled_weight(self.energy.energy_weight_s_per_j,
                                     self.battery_fraction)

    def drain(self, e_edge_j: Optional[float]) -> None:
        """Subtract one request's measured edge energy from the battery
        budget (no-op when unmetered or the request reported no energy)."""
        if e_edge_j is None:
            return
        with self._lock:
            if self.battery_j is not None:
                self.battery_j = max(self.battery_j - e_edge_j, 0.0)

    def observe(self, tx_bytes: float, t_tx: float,
                e_edge_j: Optional[float] = None) -> None:
        """Record one request: uplink observation (bytes, seconds) for
        the bandwidth estimator, measured edge joules for the battery
        budget, and the dwell counter."""
        self.estimator.observe(tx_bytes, t_tx)
        self.drain(e_edge_j)
        with self._lock:
            self.n_requests += 1
            self._since_switch += 1

    def note_outage(self) -> Optional[SplitSwitch]:
        """React to a cloud outage (a request that fell back to
        edge-only after exhausting its retry budget): collapse the
        bandwidth estimate to ~zero, waive the dwell guard, and decide
        immediately — on a dead uplink the sweep's T_TX term dominates
        every offloading candidate, so the winner is the latest
        candidate split (c=N when armed: pure edge, zero wire bytes).
        Healing is symmetric: once requests flow again, their healthy
        uplink observations pull the EWMA back up and ``step`` re-splits
        toward offloading through the normal hysteresis/dwell guards."""
        self.estimator.note_outage()
        with self._lock:
            self._since_switch = self.policy.dwell
        return self.maybe_switch()

    def note_congestion(self) -> Optional[SplitSwitch]:
        """React to fleet backpressure (a request that had to migrate
        after a BUSY shed): waive the dwell guard and re-decide at the
        *current* bandwidth estimate. Unlike ``note_outage`` this does
        not collapse the estimator — the link is healthy, the cloud
        tier is the bottleneck — it just lets the controller answer the
        congestion signal immediately instead of waiting out the dwell
        window."""
        with self._lock:
            self._since_switch = self.policy.dwell
        return self.maybe_switch()

    def note_external_switch(self, split: int) -> None:
        """Adopt a split executed outside the controller (a manual
        ``resplit``) and restart the dwell window, so the controller does
        not immediately overrule the override on the next request."""
        with self._lock:
            self.split = split
            self._since_switch = 0

    def sweep(self, bandwidth: float) -> List[Dict[str, float]]:
        """The Eq. 5 greedy sweep over the candidates at ``bandwidth``,
        energy-priced (``E_edge`` joules per row) when the controller
        carries an ``EnergyPolicy``."""
        link = LinkProfile(f"measured {bandwidth * 8 / 1e6:.1f} Mbps",
                           bandwidth=bandwidth,
                           rtt_s=self.profile.link.rtt_s)
        prof = TwoTierProfile(self.profile.device, self.profile.server,
                              link)
        return sweep_splits(self.costs, prof, self.input_bytes,
                            candidates=self.policy.candidates,
                            tx_scale=self.tx_scale,
                            energy=(self.energy.profile
                                    if self.energy is not None else None))

    def _score(self, row: Dict[str, float]) -> float:
        """Objective of one sweep row: plain Eq. 5 latency, or the
        battery-urgency-weighted latency·energy score."""
        if self.energy is None:
            return row["T"]
        return self.energy.score(row, self.effective_energy_weight)

    def maybe_switch(self) -> Optional[SplitSwitch]:
        """Decide (but do not execute) a split switch: re-sweep at the
        estimated bandwidth, apply the objective (latency or
        battery-weighted latency·energy), guard with hysteresis and
        dwell; returns the ``SplitSwitch`` or None."""
        if not self.estimator.ready or self._since_switch < self.policy.dwell:
            return None
        bw = self.estimator.bandwidth
        table = self.sweep(bw)
        best = min(table, key=self._score)
        cur = next(r for r in table if r["split"] == self.split)
        if best["split"] == self.split:
            return None
        if self._score(best) > (1.0 - self.policy.hysteresis) \
                * self._score(cur):
            return None                  # not enough predicted win: hold
        sw = SplitSwitch(self.n_requests, self.split, int(best["split"]),
                         bw, cur["T"], best["T"],
                         current_E=cur.get("E_edge"),
                         predicted_E=best.get("E_edge"),
                         battery_j=self.battery_j)
        with self._lock:
            self.split = sw.new_split
            self._since_switch = 0
            self.history.append(sw)
        return sw

    def step(self, tx_bytes: float, t_tx: float,
             e_edge_j: Optional[float] = None) -> Optional[SplitSwitch]:
        """Feed one request's uplink observation (and, on an
        energy-metered deployment, its measured edge joules — it drains
        the battery budget); maybe decide a switch."""
        self.observe(tx_bytes, t_tx, e_edge_j)
        return self.maybe_switch()
