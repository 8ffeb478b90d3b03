"""Hardware profiles for the latency model.

Tier A (paper-faithful): the paper's own testbed — an i7-6700 edge box, a
Ryzen+RTX-3090 server, ~50 Mbps Wi-Fi (§4.1-4.2). Effective throughputs are
calibrated, not peak: CNN inference on a 4-core desktop CPU sustains a few
tens of GFLOP/s; a 3090 on small-batch CNN inference sustains a low-single-
digit fraction of its 35.6 TFLOP/s peak because AlexNet layers are tiny.

Time-varying links: a ``LinkProfile`` is a point-in-time snapshot; a
``LinkTrace`` is a piecewise-constant schedule of (bandwidth, RTT) over
elapsed time — the wireless reality the paper's title promises, where the
split picked at deployment time stops being optimal mid-run. The collab
channels (``SimChannel``/``ShapedSocket``) replay a trace per transmitted
byte, and the adaptive controller re-plans from what they charge.

Fault schedules: a ``LinkTrace`` degrades the link; a ``FaultSchedule``
*breaks* it — deterministic, seedable sequences of frame drops, byte
corruption, stalls, mid-stream disconnects, and cloud-process death,
indexed by transmission-attempt number so every failure mode is exactly
reproducible in tests and benchmarks. The collab channels replay a
schedule through a ``FaultInjector`` (``repro_torch.core.collab.channel``);
the recovery machinery that survives one lives in
``repro_torch.core.collab.faults``.

The batched 3090 and the Jetson-class cloudlet are the fleet simulator's
modelled tiers (``repro_torch.core.fleet``). ``H100_CARD`` is the one card
this port runs on, priced from ``repro_torch.roofline.hw``'s data-sheet
peaks. Tier B, a transformer split across two tiers of H100 cards, has
its own profiles (``H100_TWO_NODE``, ``H100_EDGE_CLOUD``): nodes and a
cluster priced from the same peaks, joined by data-sheet network rates.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.roofline import hw


@dataclass(frozen=True)
class ComputeProfile:
    name: str
    flops_per_s: float          # sustained fp32
    mem_bw: float               # bytes/s
    overhead_s: float = 0.0     # per-invocation constant (kernel launch etc.)
    #: sustained int8 MAC throughput (ops/s) for quantized-kernel
    #: roofline pricing; None -> the 4x-fp32 SIMD default
    #: (``int8_ops_per_s``). Edge CPUs gain far more than 4x when their
    #: fp32 path is soft-float (MCU class), so the edge profiles pin it.
    int8_flops_per_s: Optional[float] = None

    @property
    def int8_ops_per_s(self) -> float:
        return self.int8_flops_per_s or 4.0 * self.flops_per_s


@dataclass(frozen=True)
class LinkProfile:
    name: str
    bandwidth: float            # bytes/s
    rtt_s: float = 0.0


@dataclass(frozen=True)
class TraceSegment:
    """One piecewise-constant stretch of a time-varying link."""
    duration_s: float           # use float("inf") for a terminal segment
    bandwidth: float            # bytes/s while this segment is active
    rtt_s: float = 0.0


@dataclass(frozen=True)
class LinkTrace:
    """Piecewise-constant (bandwidth, RTT) schedule over elapsed time.

    ``state_at(t)`` answers "what does the link look like ``t`` seconds
    into the deployment"; ``loop=True`` repeats the schedule forever
    (periodic congestion), otherwise the last segment holds after the
    schedule runs out. ``span_at(t)`` additionally reports how long the
    current segment still lasts, which lets ``SimChannel`` charge a
    transmission that straddles a bandwidth change exactly, segment by
    segment.
    """
    name: str
    segments: Tuple[TraceSegment, ...]
    loop: bool = False

    def __post_init__(self) -> None:
        if not self.segments:
            raise ValueError("LinkTrace needs at least one segment")
        if self.loop and not all(s.duration_s < float("inf")
                                 for s in self.segments):
            raise ValueError("a looping trace cannot contain an infinite "
                             "segment")
        for s in self.segments:
            # a dead link would make byte-draining loops spin forever;
            # model an outage as a very small positive bandwidth instead
            if not (s.bandwidth > 0 and s.duration_s > 0):
                raise ValueError("trace segments need bandwidth > 0 and "
                                 "duration > 0 (model an outage as e.g. "
                                 "1 kbit/s, not 0)")

    @property
    def duration_s(self) -> float:
        return sum(s.duration_s for s in self.segments)

    def span_at(self, t: float) -> Tuple[float, float, float]:
        """(bandwidth, rtt_s, seconds until this segment ends) at time t.

        The remaining span is ``inf`` once a non-looping trace has settled
        into its final segment.
        """
        t = max(0.0, t)
        total = self.duration_s
        if self.loop:
            t = t % total
        elif t >= total:
            last = self.segments[-1]
            return last.bandwidth, last.rtt_s, float("inf")
        for seg in self.segments:
            if t < seg.duration_s:
                return seg.bandwidth, seg.rtt_s, seg.duration_s - t
            t -= seg.duration_s
        last = self.segments[-1]          # t == total on a non-loop trace
        return last.bandwidth, last.rtt_s, float("inf")

    def state_at(self, t: float) -> Tuple[float, float]:
        """(bandwidth bytes/s, rtt_s) in effect ``t`` seconds in."""
        bw, rtt, _ = self.span_at(t)
        return bw, rtt

    def link_at(self, t: float) -> LinkProfile:
        """The trace's link state ``t`` seconds in, as a LinkProfile."""
        bw, rtt = self.state_at(t)
        return LinkProfile(f"{self.name}@{t:.2f}s", bandwidth=bw, rtt_s=rtt)

    @classmethod
    def from_mbps(cls, name: str, spans, rtt_ms: float = 2.0,
                  loop: bool = False) -> "LinkTrace":
        """Build from (duration_s, mbps) or (duration_s, mbps, rtt_ms)
        tuples — the natural units wireless people speak."""
        segs = []
        for span in spans:
            dur, mbps = span[0], span[1]
            rtt = span[2] if len(span) > 2 else rtt_ms
            segs.append(TraceSegment(dur, mbps * 1e6 / 8, rtt * 1e-3))
        return cls(name, tuple(segs), loop=loop)


@dataclass(frozen=True)
class TwoTierProfile:
    device: ComputeProfile
    server: ComputeProfile
    link: LinkProfile


# --- Tier A: the paper's testbed -------------------------------------------
PAPER_EDGE = ComputeProfile("i7-6700 (4c, 3.4GHz)", flops_per_s=45e9,
                            mem_bw=25e9, overhead_s=2e-4)
PAPER_SERVER = ComputeProfile("RTX 3090 (small-batch CNN)",
                              flops_per_s=8e12, mem_bw=936e9,
                              overhead_s=3e-4)
PAPER_WIFI = LinkProfile("Wi-Fi ~50 Mbps", bandwidth=50e6 / 8, rtt_s=4e-3)
PAPER_PROFILE = TwoTierProfile(PAPER_EDGE, PAPER_SERVER, PAPER_WIFI)

# Batched serving: the same 3090 sustains a much larger fraction of peak
# once cross-client dynamic batching keeps its SMs fed — batch-1 AlexNet
# layers are launch-latency-bound (hence the low small-batch calibration
# above), and ``overhead_s`` is amortized across the fused batch (see
# ``latency_model.batched_server_time``). The calibrated sustained
# throughput for bucket-8 CNN batches:
PAPER_SERVER_BATCHED = ComputeProfile("RTX 3090 (batched CNN, bucket 8)",
                                      flops_per_s=24e12, mem_bw=936e9,
                                      overhead_s=3e-4)
#: the heavy-traffic deployment: many edges, one batched cloud GPU
PAPER_FARM_PROFILE = TwoTierProfile(PAPER_EDGE, PAPER_SERVER_BATCHED,
                                    PAPER_WIFI)

# --- battery-constrained edge classes ---------------------------------------
# The embedded devices the paper's motivation names ("resource-limited
# embedded devices", high energy consumption). Their per-state power
# draws live next door in ``repro_torch.core.partition.energy_model``
# (MCU_ENERGY / PI_ENERGY); these are the matching compute throughputs.
#: MCU-class edge (Cortex-M/ESP32 class): reproduces the paper's
#: AlexNet@224-vs-i7 regime — a split optimum that genuinely moves with
#: the link — at benchmark scale.
#: int8 at 8x fp32: the MCU's fp32 path is soft-float while int8 MACs
#: ride the SIMD/DSP extensions (the CMSIS-NN regime)
MCU_EDGE = ComputeProfile("MCU-class edge", flops_per_s=0.15e9,
                          mem_bw=0.5e9, overhead_s=3e-4,
                          int8_flops_per_s=1.2e9)
#: Pi-class single-board edge (quad A72 class, NEON fp32; int8 dot
#: product units give the NEON path ~4x fp32)
PI_EDGE = ComputeProfile("Pi-class edge", flops_per_s=6e9,
                         mem_bw=4e9, overhead_s=2.5e-4,
                         int8_flops_per_s=24e9)
#: Phone-class edge (mid-range smartphone, big.LITTLE A7x SoC).
#: Calibration: sustained fp32 CNN inference on the CPU/NEON path of a
#: 2020s mid-ranger lands at a few tens of GFLOP/s (thermally throttled
#: well below peak; NPU offload would be ~10x but is not the fp32
#: path this repo deploys), with LPDDR4X delivering ~12 GB/s effective
#: to a single cluster. Sits between PI_EDGE and PAPER_EDGE — the
#: third heterogeneous class the fleet simulator mixes.
PHONE_EDGE = ComputeProfile("phone-class edge", flops_per_s=25e9,
                            mem_bw=12e9, overhead_s=2e-4)
#: Jetson-class cloudlet: the aggregation box the hierarchical-FL plant
#: disease deployments park between the field and the datacenter (an
#: Orin-class module on a pole, not a 3090 in a rack). Calibration:
#: ~1.2 TFLOP/s sustained dense fp32 (ampere-generation embedded GPU,
#: thermally capped), ~60 GB/s LPDDR5, sub-ms launch overhead. Fast
#: enough to absorb a village of edges, slow enough that an
#: under-provisioned fleet genuinely queues — which is what the fleet
#: simulator's cloudlet tier is for.
CLOUDLET_SERVER = ComputeProfile("Jetson-class cloudlet",
                                 flops_per_s=1.2e12, mem_bw=60e9,
                                 overhead_s=1e-4)

# --- the port's card: one NVIDIA H100 SXM -----------------------------------
#: Data-sheet peaks, not a calibration. The port's edge runs in fp32 with
#: TF32 off (``device.exact_fp32``), so ``flops_per_s`` is the CUDA cores'
#: fp32 rate. ``int8_flops_per_s`` is that same fp32 rate, not the int8
#: tensor-core rate: ``masked_matmul_q8`` dequantizes the int8 codes in its
#: load and multiplies in fp32 FMAs (``csrc/masked_matmul.cu``, the
#: ``_q8_*`` entries).
H100_CARD = ComputeProfile("NVIDIA H100 SXM (data sheet)",
                           flops_per_s=hw.PEAK_FLOPS_FP32, mem_bw=hw.HBM_BW,
                           int8_flops_per_s=hw.PEAK_FLOPS_FP32)


# --- Tier B: a transformer split across H100 nodes --------------------------
#: the transformer's layers run in bf16 on the tensor cores, so a node or a
#: cluster is priced at the data sheet's dense bf16 rate and HBM rate per
#: card (``roofline.hw``), times its cards: an 8-card HGX/DGX H100 node,
#: and a cluster of 32 such nodes
H100_NODE = ComputeProfile("H100 node (8 cards)",
                           flops_per_s=8 * hw.PEAK_FLOPS_BF16,
                           mem_bw=8 * hw.HBM_BW)
H100_CLUSTER = ComputeProfile("H100 cluster (256 cards)",
                              flops_per_s=256 * hw.PEAK_FLOPS_BF16,
                              mem_bw=256 * hw.HBM_BW)
#: between two nodes of a cluster the activations cross InfiniBand at the
#: node's whole compute fabric (``hw.NODE_FABRIC_BW``)
INTER_NODE_IB = LinkProfile("inter-node InfiniBand NDR (8 x 400 Gb/s)",
                            bandwidth=hw.NODE_FABRIC_BW, rtt_s=5e-6)
H100_TWO_NODE = TwoTierProfile(H100_NODE, H100_NODE, INTER_NODE_IB)
#: an edge site's node serving through a cluster over a 200 Gb/s Ethernet
#: uplink (a ConnectX-7 port at its 200 GbE rate) into the datacenter
DATACENTER_LINK = LinkProfile("datacenter Ethernet uplink (200 Gb/s)",
                              bandwidth=200e9 / 8, rtt_s=1e-4)
H100_EDGE_CLOUD = TwoTierProfile(H100_NODE, H100_CLUSTER, DATACENTER_LINK)


# --- canned time-varying link traces ----------------------------------------
#: the paper's steady testbed link, as a (degenerate) trace
WIFI_STEADY = LinkTrace.from_mbps("wifi_steady",
                                  [(float("inf"), 50.0)], rtt_ms=4.0)
#: edge device walks away from the access point: 50 -> 18 -> 5 Mbps
WIFI_DEGRADING = LinkTrace.from_mbps(
    "wifi_degrading", [(4.0, 50.0), (4.0, 18.0), (float("inf"), 5.0)],
    rtt_ms=4.0)
#: 4G field link with a coverage hole mid-route (handover dip)
LTE_HANDOVER = LinkTrace.from_mbps(
    "lte_handover",
    [(3.0, 30.0, 30.0), (2.0, 2.0, 80.0), (float("inf"), 25.0, 30.0)])
#: shared uplink that sawtooths between free and congested, forever
CONGESTED_SAWTOOTH = LinkTrace.from_mbps(
    "congested_sawtooth", [(2.0, 40.0), (2.0, 6.0)], rtt_ms=10.0, loop=True)

TRACES = {
    "wifi_steady": WIFI_STEADY,
    "wifi_degrading": WIFI_DEGRADING,
    "lte_handover": LTE_HANDOVER,
    "congested_sawtooth": CONGESTED_SAWTOOTH,
}

PROFILES = {
    "paper": PAPER_PROFILE,
    "paper_farm": PAPER_FARM_PROFILE,
    "h100_two_node": H100_TWO_NODE,
    "h100_edge_cloud": H100_EDGE_CLOUD,
}


# --- fault schedules ---------------------------------------------------------
#: failure modes a schedule may inject, in roughly increasing severity
FAULT_KINDS = ("drop", "corrupt", "stall", "disconnect", "die")


@dataclass(frozen=True)
class FaultEvent:
    """One injected failure, pinned to a transmission-attempt index.

    ``attempt`` counts data-frame transmission attempts on the injected
    path (0-based); retries are new attempts, so a schedule that faults
    attempt 3 but not attempt 4 lets the first retry succeed. ``kind``
    is one of ``FAULT_KINDS``:

    - ``drop``: the frame is silently lost (never delivered);
    - ``corrupt``: one payload byte is flipped in flight;
    - ``stall``: delivery is delayed by ``stall_s`` seconds;
    - ``disconnect``: the connection is torn down mid-stream;
    - ``die``: the cloud process itself is killed (server-side only;
      on a client-side injector it behaves like ``disconnect``).
    """
    attempt: int
    kind: str
    stall_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.attempt < 0:
            raise ValueError("fault attempt index must be >= 0")
        if self.kind == "stall" and self.stall_s <= 0:
            raise ValueError("stall events need stall_s > 0")


@dataclass(frozen=True)
class FaultSchedule:
    """A deterministic sequence of injected faults, keyed by attempt.

    A schedule is to failures what a ``LinkTrace`` is to bandwidth: a
    canned, replayable storyline. It is pure data — stateless and
    reusable; the per-run attempt counter lives in the
    ``FaultInjector`` that replays it (``repro_torch.core.collab.channel``),
    so the same schedule object can drive many independent runs.
    """
    name: str
    events: Tuple[FaultEvent, ...]

    def __post_init__(self) -> None:
        seen = set()
        for ev in self.events:
            if ev.attempt in seen:
                raise ValueError(f"schedule {self.name!r} has two events "
                                 f"for attempt {ev.attempt}")
            seen.add(ev.attempt)

    def event_at(self, attempt: int) -> Optional[FaultEvent]:
        """The fault injected at transmission attempt ``attempt``, or
        None for a clean attempt."""
        for ev in self.events:
            if ev.attempt == attempt:
                return ev
        return None

    @property
    def n_events(self) -> int:
        """Total number of injected faults in the schedule."""
        return len(self.events)

    @classmethod
    def seeded(cls, name: str, seed: int, n_attempts: int,
               drop: float = 0.0, corrupt: float = 0.0, stall: float = 0.0,
               stall_s: float = 0.05, disconnect: float = 0.0,
               ) -> "FaultSchedule":
        """Draw a random-but-reproducible schedule over ``n_attempts``.

        Each attempt independently suffers at most one fault, drawn
        with the given per-kind probabilities from ``random.Random
        (seed)`` — same seed, same schedule, forever. Probabilities
        must sum to <= 1.
        """
        p_total = drop + corrupt + stall + disconnect
        if p_total > 1.0:
            raise ValueError("fault probabilities sum to > 1")
        rng = random.Random(seed)
        events = []
        for a in range(n_attempts):
            u = rng.random()
            if u < drop:
                events.append(FaultEvent(a, "drop"))
            elif u < drop + corrupt:
                events.append(FaultEvent(a, "corrupt"))
            elif u < drop + corrupt + stall:
                events.append(FaultEvent(a, "stall", stall_s=stall_s))
            elif u < p_total:
                events.append(FaultEvent(a, "disconnect"))
        return cls(name, tuple(events))


#: lossy uplink: ~6% of frames vanish in flight
FAULT_DROP_BURST = FaultSchedule.seeded("drop_burst", seed=7,
                                        n_attempts=600, drop=0.06)
#: congested AP: ~8% of frames stall for 30 ms, a few are corrupted
FAULT_STALL_STORM = FaultSchedule.seeded("stall_storm", seed=11,
                                         n_attempts=600, corrupt=0.02,
                                         stall=0.08, stall_s=0.03)
#: coverage hole: every attempt in a contiguous window tears the
#: connection down — retries inside the window keep failing
FAULT_OUTAGE = FaultSchedule(
    "outage", tuple(FaultEvent(a, "disconnect") for a in range(12, 18)))
#: the cloud process is killed mid-stream at attempt 8
FAULT_CLOUD_DEATH = FaultSchedule("cloud_death", (FaultEvent(8, "die"),))

FAULT_SCHEDULES = {
    "drop_burst": FAULT_DROP_BURST,
    "stall_storm": FAULT_STALL_STORM,
    "outage": FAULT_OUTAGE,
    "cloud_death": FAULT_CLOUD_DEATH,
}
