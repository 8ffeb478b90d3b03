"""``repro_torch.serving`` — the deployment front door of the port::

    from repro_torch import serving

    plan = serving.DeploymentPlan.from_args(params, cfg, masks=masks,
                                            compact=True, codec="int8",
                                            quant=serving.QuantPolicy(8))
    with serving.connect(plan, backend="local") as sess:   # on the card
        out = sess.infer(image)      # {"logits", "t_edge", "tx_bytes", ...}

    with serving.CloudServer(plan, max_clients=None):       # cloud peer
        with serving.connect(plan, backend="socket") as sess:
            out = sess.infer(image)

    with serving.connect(plan, backend="streaming",
                         microbatch=4) as sess:     # edge ∥ link ∥ cloud
        outs = sess.infer_many(images)

    plan = serving.DeploymentPlan.from_pipeline(run_paper_pipeline(...))

Plans are byte-compatible with ``repro.serving``'s (same digest, same
directory layout), and the socket peers speak the reference's frames, so
a port edge and a JAX cloud (or the reverse) serve each other. The
``local``, ``socket`` and ``streaming`` backends are ported, with every
plan section of the reference: ``adaptive`` (the split controller,
RESPLIT on the live socket), ``energy`` (``e_edge_j`` in every result,
the energy-aware split), ``batching``, ``faults``, ``routing``, ``quant``
and ``fleet``.

Fleet studies: attach ``FleetScenario(...)`` as the plan's ``fleet``
section to pin the simulated deployment context (fleet size, device and
trace mixes, SLO classes, battery budgets, the diurnal
``ArrivalPattern``, the cloudlet tier's shape) and run it on the host's
virtual clock with ``simulate_fleet``; the rollup equals the JAX
package's for the same scenario and seed::

    sc = serving.FleetScenario(name="orchard", seed=7, n_edges=1000,
                               n_cloudlets=8, duration_s=30.0)
    rollup = serving.simulate_fleet(sc)  # p50/p99 latency, J per request
"""
from repro_torch.core.collab.adaptive import (AdaptivePolicy,
                                              AdaptiveSplitController,
                                              BandwidthEstimator,
                                              SplitSwitch)
from repro_torch.core.collab.batching import (BatchingPolicy, LaneSaturated,
                                              LaneStats)
from repro_torch.core.collab.channel import FaultInjector
from repro_torch.core.collab.cluster import (FleetExhaustedError,
                                             FleetRouter, RoutingPolicy)
from repro_torch.core.collab.faults import (FaultPolicy, RequestTimeout,
                                            ServerBusy, ServerDraining,
                                            fault_record)
from repro_torch.core.collab.protocol import (FrameIntegrityError,
                                              PlanMismatchError)
from repro_torch.core.collab.quant import QuantPolicy
from repro_torch.core.fleet import (ArrivalPattern, FleetScenario,
                                    FleetSimulator, SLOClass,
                                    simulate_fleet)
from repro_torch.core.partition.energy_model import (ENERGY_PROFILES,
                                                     MCU_ENERGY,
                                                     PAPER_EDGE_ENERGY,
                                                     PI_ENERGY, EnergyPolicy,
                                                     EnergyProfile,
                                                     RadioProfile,
                                                     pareto_front)
from repro_torch.core.partition.profiles import (FAULT_SCHEDULES, TRACES,
                                                 FaultEvent, FaultSchedule,
                                                 LinkTrace, TraceSegment)
from repro_torch.serving.plan import PLAN_VERSION, DeploymentPlan
from repro_torch.serving.session import (BACKENDS, CloudFleet, CloudServer,
                                         InferenceSession, LocalSession,
                                         SocketSession, StreamingSession,
                                         connect, serve)

__all__ = [
    "BACKENDS", "PLAN_VERSION", "DeploymentPlan", "InferenceSession",
    "LocalSession", "SocketSession", "StreamingSession", "CloudServer",
    "CloudFleet",
    "PlanMismatchError", "connect", "serve",
    "AdaptivePolicy", "AdaptiveSplitController", "BandwidthEstimator",
    "SplitSwitch", "LinkTrace", "TraceSegment", "TRACES",
    "BatchingPolicy", "LaneStats", "LaneSaturated",
    "EnergyPolicy", "EnergyProfile", "RadioProfile", "pareto_front",
    "ENERGY_PROFILES", "MCU_ENERGY", "PI_ENERGY", "PAPER_EDGE_ENERGY",
    "FaultPolicy", "FaultSchedule", "FaultEvent", "FaultInjector",
    "RequestTimeout", "FrameIntegrityError", "fault_record",
    "FAULT_SCHEDULES",
    "RoutingPolicy", "FleetRouter", "FleetExhaustedError",
    "ServerDraining", "ServerBusy", "QuantPolicy",
    "ArrivalPattern", "FleetScenario", "FleetSimulator", "SLOClass",
    "simulate_fleet",
]
