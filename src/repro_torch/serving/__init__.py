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

Plans are byte-compatible with ``repro.serving``'s (same digest, same
directory layout), and the socket peers speak the reference's frames, so
a port edge and a JAX cloud (or the reverse) serve each other. The
``local`` and ``socket`` backends are ported; ``streaming`` and the
``adaptive``, ``energy`` and ``fleet`` plan sections come with the next
slice.
"""
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
from repro_torch.core.partition.profiles import (FAULT_SCHEDULES, TRACES,
                                                 FaultEvent, FaultSchedule,
                                                 LinkTrace, TraceSegment)
from repro_torch.serving.plan import PLAN_VERSION, DeploymentPlan
from repro_torch.serving.session import (BACKENDS, CloudFleet, CloudServer,
                                         InferenceSession, LocalSession,
                                         SocketSession, connect, serve)

__all__ = [
    "BACKENDS", "PLAN_VERSION", "DeploymentPlan", "InferenceSession",
    "LocalSession", "SocketSession", "CloudServer", "CloudFleet",
    "PlanMismatchError", "connect", "serve",
    "LinkTrace", "TraceSegment", "TRACES",
    "BatchingPolicy", "LaneStats", "LaneSaturated",
    "FaultPolicy", "FaultSchedule", "FaultEvent", "FaultInjector",
    "RequestTimeout", "FrameIntegrityError", "fault_record",
    "FAULT_SCHEDULES",
    "RoutingPolicy", "FleetRouter", "FleetExhaustedError",
    "ServerDraining", "ServerBusy", "QuantPolicy",
]
