"""Virtual-clock fleet simulation: heterogeneous edge populations,
an edge -> cloudlet -> cloud hierarchy, SLO admission, and energy
budgets — all priced by the same Eq. 5 / batching / trace models the
single-edge subsystems calibrate, all bit-reproducible per seed. Plain
Python, a copy of the JAX package's ``core/fleet``: the same scenario and
seed give rollups equal, with ``==``, to the reference's.
"""
from repro_torch.core.fleet.admission import (AdmissionController, RoutePlan,
                                        SplitPlanner)
from repro_torch.core.fleet.clock import EventQueue
from repro_torch.core.fleet.metrics import (FleetMetrics, RequestRecord,
                                      percentile)
from repro_torch.core.fleet.population import (DEVICE_CLASSES, SimEdge,
                                         build_population)
from repro_torch.core.fleet.scenario import (DEFAULT_SLO_CLASSES, ArrivalPattern,
                                       ChaosEvent, FleetScenario, SLOClass)
from repro_torch.core.fleet.simulator import FleetSimulator, simulate_fleet
from repro_torch.core.fleet.tiers import (CLOUD_SERVER, CLOUDLET_SERVER,
                                    TierServer, TierStats, backhaul_link)

__all__ = [
    "AdmissionController", "ArrivalPattern", "CLOUD_SERVER",
    "CLOUDLET_SERVER", "ChaosEvent", "DEFAULT_SLO_CLASSES",
    "DEVICE_CLASSES", "EventQueue", "FleetMetrics", "FleetScenario",
    "FleetSimulator", "RequestRecord", "RoutePlan", "SLOClass", "SimEdge",
    "SplitPlanner", "TierServer", "TierStats", "backhaul_link",
    "build_population", "percentile", "simulate_fleet",
]
