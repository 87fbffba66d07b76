"""Distributed runtime: failure detection, elastic re-mesh, stragglers
(port of ``repro.runtime``)."""
from .fault_tolerance import (HeartbeatMonitor, HostFailure, MeshPlan,
                              SimulatedCluster, StragglerMonitor,
                              elastic_remesh, run_with_recovery)

__all__ = ["HeartbeatMonitor", "HostFailure", "MeshPlan", "SimulatedCluster",
           "StragglerMonitor", "elastic_remesh", "run_with_recovery"]
