"""Topologies and workloads — the host-side inputs of the fleet simulator."""
from repro_torch.orchestration.topology import Topology
from repro_torch.orchestration.workload import (UniformWorkload, Workload,
                                                available_workloads,
                                                fleet_workload, get_workload,
                                                register_workload)

__all__ = ["Topology", "UniformWorkload", "Workload", "available_workloads",
           "fleet_workload", "get_workload", "register_workload"]
