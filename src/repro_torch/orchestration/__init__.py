"""Topologies and workloads — the host-side inputs of the fleet simulator —
and the forwarding router with synchronous placement, which the serving
engine drives."""
from repro_torch.orchestration.orchestrator import place
from repro_torch.orchestration.router import ROUTER_POLICIES, Router
from repro_torch.orchestration.topology import Topology
from repro_torch.orchestration.workload import (UniformWorkload, Workload,
                                                available_workloads,
                                                fleet_workload, get_workload,
                                                register_workload)

__all__ = ["ROUTER_POLICIES", "Router", "Topology", "UniformWorkload",
           "Workload", "available_workloads", "fleet_workload",
           "get_workload", "place", "register_workload"]
