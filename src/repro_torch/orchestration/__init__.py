"""Topologies and workloads — the host-side inputs of the fleet simulator
— the forwarding router, the event-heap :class:`Orchestrator` (the
simulation plane's host engine, which checks the fleet simulator) and
synchronous placement, which the serving engine drives.

    from repro_torch.core.block_queue import FastPreferentialQueue
    from repro_torch.orchestration import (Orchestrator, Router, Topology,
                                           get_workload)

    topo = Topology.ring(6, speeds=[1, 1, 2, 2, 1, 1])
    orch = Orchestrator(topo, FastPreferentialQueue,
                        Router(topo, "power_of_two", seed=0, device="cpu"))
    result = orch.run(get_workload("paper/scenario3").generate(seed=0))
    print(result.met_rate, result.per_service["S1"].met_rate)
"""
from repro_torch.orchestration.orchestrator import (Hooks, Orchestrator,
                                                    OrchestratorResult,
                                                    ServiceStats, place)
from repro_torch.orchestration.router import ROUTER_POLICIES, Router
from repro_torch.orchestration.topology import Topology
from repro_torch.orchestration.workload import (DiurnalWorkload,
                                                PoissonWorkload,
                                                TraceWorkload,
                                                UniformWorkload, Workload,
                                                available_workloads,
                                                dump_trace, fleet_workload,
                                                get_workload,
                                                register_workload)

__all__ = ["Hooks", "Orchestrator", "OrchestratorResult", "ServiceStats",
           "ROUTER_POLICIES", "Router", "Topology", "DiurnalWorkload",
           "PoissonWorkload", "TraceWorkload", "UniformWorkload",
           "Workload", "available_workloads", "dump_trace",
           "fleet_workload", "get_workload", "place", "register_workload"]
