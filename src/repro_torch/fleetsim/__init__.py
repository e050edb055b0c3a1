"""repro_torch.fleetsim — the event-time fleet simulator in PyTorch.

The port of :mod:`repro.fleetsim`: the same strategy as stacked
``(num_nodes, capacity)`` ledger tensors, one event per step.  On CUDA a
whole run is one launch of the hand-written Hopper ``event_scan`` kernel;
on the CPU the eager per-event loop, its plain version, runs.

    from repro_torch.fleetsim import simulate, topology_arrays
    from repro_torch.netsim import LinkModel
    from repro_torch.orchestration import Topology, get_workload

    topo = Topology.full_mesh(3)
    reqs, _ = get_workload("paper/scenario1").to_arrays(0)
    m = simulate(reqs, topology_arrays(topo), policy="batched_feasible",
                 capacity=4096, depth=1024,
                 net=LinkModel.campus(topo).net_params())
    print(float(m.met_rate), int(m.forwards))
"""
from repro_torch.fleetsim.arrays import (RequestArrays, TopologyArrays,
                                         event_bound, pack_requests,
                                         scenario_arrays, to_device,
                                         topology_arrays)
from repro_torch.fleetsim.core import (DISCARDED, LATE, MET, OVERFLOW,
                                       PENDING, POLICIES, FleetMetrics,
                                       SimParams, simulate, simulate_fn)
from repro_torch.netsim.link import NetParams

__all__ = [
    "RequestArrays", "TopologyArrays", "event_bound", "pack_requests",
    "scenario_arrays", "to_device", "topology_arrays",
    "FleetMetrics", "NetParams", "SimParams", "simulate", "simulate_fn",
    "POLICIES", "PENDING", "MET", "LATE", "DISCARDED", "OVERFLOW",
]
