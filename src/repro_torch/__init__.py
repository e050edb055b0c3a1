"""repro_torch — the PyTorch/CUDA port of the MEC load-orchestration system.

The JAX package ``repro`` is the reference; this package runs the same
strategy (deadline-aware preferential admission plus sequential
forwarding, DESIGN.md §1-2) on an NVIDIA GPU.  It imports ``torch`` and
numpy only, never ``jax`` and nothing of ``repro``: the host modules it
needs (requests, scenarios, topologies, workloads, link pricing) are its
own copies, so both packages consume identical inputs.

Entry points take ``device=None``, which means ``"cuda"``; with no GPU
they raise (:func:`repro_torch.device.resolve_device`) instead of falling
back to the CPU.  Pass ``device="cpu"`` to run the plain PyTorch versions
of the kernels, as the tests do.

    from repro_torch.fleetsim import simulate, topology_arrays
    from repro_torch.netsim import LinkModel
    from repro_torch.orchestration import Topology, get_workload

    topo = Topology.full_mesh(3)
    reqs, _ = get_workload("paper/scenario1").to_arrays(0)
    m = simulate(reqs, topology_arrays(topo), policy="batched_feasible",
                 capacity=4096, depth=1024,
                 net=LinkModel.campus(topo).net_params())

The telemetry plane (DESIGN.md §8) is :mod:`repro_torch.telemetry`, and a
sweep over seeds, SLA scales or networks is ``fleetsim.simulate_fn``.
"""
from repro_torch import telemetry
from repro_torch.device import resolve_device

__all__ = ["resolve_device", "telemetry"]
