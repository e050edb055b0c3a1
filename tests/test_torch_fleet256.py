"""The 256-node fleet's geometry on the CPU: ``fleet_workload(256,
div=200)`` (2,048 requests over a 550 UT window on a 256-node full mesh:
(256, 255) neighbour rows, 255 neighbours to score or draw from) through
the port's eager loop and the reference's jitted ``simulate`` under
``random``, ``least_loaded`` and ``batched_feasible``.  At the paper's
SLA this volume forwards nothing (each node clears its ~8 requests well
inside their deadlines), so the fleet runs a second time at
``sla_scale`` 0.05, where hundreds of requests are forwarded across the
mesh.  Per request, outcome, serving node and forwards used are equal,
and the three overflow counters are 0.  The golden file's 256-node and
arrival-process entries are checked in tests/test_torch_golden.py; the
card runs the same fleets in tests/test_torch_gpu.py."""
import numpy as np
import pytest

import repro_torch.fleetsim as tfs
from repro.core.scenarios import SCENARIOS
from repro.fleetsim import SimParams as JSimParams
from repro.fleetsim import simulate as j_simulate
from repro.fleetsim import topology_arrays as j_topology_arrays
from repro.orchestration import Topology as JTopology
from repro.orchestration import UniformWorkload as JUniformWorkload
from repro_torch.orchestration import Topology, fleet_workload

K, DIV, CAPACITY, DEPTH = 256, 200, 128, 64
POLICIES = ("random", "least_loaded", "batched_feasible")


def reference_workload():
    """``benchmarks/fleetsim_bench.py::make_fleet_workload(256, 200)``."""
    counts = [{s: max(1, c // DIV) for s, c in SCENARIOS[1][i % 3].items()}
              for i in range(K)]
    return JUniformWorkload(counts, window=110_000.0 / DIV,
                            name=f"fleet{K}_div{DIV}")


@pytest.fixture(scope="module")
def arrays():
    ja, _ = reference_workload().to_arrays(0)
    ta, _ = fleet_workload(K, DIV).to_arrays(0)
    for field, x, y in zip(ja._fields, ja, ta):
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    return ja, ta


def test_geometry():
    ta = tfs.topology_arrays(Topology.full_mesh(K))
    ja = j_topology_arrays(JTopology.full_mesh(K))
    assert ta.neighbors.shape == (K, K - 1) and (ta.degree == K - 1).all()
    for field, x, y in zip(ja._fields, ja, ta):
        assert np.array_equal(np.asarray(x), y), field


@pytest.mark.parametrize("sla_scale", [1.0, 0.05])
@pytest.mark.parametrize("policy", POLICIES)
def test_fleet256_matches_reference_per_request(arrays, policy, sla_scale):
    ja, ta = arrays
    kw = dict(policy=policy, capacity=CAPACITY, depth=DEPTH)
    ref = j_simulate(ja, j_topology_arrays(JTopology.full_mesh(K)),
                     JSimParams.make(0, sla_scale), **kw)
    port = tfs.simulate(ta, tfs.topology_arrays(Topology.full_mesh(K)),
                        tfs.SimParams.make(0, sla_scale), device="cpu", **kw)
    assert len(ta.arrival) == int(port.total) == 2048
    for f in ("outcome", "served_by", "forwards_used"):
        x, y = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert np.array_equal(x, y), f
    for f in ("forwards", "met_deadline", "processed"):
        assert int(getattr(ref, f)) == int(getattr(port, f)), f
    assert int(port.overflow) == int(port.window_saturation) == \
        int(port.event_overflow) == 0
    assert int(ref.overflow) == int(ref.window_saturation) == \
        int(ref.event_overflow) == 0
    if sla_scale < 1.0:
        # forwards spread over the mesh, not a few hot rows
        assert int(port.forwards) > 300
        assert len(np.unique(port.served_by.numpy())) == K
