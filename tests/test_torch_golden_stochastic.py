"""The golden file's entries under the stochastic forwarding policies
(tests/make_torch_golden.py): the port recomputes ``paper/scenario3``
under ``random`` and ``power_of_two`` on the CPU at full volume (~28 s
each), its forwards drawn by the port's threefry
(``repro_torch.fleetsim.rng``), and each must equal the JAX reference's
entry.  The other four stochastic entries take the eager loop minutes on
the CPU; ``chip_smoke.py`` holds the card to all six.
"""
import json

import pytest

import make_torch_golden as mk
import repro_torch.fleetsim as tfs
from repro_torch.netsim import LinkModel
from repro_torch.orchestration import Topology, get_workload

with open(mk.GOLDEN) as _f:
    GOLDEN = json.load(_f)
RUNS = {r["name"]: r for r in GOLDEN["runs"]}


@pytest.mark.parametrize("name", ["paper/scenario3@random",
                                  "paper/scenario3@power_of_two"])
def test_stochastic_entry_is_current_for_the_port(name):
    """9,800 requests on 6 nodes, the threefry draws of ~500 forwards, on
    the CPU: digests and integer aggregates exactly, floats to 1e-5."""
    spec = RUNS[name]
    reqs, _ = get_workload(spec["workload"]["registry"]).to_arrays(
        GOLDEN["seed"])
    topo = Topology.full_mesh(spec["n_nodes"])
    m = tfs.simulate(
        reqs, tfs.topology_arrays(topo), tfs.SimParams.make(GOLDEN["seed"]),
        policy=spec["policy"], max_forwards=GOLDEN["max_forwards"],
        capacity=spec["capacity"], depth=spec["depth"],
        net=LinkModel.preset(topo, GOLDEN["net"]).net_params(),
        max_events=spec["max_events"], device="cpu")
    got = mk.summarize(m)
    assert got["aggregates"] == spec["aggregates"]
    assert got["digests"] == spec["digests"]
    for k, v in spec["floats"].items():
        assert abs(got["floats"][k] - v) <= 1e-5 * abs(v), k
    assert int(m.forwards) > 0
