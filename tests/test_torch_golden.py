"""The committed golden file (tests/data/torch_fleetsim_golden.json, written
by tests/make_torch_golden.py) stays current, and the port's workload
copies reproduce the reference's request arrays for every run in it.

``chip_smoke.py`` holds the GPU port against this file because JAX is
not installed beside the card; here both packages recompute the
``paper/scenario1`` entry on the CPU at its stored sizing and must equal
it: digests and integer aggregates exactly, the float aggregates to a
relative 1e-5 (sums over 6,000 requests in another order).  The same two
runs are the slice's whole-volume parity check: the port against the
reference per request, ``completion`` and ``transfer_used`` included.
"""
import json

import numpy as np
import pytest

import make_torch_golden as mk
import repro_torch.fleetsim as tfs
from repro_torch.netsim import LinkModel
from repro_torch.orchestration import Topology, fleet_workload, get_workload

with open(mk.GOLDEN) as _f:
    GOLDEN = json.load(_f)
RUNS = {r["name"]: r for r in GOLDEN["runs"]}


def _port_workload(spec):
    w = spec["workload"]
    if "registry" in w:
        return get_workload(w["registry"])
    return fleet_workload(w["fleet"], w["div"])


def test_golden_file_covers_the_main_path():
    assert [r["name"] for r in GOLDEN["runs"]] == [r["name"] for r in mk.RUNS]
    assert (GOLDEN["policy"], GOLDEN["net"]) == ("batched_feasible", "campus")
    for run in GOLDEN["runs"]:
        agg = run["aggregates"]
        assert agg["overflow"] == agg["window_saturation"] == \
            agg["event_overflow"] == 0, run["name"]
        assert agg["total"] < run["max_events"] <= 3 * agg["total"]
        assert set(run["digests"]) == set(mk.DIGESTS)


@pytest.mark.parametrize("name", [r["name"] for r in mk.RUNS])
def test_port_workloads_reproduce_reference_arrays(name):
    spec = RUNS[name]
    ja, _ = mk.reference_workload(spec["workload"]).to_arrays(GOLDEN["seed"])
    ta, _ = _port_workload(spec).to_arrays(GOLDEN["seed"])
    assert len(ta.arrival) == spec["aggregates"]["total"]
    for field, a, b in zip(ja._fields, ja, ta):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def _assert_matches_golden(got, want, float_rtol):
    assert got["aggregates"] == want["aggregates"]
    assert got["digests"] == want["digests"]
    for k, v in want["floats"].items():
        assert abs(got["floats"][k] - v) <= float_rtol * abs(v), k


@pytest.fixture(scope="module")
def scenario1_both():
    """``paper/scenario1`` at full volume (6,000 requests, 3 nodes, campus
    pricing, batched_feasible) at the stored sizing: the reference's
    metrics (Pallas ``event_select`` in interpret mode) and the port's
    (torch on the CPU), each run once for the tests below."""
    spec = RUNS["paper/scenario1"]
    ref_m = mk.run_reference(spec, spec["max_events"])
    reqs, _ = _port_workload(spec).to_arrays(GOLDEN["seed"])
    topo = Topology.full_mesh(spec["n_nodes"])
    port_m = tfs.simulate(
        reqs, tfs.topology_arrays(topo), tfs.SimParams.make(GOLDEN["seed"]),
        policy=GOLDEN["policy"], max_forwards=GOLDEN["max_forwards"],
        capacity=spec["capacity"], depth=spec["depth"],
        net=LinkModel.preset(topo, GOLDEN["net"]).net_params(),
        max_events=spec["max_events"], device="cpu")
    return spec, ref_m, port_m


def test_scenario1_entry_is_current_for_both_packages(scenario1_both):
    spec, ref_m, port_m = scenario1_both
    _assert_matches_golden(mk.summarize(ref_m), spec, 0.0)
    _assert_matches_golden(mk.summarize(port_m), spec, 1e-5)


def test_scenario1_full_volume_matches_reference_per_request(scenario1_both):
    """The whole slice per request: the integer fields and the never-silent
    counters exact, ``completion`` and ``transfer_used`` bit for bit."""
    _, ref_m, port_m = scenario1_both
    for f in ("outcome", "served_by", "forwards_used", "completion",
              "transfer_used"):
        x, y = np.asarray(getattr(ref_m, f)), getattr(port_m, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("overflow", "window_saturation", "event_overflow", "forwards"):
        assert int(getattr(ref_m, f)) == int(getattr(port_m, f)), f
    assert int(port_m.forwards) > 0
    assert int(port_m.overflow) == int(port_m.window_saturation) == \
        int(port_m.event_overflow) == 0
