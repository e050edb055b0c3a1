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
Of the entries under the stochastic policies, the port recomputes
``paper/scenario3@random`` in tests/test_torch_golden_stochastic.py (the
full-volume runs here already take most of a minute); ``chip_smoke.py``
holds the card to all of them, to the 256-node fleet's three runs (the
reference's jnp path, which ``paths`` shows gives the Pallas path's
digests on ``fleet32_div4``) and to the ``workloads`` section's eight
runs on the other arrival processes and the radio model, whose request
arrays the port's workloads reproduce here.
"""
import json
import os
import sys

import numpy as np
import pytest

import make_torch_golden as mk
import repro_torch.fleetsim as tfs
from repro_torch.netsim import LinkModel
from repro_torch.orchestration import Topology

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# the port's workload of a golden entry, built as the card's run builds it
from chip_smoke import workload_of as _port_workload  # noqa: E402

with open(mk.GOLDEN) as _f:
    GOLDEN = json.load(_f)
RUNS = {r["name"]: r for r in GOLDEN["runs"]}
WORKLOADS = {r["name"]: r for r in GOLDEN["workloads"]}


def _assert_sized(run):
    agg = run["aggregates"]
    assert agg["overflow"] == agg["window_saturation"] == \
        agg["event_overflow"] == 0, run["name"]
    assert agg["total"] < run["max_events"] <= 3 * agg["total"]
    assert set(run["digests"]) == set(mk.DIGESTS)


def test_golden_file_covers_the_main_path():
    assert [r["name"] for r in GOLDEN["runs"]] == [r["name"] for r in mk.RUNS]
    assert (GOLDEN["policy"], GOLDEN["net"]) == ("batched_feasible", "campus")
    drawn = [r["name"] for r in GOLDEN["runs"] if "policy" in r]
    assert drawn == [f"{n}@{p}" for p in mk.STOCHASTIC for n in (
        "paper/scenario1", "paper/scenario3", "fleet32_div4")] + [
        f"fleet256_div4@{p}"
        for p in ("random", "least_loaded", "batched_feasible")]
    for run in GOLDEN["runs"]:
        _assert_sized(run)


def test_golden_file_holds_the_256_node_fleet():
    """The 256-node, 128,000-request fleet of benchmarks/fleetsim_bench.py
    under three policies, unpriced, from the reference's jnp path, which
    gives the Pallas path's output on the 32-node fleet."""
    big = [r for r in GOLDEN["runs"] if r["name"].startswith("fleet256")]
    assert [r["policy"] for r in big] == ["random", "least_loaded",
                                          "batched_feasible"]
    for run in big:
        _assert_sized(run)
        assert run["aggregates"]["total"] == 128_000
        assert run["aggregates"]["forwards"] > 100_000
        assert (run["n_nodes"], run["capacity"], run["depth"], run["net"],
                run["path"]) == (256, 1024, 512, None, "jnp")
    path = GOLDEN["paths"]["fleet32_div4"]
    assert path["jnp_equals_pallas"] and path["differ"] == []
    want = RUNS["fleet32_div4"]
    assert all(path["jnp"][k] == want[k]
               for k in ("aggregates", "floats", "digests"))


def test_golden_file_holds_the_arrival_processes():
    """Eight runs: Poisson, diurnal and the static and mobile radio
    workloads, each under batched_feasible and random; and the
    reference's run_validation report on the mobile radio workload."""
    assert list(WORKLOADS) == [s["name"] for s in mk.WORKLOADS] == [
        f"{k}@{p}" for k in ("poisson", "diurnal", "radio_static",
                             "radio_mobile")
        for p in ("batched_feasible", "random")]
    for run in WORKLOADS.values():
        _assert_sized(run)
        assert run["aggregates"]["forwards"] > 0
    [rep] = GOLDEN["validation_radio"]
    assert (rep["workload"], rep["policy"]) == (mk.KINDS["radio_mobile"],
                                                "random")
    assert rep["exact"] and rep["host"] == rep["fleet"]
    assert rep["host"]["processed"] == 6000


@pytest.mark.parametrize("name", [s["name"] for s in mk.WORKLOADS])
def test_port_arrival_processes_reproduce_reference_arrays(name):
    spec = WORKLOADS[name]
    ja, jn = mk.reference_workload(spec["workload"]).to_arrays(
        GOLDEN["seed"])
    ta, tn = _port_workload(spec).to_arrays(GOLDEN["seed"])
    assert jn == tn and len(ta.arrival) == spec["aggregates"]["total"]
    for field, a, b in zip(ja._fields, ja, ta):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_golden_file_keeps_the_reference_validation_reports():
    """The 12 cells ``chip_smoke.py`` holds the port's ``run_validation``
    to: exact but ``paper/scenario2`` under ``round_robin``, whose 16 node
    flips stay inside the reference's own contract (<= 0.5% of requests,
    no outcome flipped)."""
    cells = GOLDEN["validation"]
    assert [(c["scenario"], c["policy"]) for c in cells] == [
        (s, p) for s in mk.VALIDATED_SCENARIOS for p in mk.VALIDATED]
    inexact = [(c["scenario"], c["policy"]) for c in cells if not c["exact"]]
    assert inexact == [("paper/scenario2", "round_robin")]
    for c in cells:
        assert c["host"] == c["fleet"], c
        assert c["outcome_mismatches"] == 0
        assert c["node_mismatches"] <= 0.005 * c["host"]["processed"]


@pytest.mark.parametrize("name", [r["name"] for r in mk.RUNS])
def test_port_workloads_reproduce_reference_arrays(name):
    spec = RUNS[name]
    ja, _ = mk.reference_workload(spec["workload"]).to_arrays(GOLDEN["seed"])
    ja = mk.first(ja, spec["workload"])
    ta, _ = _port_workload(spec).to_arrays(GOLDEN["seed"])
    ta = mk.first(ta, spec["workload"])
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


def test_port_mobile_radio_run_matches_golden():
    """One of the ``workloads`` runs recomputed by the port on the CPU:
    ``paper/scenario1`` through the mobile campus radio under
    ``batched_feasible`` (per-request deadline budgets, re-homed origins)
    at its stored sizing gives the reference's digests."""
    spec = WORKLOADS["radio_mobile@batched_feasible"]
    reqs, _ = _port_workload(spec).to_arrays(GOLDEN["seed"])
    topo = Topology.full_mesh(spec["n_nodes"])
    m = tfs.simulate(
        reqs, tfs.topology_arrays(topo), tfs.SimParams.make(GOLDEN["seed"]),
        policy=spec["policy"], max_forwards=GOLDEN["max_forwards"],
        capacity=spec["capacity"], depth=spec["depth"],
        net=LinkModel.preset(topo, spec["workload"]["link"]).net_params(),
        max_events=spec["max_events"], device="cpu")
    _assert_matches_golden(mk.summarize(m), spec, 1e-5)
