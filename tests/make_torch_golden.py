"""Write ``tests/data/torch_fleetsim_golden.json``: the JAX reference's
results on the PyTorch port's four main-path runs, and on three of them
under the stochastic forwarding policies.

Not a test (it imports JAX): it produces the file the port is held
against — by ``tests/test_torch_golden.py`` on the CPU and by
``chip_smoke.py`` on the GPU, which cannot import JAX.  Each run is
seed 0 on a full mesh under the ``campus`` link profile with the
``batched_feasible`` policy through the Pallas ``event_select`` kernel
(interpret mode off-TPU):

* ``paper/scenario1..3`` at full volume (6,000 / 8,000 / 9,800 requests
  on 3 / 3 / 6 nodes), capacity 4096, depth 1024;
* the 32-node fleet regime of ``benchmarks/fleetsim_bench.py``
  (``make_fleet_workload(32, div=4)``: 16,000 requests), capacity 1024,
  depth 512;
* the first 8,000 requests (in arrival order) of that fleet, the run
  ``chip_smoke.py`` drove to stay inside its time budget;
* ``paper/scenario1``, ``paper/scenario3`` and the full 32-node fleet
  under ``random`` and ``power_of_two`` (the reference's default policy,
  the paper's forward to a random neighbour, and its two-choice variant,
  both drawing from ``jax.random``'s threefry), sized as above; each such
  run names its ``policy``, the others take the file's.

The file also keeps the reference's cross-validation reports
(``repro.fleetsim.validate.run_validation``: its fleet simulator against
its event heap) on ``paper/scenario1..3`` under the same pricing, with
``batched_feasible`` and ``round_robin`` replayed directly and
``random`` and ``power_of_two`` by the heap's trace: the mismatch counts
and the integer aggregates of both engines, which the port's
``run_validation`` must reproduce on the card.  All are exact but
``paper/scenario2`` under ``round_robin``, where 16 requests are served
by another node than the heap's (f32 ledgers against the heap's f64, the
flips the reference's contract allows).

Sizing follows ``bench_fleetsim``: one probe run at the worst-case event
bound measures the forwards, then ``max_events = min(R * 3, R + 4 *
forwards + 256)``; the overflow, window-saturation and event-overflow
counters must all be 0.  Per-request outcome, serving node and forwards
used are stored as sha256 digests of their int32 bytes.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Dict

import numpy as np

from repro.core.scenarios import SCENARIOS
from repro.fleetsim import SimParams, event_bound, simulate, topology_arrays
from repro.netsim import LinkModel
from repro.orchestration import Topology, UniformWorkload, get_workload

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_fleetsim_golden.json")
POLICY, NET, SEED, MAX_FORWARDS = "batched_feasible", "campus", 0, 2

RUNS = (
    dict(name="paper/scenario1", workload={"registry": "paper/scenario1"},
         n_nodes=3, capacity=4096, depth=1024),
    dict(name="paper/scenario2", workload={"registry": "paper/scenario2"},
         n_nodes=3, capacity=4096, depth=1024),
    dict(name="paper/scenario3", workload={"registry": "paper/scenario3"},
         n_nodes=6, capacity=4096, depth=1024),
    dict(name="fleet32_div4", workload={"fleet": 32, "div": 4},
         n_nodes=32, capacity=1024, depth=512),
    dict(name="fleet32_div4_first8000",
         workload={"fleet": 32, "div": 4, "prefix": 8000},
         n_nodes=32, capacity=1024, depth=512),
)
STOCHASTIC = ("random", "power_of_two")
RUNS = RUNS + tuple(
    dict(base, name=f"{base['name']}@{policy}", policy=policy)
    for policy in STOCHASTIC for base in RUNS
    if base["name"] in ("paper/scenario1", "paper/scenario3", "fleet32_div4"))
INT_AGGREGATES = ("total", "processed", "met_deadline", "forwards",
                  "discarded", "overflow", "window_saturation",
                  "event_overflow")
FLOAT_AGGREGATES = ("mean_response_time", "end_time", "transfer_time")
DIGESTS = ("outcome", "served_by", "forwards_used")
VALIDATED = ("batched_feasible", "round_robin") + STOCHASTIC
VALIDATED_SCENARIOS = ("paper/scenario1", "paper/scenario2",
                       "paper/scenario3")
REPORT_COUNTS = ("met_deadline", "processed", "forwards", "discarded")


def reference_workload(spec: Dict):
    """The JAX package's workload for a run spec (the fleet regime is
    ``benchmarks/fleetsim_bench.py::make_fleet_workload``)."""
    if "registry" in spec:
        return get_workload(spec["registry"])
    n, div = spec["fleet"], spec["div"]
    counts = [{s: max(1, c // div) for s, c in SCENARIOS[1][i % 3].items()}
              for i in range(n)]
    return UniformWorkload(counts, window=110_000.0 / div,
                           name=f"fleet{n}_div{div}")


def first(reqs, spec: Dict):
    """The request arrays cut to the spec's ``prefix`` (the first requests
    in arrival order), or whole."""
    n = spec.get("prefix")
    return reqs if n is None else type(reqs)(*(a[:n] for a in reqs))


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.int32).tobytes()
                          ).hexdigest()


def summarize(m) -> Dict:
    """The golden fields of one run's metrics (either package's)."""
    return dict(
        aggregates={k: int(getattr(m, k)) for k in INT_AGGREGATES},
        floats={k: float(getattr(m, k)) for k in FLOAT_AGGREGATES},
        digests={k: digest(np.asarray(getattr(m, k))) for k in DIGESTS})


def run_reference(spec: Dict, max_events=None):
    """``repro.fleetsim.simulate`` on one run spec."""
    reqs, _ = reference_workload(spec["workload"]).to_arrays(SEED)
    reqs = first(reqs, spec["workload"])
    topo = Topology.full_mesh(spec["n_nodes"])
    return simulate(reqs, topology_arrays(topo), SimParams.make(SEED),
                    policy=spec.get("policy", POLICY),
                    max_forwards=MAX_FORWARDS,
                    capacity=spec["capacity"], depth=spec["depth"],
                    use_pallas=True,
                    net=LinkModel.preset(topo, NET).net_params(),
                    max_events=max_events)


def validation_reports():
    """The reference's ``run_validation`` on each (scenario, policy) cell:
    the fields the port's report must equal."""
    from repro.fleetsim.validate import run_validation
    out = []
    for scenario in VALIDATED_SCENARIOS:
        topo = Topology.full_mesh(get_workload(scenario).n_nodes)
        for policy in VALIDATED:
            rep = run_validation(scenario, SEED, policy=policy,
                                 network=LinkModel.preset(topo, NET))
            out.append(dict(
                scenario=scenario, policy=policy, exact=rep.exact,
                outcome_mismatches=rep.outcome_mismatches,
                node_mismatches=rep.node_mismatches, capacity=rep.capacity,
                host={k: int(rep.host[k]) for k in REPORT_COUNTS},
                fleet={k: int(rep.fleet[k]) for k in REPORT_COUNTS}))
            print(rep.row(), file=sys.stderr)
    return out


def main() -> None:
    out = dict(policy=POLICY, net=NET, seed=SEED, topology="full_mesh",
               max_forwards=MAX_FORWARDS,
               reference="repro.fleetsim.simulate(use_pallas=True), "
                         "JAX on the CPU",
               runs=[])
    for spec in RUNS:
        probe = run_reference(spec)
        R = int(probe.total)
        max_events = min(event_bound(R, MAX_FORWARDS),
                         R + 4 * int(probe.forwards) + 256)
        m = run_reference(spec, max_events)
        got = summarize(m)
        bad = {k: got["aggregates"][k] for k in
               ("overflow", "window_saturation", "event_overflow")
               if got["aggregates"][k]}
        if bad:
            raise SystemExit(f"{spec['name']}: undersized run {bad}")
        out["runs"].append(dict(spec, max_events=max_events, **got))
        print(spec["name"], got["aggregates"], file=sys.stderr)
    out["validation"] = validation_reports()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
