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

Three later sections, for the telemetry plane and the sweeps:

* ``sweeps``: the vmapped ``simulate_fn`` of ``examples/fleet_sweep.py``
  (``paper/scenario1``, ``random``, capacity 4096, depth 1024, full mesh,
  no network; seeds 0-7 x ``sla_scale`` 0.5 / 0.8 / 1.0 / 2.0, cell ``s *
  4 + j``, the scan at its default sizing), once without and once with
  ``TelemetryConfig(32, 110000)`` (each cell's counts and occupancy as
  digests, its depth and busy time whole, and the whole cube of cells 0
  and 31); and the latency x bandwidth grid of
  ``examples/mobility_sweep.py:63-87`` (the hot 3-node mix,
  ``least_loaded``, capacity 256, depth 128; latency 0 / 5 / 30 / 120 x
  bandwidth inf / 1.25 / 0.3125, cell ``i * 3 + j``);
* ``telemetry``: ``paper/scenario1..3`` as in ``runs``
  (``batched_feasible``, campus) with ``TelemetryConfig(32, end_time)``,
  the end time of that run: the whole cube;
* ``validation_telemetry``: the reference's ``run_validation(...,
  telemetry=32)`` on ``paper/scenario1..3``, campus, seed 0, under
  ``random``: the report's fields as in ``validation`` and its
  ``TelemetryAgreement``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py \
        [--only NAME ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.scenarios import SCENARIOS
from repro.fleetsim import (NetParams, SimParams, event_bound, simulate,
                            simulate_fn, topology_arrays)
from repro.netsim import LinkModel, RadioModel, RadioWorkload
from repro.orchestration import (DiurnalWorkload, PoissonWorkload, Topology,
                                 UniformWorkload, get_workload)
from repro.telemetry import TelemetryConfig

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
# the 256-node fleet of benchmarks/fleetsim_bench.py, as bench_fleetsim
# runs it
FLEET256 = tuple(
    dict(name=f"fleet256_div4@{policy}", workload={"fleet": 256, "div": 4},
         n_nodes=256, capacity=1024, depth=512, policy=policy, net=None,
         path="jnp")
    for policy in ("random", "least_loaded", "batched_feasible"))
RUNS = RUNS + FLEET256
PATH_CHECKED = "fleet32_div4"
# the arrival processes of examples/custom_topologies.py:80-85 and the
# radio workloads of examples/mobility_sweep.py:53-59, each described whole
# in its entry (the port builds it from there)
HORIZON = 110_000.0
KINDS = dict(
    poisson=dict(kind="poisson", scenario=1, horizon=HORIZON),
    diurnal=dict(kind="diurnal", scenario=1, window=HORIZON, peaks=2,
                 amplitude=0.8),
    radio_static=dict(kind="radio", base="paper/scenario1", link=NET),
    radio_mobile=dict(kind="radio", base="paper/scenario1", link=NET,
                      mobility=dict(n_ues=3, horizon=HORIZON,
                                    handovers_per_ue=3.0, seed=0)))
WORKLOADS = tuple(
    dict(name=f"{kind}@{policy}", workload=KINDS[kind], n_nodes=3,
         capacity=4096, depth=1024, policy=policy)
    for kind in KINDS for policy in ("batched_feasible", "random"))
INT_AGGREGATES = ("total", "processed", "met_deadline", "forwards",
                  "discarded", "overflow", "window_saturation",
                  "event_overflow")
FLOAT_AGGREGATES = ("mean_response_time", "end_time", "transfer_time")
DIGESTS = ("outcome", "served_by", "forwards_used")
VALIDATED = ("batched_feasible", "round_robin") + STOCHASTIC
VALIDATED_SCENARIOS = ("paper/scenario1", "paper/scenario2",
                       "paper/scenario3")
REPORT_COUNTS = ("met_deadline", "processed", "forwards", "discarded")
# the sweeps of examples/fleet_sweep.py and examples/mobility_sweep.py
PAPER_SWEEP = dict(scenario="paper/scenario1", policy="random",
                   capacity=4096, depth=1024, seeds=list(range(8)),
                   sla_scales=[0.5, 0.8, 1.0, 2.0])
SWEEP_TELEMETRY = dict(n_buckets=32, horizon=110_000.0)
WHOLE_CUBES = (0, 31)
NET_GRID = dict(counts=[{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3,
                window=1200.0, policy="least_loaded", capacity=256,
                depth=128, latency=[0.0, 5.0, 30.0, 120.0],
                bandwidth=["inf", 1.25, 0.3125])
TELEMETRY_BUCKETS = 32


def reference_workload(spec: Dict):
    """The JAX package's workload for a run spec (the fleet regime is
    ``benchmarks/fleetsim_bench.py::make_fleet_workload``)."""
    if "registry" in spec:
        return get_workload(spec["registry"])
    if "kind" in spec:
        return new_workload(spec)
    n, div = spec["fleet"], spec["div"]
    counts = [{s: max(1, c // div) for s, c in SCENARIOS[1][i % 3].items()}
              for i in range(n)]
    return UniformWorkload(counts, window=110_000.0 / div,
                           name=f"fleet{n}_div{div}")


def new_workload(w: Dict):
    """The reference's workload of a ``workloads`` entry."""
    if w["kind"] == "poisson":
        return PoissonWorkload.from_counts(SCENARIOS[w["scenario"]],
                                           horizon=w["horizon"])
    if w["kind"] == "diurnal":
        return DiurnalWorkload(SCENARIOS[w["scenario"]], window=w["window"],
                               peaks=w["peaks"], amplitude=w["amplitude"])
    base = get_workload(w["base"])
    link = LinkModel.preset(Topology.full_mesh(base.n_nodes), w["link"])
    radio = RadioModel.from_link(link)
    if "mobility" in w:
        radio = radio.with_random_mobility(**w["mobility"])
    return RadioWorkload(base, radio, link=link)


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


def run_reference(spec: Dict, max_events=None, telemetry=None,
                  use_pallas=None):
    """``repro.fleetsim.simulate`` on one run spec (``use_pallas`` defaults
    to the spec's ``path``)."""
    reqs, _ = reference_workload(spec["workload"]).to_arrays(SEED)
    reqs = first(reqs, spec["workload"])
    topo = Topology.full_mesh(spec["n_nodes"])
    net = spec.get("net", NET)
    if use_pallas is None:
        use_pallas = spec.get("path", "pallas") == "pallas"
    return simulate(reqs, topology_arrays(topo), SimParams.make(SEED),
                    policy=spec.get("policy", POLICY),
                    max_forwards=MAX_FORWARDS,
                    capacity=spec["capacity"], depth=spec["depth"],
                    use_pallas=use_pallas,
                    net=None if net is None
                    else LinkModel.preset(topo, net).net_params(),
                    max_events=max_events, telemetry=telemetry)


def sized_run(spec: Dict) -> Dict:
    """One run sized as ``bench_fleetsim`` sizes it: a probe at the
    worst-case event bound, then ``max_events = min(3R, R + 4 * forwards
    + 256)`` (the probe itself where that is the bound)."""
    probe = run_reference(spec)
    R = int(probe.total)
    bound = event_bound(R, MAX_FORWARDS)
    max_events = min(bound, R + 4 * int(probe.forwards) + 256)
    m = probe if max_events == bound else run_reference(spec, max_events)
    got = checked(spec["name"], summarize(m))
    print(spec["name"], got["aggregates"], file=sys.stderr)
    return dict(spec, max_events=max_events, **got)


def path_agreement(runs) -> Dict:
    """The jnp path on a run the Pallas path produced: whether its
    digests, aggregates and floats are the Pallas path's."""
    spec = next(r for r in runs if r["name"] == PATH_CHECKED)
    got = summarize(run_reference(spec, spec["max_events"],
                                  use_pallas=False))
    want = {k: spec[k] for k in ("aggregates", "floats", "digests")}
    differ = sorted(f"{part}.{k}" for part in want for k in want[part]
                    if got[part][k] != want[part][k])
    print(PATH_CHECKED, "jnp path differs on", differ or "nothing",
          file=sys.stderr)
    return {PATH_CHECKED: dict(jnp_equals_pallas=not differ, differ=differ,
                               jnp=got)}


def radio_validation() -> list:
    """The reference's ``run_validation`` on the mobile radio workload
    under ``random``."""
    from repro.fleetsim.validate import run_validation
    wl = new_workload(KINDS["radio_mobile"])
    rep = run_validation(wl, SEED, policy="random",
                         network=LinkModel.preset(Topology.full_mesh(3), NET))
    print(rep.row(), file=sys.stderr)
    return [dict(workload=KINDS["radio_mobile"], policy="random",
                 exact=rep.exact,
                 outcome_mismatches=rep.outcome_mismatches,
                 node_mismatches=rep.node_mismatches, capacity=rep.capacity,
                 host={k: int(rep.host[k]) for k in REPORT_COUNTS},
                 fleet={k: int(rep.fleet[k]) for k in REPORT_COUNTS})]


def cell_of(m, c: int):
    """Cell ``c`` of vmapped metrics."""
    return jax.tree_util.tree_map(lambda x: x[c], m)


def checked(name: str, got: Dict) -> Dict:
    bad = {k: got["aggregates"][k] for k in
           ("overflow", "window_saturation", "event_overflow")
           if got["aggregates"][k]}
    if bad:
        raise SystemExit(f"{name}: undersized run {bad}")
    return got


def cube(frame) -> Dict:
    """One cell's telemetry cube, whole."""
    return dict(counts=np.asarray(frame.counts).tolist(),
                occupancy_hwm=np.asarray(frame.occupancy_hwm).tolist(),
                queue_depth=np.asarray(frame.queue_depth).tolist(),
                busy_time=np.asarray(frame.busy_time).tolist(),
                bucket_width=float(frame.bucket_width))


def paper_sweep(telemetry) -> list:
    """examples/fleet_sweep.py's 32 cells as one vmapped call."""
    sp = PAPER_SWEEP
    wl = get_workload(sp["scenario"])
    reqs, _ = wl.to_arrays(SEED)
    R = reqs.arrival.shape[0]
    run = simulate_fn(policy=sp["policy"], max_forwards=MAX_FORWARDS,
                      capacity=sp["capacity"], depth=sp["depth"],
                      telemetry=telemetry)
    seeds, scales = np.meshgrid(np.asarray(sp["seeds"], np.int32),
                                np.asarray(sp["sla_scales"], np.float32),
                                indexing="ij")
    m = jax.vmap(run, in_axes=(None, None, SimParams(0, 0), None))(
        reqs, topology_arrays(Topology.full_mesh(wl.n_nodes)),
        SimParams(jnp.asarray(seeds.ravel()), jnp.asarray(scales.ravel())),
        jnp.full((R, MAX_FORWARDS), -1, jnp.int32))
    cells = []
    for c in range(seeds.size):
        mc = cell_of(m, c)
        got = checked(f"sweep cell {c}", summarize(mc))
        if telemetry is not None:
            tel = dict(counts=digest(np.asarray(mc.telemetry.counts)),
                       occupancy_hwm=digest(
                           np.asarray(mc.telemetry.occupancy_hwm)),
                       queue_depth=np.asarray(
                           mc.telemetry.queue_depth).tolist(),
                       busy_time=np.asarray(mc.telemetry.busy_time).tolist())
            if c in WHOLE_CUBES:
                tel["whole"] = cube(mc.telemetry)
            got = dict(telemetry=tel)
        cells.append(dict(seed=int(seeds.ravel()[c]),
                          sla_scale=float(scales.ravel()[c]), **got))
    print(f"sweep: {len(cells)} cells, telemetry {telemetry}",
          file=sys.stderr)
    return cells


def net_grid() -> list:
    """examples/mobility_sweep.py's latency x bandwidth grid."""
    g = NET_GRID
    K = len(g["counts"])
    reqs, _ = UniformWorkload(g["counts"], window=g["window"],
                              name="hot").to_arrays(SEED)
    R = reqs.arrival.shape[0]
    nets = [NetParams.uniform(K, lam, 0.0 if bw == "inf" else 1.0 / bw)
            for lam in g["latency"] for bw in g["bandwidth"]]
    run = simulate_fn(policy=g["policy"], max_forwards=MAX_FORWARDS,
                      capacity=g["capacity"], depth=g["depth"], network=True)
    m = jax.vmap(run, in_axes=(None, None, None, None, 0))(
        reqs, topology_arrays(Topology.full_mesh(K)), SimParams.make(SEED),
        jnp.full((R, MAX_FORWARDS), -1, jnp.int32),
        NetParams(latency=jnp.stack([n.latency for n in nets]),
                  inv_bw=jnp.stack([n.inv_bw for n in nets])))
    return [dict(latency=lam, bandwidth=bw, **checked(
        f"net grid {lam} {bw}", summarize(cell_of(m, i * len(g["bandwidth"])
                                                  + j))))
            for i, lam in enumerate(g["latency"])
            for j, bw in enumerate(g["bandwidth"])]


def telemetry_runs(runs) -> list:
    """``paper/scenario1..3`` of ``runs`` with the telemetry cube over
    [0, end_time) of that run."""
    out = []
    for spec in runs:
        if spec["name"] not in VALIDATED_SCENARIOS:
            continue
        horizon = spec["floats"]["end_time"]
        m = run_reference(spec, spec["max_events"], TelemetryConfig(
            TELEMETRY_BUCKETS, horizon))
        if summarize(m) != {k: spec[k] for k in
                            ("aggregates", "floats", "digests")}:
            raise SystemExit(f"{spec['name']}: the telemetry run differs "
                             "from the plain one")
        out.append(dict(name=spec["name"], n_buckets=TELEMETRY_BUCKETS,
                        horizon=horizon, **cube(m.telemetry)))
        print(spec["name"], "telemetry", file=sys.stderr)
    return out


def validation_reports(policies=VALIDATED, telemetry=None):
    """The reference's ``run_validation`` on each (scenario, policy) cell:
    the fields the port's report must equal (with ``telemetry``, its
    ``TelemetryAgreement`` too)."""
    from repro.fleetsim.validate import run_validation
    out = []
    for scenario in VALIDATED_SCENARIOS:
        topo = Topology.full_mesh(get_workload(scenario).n_nodes)
        for policy in policies:
            rep = run_validation(scenario, SEED, policy=policy,
                                 network=LinkModel.preset(topo, NET),
                                 telemetry=telemetry)
            out.append(dict(
                scenario=scenario, policy=policy, exact=rep.exact,
                outcome_mismatches=rep.outcome_mismatches,
                node_mismatches=rep.node_mismatches, capacity=rep.capacity,
                host={k: int(rep.host[k]) for k in REPORT_COUNTS},
                fleet={k: int(rep.fleet[k]) for k in REPORT_COUNTS}))
            if telemetry is not None:
                out[-1].update(n_buckets=telemetry,
                               telemetry=dataclasses.asdict(rep.telemetry),
                               telemetry_ok=rep.telemetry.ok)
            print(rep.row(), file=sys.stderr)
    return out


SECTIONS = ("sweeps", "validation_telemetry", "workloads",
            "validation_radio", "runs", "paths", "validation", "telemetry")


def save(out: Dict) -> None:
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    tmp = GOLDEN + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    os.replace(tmp, GOLDEN)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", metavar="NAME", default=(),
                    help="recompute these sections or runs and keep the "
                         f"rest of the file (sections: {SECTIONS})")
    only = set(ap.parse_args().only)
    run_names = [spec["name"] for spec in RUNS]
    unknown = only - set(SECTIONS) - set(run_names)
    if unknown:
        raise SystemExit(f"unknown sections or runs: {sorted(unknown)}")
    out = dict(policy=POLICY, net=NET, seed=SEED, topology="full_mesh",
               max_forwards=MAX_FORWARDS,
               reference="repro.fleetsim.simulate(use_pallas=True), "
                         "JAX on the CPU",
               runs=[])
    if only:
        with open(GOLDEN) as f:
            out.update(json.load(f))
    rerun = [n for n in run_names if not only or "runs" in only or n in only]

    # the newest sections first: they fail before the long runs; the file
    # is written after each section
    for section in SECTIONS:
        if only and section not in only and not (section == "runs"
                                                 and rerun):
            continue
        if section == "sweeps":
            out[section] = dict(
                net_grid=dict(NET_GRID, cells=net_grid()),
                paper=dict(PAPER_SWEEP, cells=paper_sweep(None)),
                paper_telemetry=dict(PAPER_SWEEP, **SWEEP_TELEMETRY,
                                     whole_cubes=list(WHOLE_CUBES),
                                     cells=paper_sweep(TelemetryConfig(
                                         **SWEEP_TELEMETRY))))
        elif section == "validation_telemetry":
            out[section] = validation_reports(("random",), TELEMETRY_BUCKETS)
        elif section == "workloads":
            out[section] = [sized_run(spec) for spec in WORKLOADS]
        elif section == "validation_radio":
            out[section] = radio_validation()
        elif section == "runs":
            kept = {r["name"]: r for r in out["runs"]}
            for spec in RUNS:
                if spec["name"] in rerun:
                    kept[spec["name"]] = sized_run(spec)
                    out["runs"] = [kept[n] for n in run_names if n in kept]
                    save(out)
        elif section == "paths":
            out[section] = path_agreement(out["runs"])
        elif section == "validation":
            out[section] = validation_reports()
        elif section == "telemetry":
            out[section] = telemetry_runs(out["runs"])
        save(out)


if __name__ == "__main__":
    main()
