"""The port's telemetry plane (``repro_torch.telemetry`` and the telemetry
cube of ``repro_torch.fleetsim.simulate``, on the CPU) against the JAX
reference's (``repro.telemetry``, ``repro.fleetsim.simulate(...,
telemetry=...)`` under ``jax.jit``).

Both packages pack their own copies of the same workloads.  Bar, the
reference's own contract (DESIGN.md §8): event-kind counters and
occupancy high-water marks exactly; the derived integrals (queue depth,
busy time) within ``summary.DERIVED_ATOL`` through ``compare_summaries``
(a sum order, and XLA's fused multiply-adds in the bucket edges, may move
them by an ulp); every other output bit for bit against the run without
telemetry.  Binning is checked on event times that land exactly on
bucket edges ``k·w``, against the jitted reference, not only its numpy
mirror.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fleetsim as jfs
import repro.telemetry as jtel
from repro.core.block_queue import FastPreferentialQueue as JFast
from repro.core.request import Request as JRequest, SERVICES as JSERVICES
from repro.fleetsim.validate import run_validation as j_run_validation
from repro.netsim import LinkModel as JLinkModel
from repro.orchestration import (Orchestrator as JOrchestrator,
                                 Router as JRouter, Topology as JTopology,
                                 UniformWorkload as JUniformWorkload,
                                 Workload as JWorkload)
import repro_torch.fleetsim as tfs
import repro_torch.telemetry as ttel
from repro_torch.core.block_queue import FastPreferentialQueue as TFast
from repro_torch.core.request import Request as TRequest, SERVICES as TSERVICES
from repro_torch.fleetsim import core, validate
from repro_torch.netsim import LinkModel as TLinkModel
from repro_torch.orchestration import (Orchestrator as TOrchestrator,
                                       Router as TRouter,
                                       Topology as TTopology,
                                       UniformWorkload as TUniformWorkload,
                                       Workload as TWorkload)

# tests/test_telemetry.py's HOT fleet: 3 nodes deep in overload
HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
JHOT = JUniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
THOT = TUniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
POLICIES = ("random", "power_of_two", "least_loaded", "round_robin",
            "batched_feasible", "trace")
# a bucket width that is no power of two: 1000 / 7 in f32
EDGE_NB, EDGE_HORIZON = 7, 1000.0
SHARED = ("outcome", "served_by", "forwards_used", "completion",
          "transfer_used", "met_deadline", "processed", "forwards",
          "discarded", "overflow", "window_saturation", "event_overflow",
          "mean_response_time", "end_time", "transfer_time")


def _summary(frame):
    """A ``TelemetrySummary`` (the port's) of either package's frame."""
    return ttel.TelemetrySummary.from_frame(ttel.TelemetryFrame(
        *(t if torch.is_tensor(t) else torch.tensor(np.asarray(t))
          for t in frame)))


def _assert_cube(a, b):
    """The reference's cube ``a`` against the port's ``b``: counters and
    occupancy exactly, the derived integrals within DERIVED_ATOL."""
    ja, tb = _summary(a.telemetry), _summary(b.telemetry)
    assert np.array_equal(ja.counts, tb.counts)
    assert np.array_equal(ja.occupancy_hwm, tb.occupancy_hwm)
    assert ja.bucket_width == tb.bucket_width
    agr = ttel.compare_summaries(ja, tb)
    assert agr.ok, agr.row()
    return agr


def _edge_workload(Workload, Request, services):
    """Three requests a node at every bucket edge k·w (f32), k < NB, with
    the hot fleet's services: every event of the first hop lands on an
    edge."""
    w = np.float32(np.float32(EDGE_HORIZON) / np.float32(EDGE_NB))

    class _Edges(Workload):
        name = "edges"
        n_nodes = 3

        def generate(self, seed):
            return self._finish([
                Request(service=services[name],
                        arrival_time=float(np.float32(k) * w),
                        origin_node=node)
                for k in range(EDGE_NB) for node in range(3)
                for name in ("S1", "S5", "S4")])
    return _Edges()


def _run_both(jwl, twl, policy, net, telemetry, **kw):
    ja, _ = jwl.to_arrays(0)
    ta, _ = twl.to_arrays(0)
    jtopo, ttopo = JTopology.full_mesh(3), TTopology.full_mesh(3)
    jnet = tnet = None
    if net is not None:
        jnet = JLinkModel.preset(jtopo, net).net_params()
        tnet = TLinkModel.preset(ttopo, net).net_params()
    targets = None
    if policy == "trace":
        targets = np.random.default_rng(1).integers(
            -1, 3, (ja.arrival.shape[0], 2)).astype(np.int32)
    kw = dict(policy=policy, capacity=512, depth=256, targets=targets, **kw)
    a = jfs.simulate(ja, jfs.topology_arrays(jtopo), net=jnet,
                     use_pallas=policy == "batched_feasible",
                     telemetry=jtel.TelemetryConfig(*telemetry), **kw)
    b = tfs.simulate(ta, tfs.topology_arrays(ttopo), net=tnet, device="cpu",
                     telemetry=ttel.TelemetryConfig(*telemetry), **kw)
    return a, b


# ---------------------------------------------------------------------------
# binning primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("horizon,nb", [(EDGE_HORIZON, EDGE_NB),
                                        (3437.25, 13), (123456.7, 64)])
def test_bucket_of_matches_reference_on_edges(horizon, nb):
    """``bucket_of`` (torch) and ``bucket_of_np`` equal the jitted
    reference on every edge k·w, four ulps either side, random times,
    past the horizon, a negative time and the +BIG sentinel.  The jitted
    reference multiplies by f32(1 / w): its own ``bucket_of_np``, which
    divides, differs from it just below some edges, and the port follows
    the compiled form."""
    w = ttel.bucket_width(horizon, nb)
    assert w == jtel.bucket_width(horizon, nb)
    edges = np.arange(nb + 2, dtype=np.float32) * w
    near = [edges]
    for direction in (-1e30, 1e30):
        e = edges
        for _ in range(4):
            e = np.nextafter(e, np.float32(direction))
            near.append(e)
    rng = np.random.default_rng(nb)
    ts = np.concatenate(near + [
        rng.uniform(0, 1.1 * horizon, 20000).astype(np.float32),
        np.asarray([-3.0, 5 * horizon, 1e30], np.float32)])
    ref = np.asarray(jax.jit(lambda t: jtel.bucket_of(t, w, nb))(
        jnp.asarray(ts)))
    got = ttel.bucket_of(torch.from_numpy(ts), w, nb)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(ttel.bucket_of_np(ts, w, nb), ref)
    assert ref[-1] == nb - 1 and ref[-3] == 0
    if nb == EDGE_NB:        # where the reference's numpy mirror divides
        finite = ts < 1e29
        assert np.sum(jtel.bucket_of_np(ts[finite], w, nb)
                      != ref[finite]) > 0


@pytest.mark.parametrize("cells", [None, 3])
def test_interval_histogram_matches_reference(cells):
    """The derived integral, one run or a (C, R) cell axis, against the
    jitted reference (vmapped for cells): within DERIVED_ATOL of a
    bucket; the numpy mirrors equal each other exactly."""
    rng = np.random.default_rng(7)
    C, R, K = cells or 1, 200, 4
    w = ttel.bucket_width(EDGE_HORIZON, EDGE_NB)
    lo = rng.uniform(-50, 1100, (C, R)).astype(np.float32)
    hi = (lo + rng.uniform(-20, 300, (C, R))).astype(np.float32)
    lo[:, :10] = np.arange(10, dtype=np.float32) * w      # on the edges
    node = rng.integers(0, K, (C, R)).astype(np.int32)
    valid = rng.random((C, R)) < 0.8
    node[~valid] = -1
    fn = lambda a, b, n, v: jtel.interval_histogram(a, b, n, v, K, w,
                                                    EDGE_NB)
    if cells:
        fn = jax.vmap(fn)
    else:
        lo, hi, node, valid = lo[0], hi[0], node[0], valid[0]
    ref = np.asarray(jax.jit(fn)(lo, hi, node, valid))
    got = ttel.interval_histogram(
        *(torch.from_numpy(x) for x in (lo, hi, node, valid)), K, w,
        EDGE_NB)
    assert got.shape == ref.shape == ((C,) if cells else ()) + (K, EDGE_NB)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=ttel.DERIVED_ATOL * w)
    one = (lo, hi, node, valid) if not cells else \
        tuple(x[0] for x in (lo, hi, node, valid))
    assert np.array_equal(ttel.interval_histogram_np(*one, K, w, EDGE_NB),
                          jtel.interval_histogram_np(*one, K, w, EDGE_NB))


# ---------------------------------------------------------------------------
# the carried and derived halves through simulate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", [None, "campus"])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_cube_matches_reference(policy, net):
    """The hot fleet binned into 16 buckets of its 3000-UT run."""
    a, b = _run_both(JHOT, THOT, policy, net, (16, 3000.0))
    _assert_cube(a, b)
    assert np.array_equal(np.asarray(a.outcome), b.outcome.numpy())
    counts = b.telemetry.counts.sum((0, 1))
    assert int(counts[ttel.KIND_ARRIVAL]) == int(b.total)
    assert int(counts[ttel.KIND_FORWARD]) == int(b.forwards) > 0
    assert int(counts[ttel.KIND_REARRIVAL]) == int(b.forwards)
    assert int(counts[ttel.KIND_SERVE]) == int(b.processed)


@pytest.mark.parametrize("net", [None, "campus"])
@pytest.mark.parametrize("policy", ["round_robin", "random"])
def test_events_on_bucket_edges_bin_as_the_reference(policy, net):
    """Arrivals exactly on the bucket edges k·w of a width that is no power
    of two: the same bucket as the jitted reference, each one."""
    a, b = _run_both(_edge_workload(JWorkload, JRequest, JSERVICES),
                     _edge_workload(TWorkload, TRequest, TSERVICES),
                     policy, net, (EDGE_NB, EDGE_HORIZON))
    _assert_cube(a, b)
    arrivals = b.telemetry.counts[..., ttel.KIND_ARRIVAL]
    assert torch.equal(arrivals, torch.full((3, EDGE_NB), 3,
                                            dtype=torch.int32))


def test_discard_variant_cube_matches_reference():
    a, b = _run_both(JHOT, THOT, "least_loaded", "campus", (12, 2500.0),
                     discard_on_exhaust=True)
    _assert_cube(a, b)
    assert int(b.telemetry.counts[..., ttel.KIND_DISCARD].sum()) == \
        int(b.discarded) > 0


def test_telemetry_off_is_bit_identical_and_allocates_nothing(monkeypatch):
    """The run with the cube equals the run without on every shared output;
    without it, no step sees a telemetry tensor and none is made."""
    ta, _ = THOT.to_arrays(0)
    topo = tfs.topology_arrays(TTopology.full_mesh(3))
    kw = dict(policy="batched_feasible", capacity=512, depth=256,
              net=TLinkModel.campus(TTopology.full_mesh(3)).net_params(),
              device="cpu")
    on = tfs.simulate(ta, topo, telemetry=ttel.TelemetryConfig(8, 3000.0),
                      **kw)
    real, steps = core._estep, []

    def spy(state, run):
        assert state.tel_counts is None and state.tel_occ is None
        assert run.tel_w is None
        steps.append(1)
        return real(state, run)

    def refuse(*a, **k):
        raise AssertionError("telemetry_init called with telemetry off")

    monkeypatch.setattr(core, "_estep", spy)
    monkeypatch.setattr(core, "telemetry_init", refuse)
    monkeypatch.setattr(core, "interval_histogram", refuse)
    off = tfs.simulate(ta, topo, **kw)
    # every live step, and the one that finds no event
    assert len(steps) == off.events + 1 > 1 and off.telemetry is None
    for f in SHARED:
        x, y = getattr(on, f), getattr(off, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert (on.events, on.retire_iterations) == (off.events,
                                                 off.retire_iterations)


def test_frame_types_and_views():
    a, b = _run_both(JHOT, THOT, "least_loaded", None, (10, 3000.0))
    fr = b.telemetry
    assert fr.counts.dtype == fr.occupancy_hwm.dtype == torch.int32
    assert fr.queue_depth.dtype == fr.busy_time.dtype == torch.float32
    assert float(fr.bucket_width) == float(a.telemetry.bucket_width)
    util = fr.utilization
    assert util.shape == (3, 10) and float(util.max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(util.numpy(),
                               np.asarray(a.telemetry.utilization),
                               atol=ttel.DERIVED_ATOL)
    s = _summary(fr)
    assert s.kind_totals()["serve"] == int(b.processed)
    assert len(s.depth_heatmap().splitlines()) == 4


# ---------------------------------------------------------------------------
# the host recorder
# ---------------------------------------------------------------------------
def _recorded(policy="random", net="campus"):
    """Both heaps on the hot fleet, each with its package's recorder."""
    out = []
    for Topo, Link, Rec, Orch, Q, Router, wl, dev in (
            (JTopology, JLinkModel, jtel.TraceRecorder, JOrchestrator, JFast,
             JRouter, JHOT, {}),
            (TTopology, TLinkModel, ttel.TraceRecorder, TOrchestrator, TFast,
             TRouter, THOT, {"device": "cpu"})):
        topo = Topo.full_mesh(3)
        link = Link.preset(topo, net) if net else None
        rec = Rec(network=link)
        requests = wl.generate(0)
        result = Orch(topo, Q, Router(topo, policy, seed=0, **dev),
                      network=link, hooks=rec.hooks).run(requests)
        out.append((rec, requests, result, topo))
    return out


def _dense(trace, requests):
    """The trace with each request id replaced by the request's index in
    the workload (each package numbers requests from its own counter)."""
    idx = {r.rid: j for j, r in enumerate(requests)}
    rename = lambda name: re.sub(r"r(\d+)", lambda g: f"r{idx[int(g[1])]}",
                                 name)
    events = []
    for e in trace["traceEvents"]:
        e = dict(e, name=rename(e["name"]))
        if "rid" in e.get("args", {}):
            e["args"] = dict(e["args"], rid=idx[e["args"]["rid"]])
        events.append(json.dumps(e, sort_keys=True))
    return dict(trace, traceEvents=events)


def test_chrome_trace_equals_reference():
    """The export of both heaps' runs, event for event (request ids as
    workload indices)."""
    (jrec, jreq, jres, jtopo), (trec, treq, tres, ttopo) = _recorded()
    a = jrec.chrome_trace(jreq, jtopo)
    b = trec.chrome_trace(treq, ttopo)
    da, db = _dense(a, jreq), _dense(b, treq)
    assert len(da["traceEvents"]) == len(db["traceEvents"])
    diff = [(x, y) for x, y in zip(da["traceEvents"], db["traceEvents"])
            if x != y]
    assert not diff, diff[:2]
    assert {k: v for k, v in da.items() if k != "traceEvents"} == \
        {k: v for k, v in db.items() if k != "traceEvents"}
    n = ttel.validate_chrome_trace(b)
    assert n == jtel.validate_chrome_trace(a) == len(b["traceEvents"])
    wires = [e for e in b["traceEvents"] if e["name"].startswith("fwd ")]
    assert len(wires) == tres.forwards > 0


def test_trace_write_round_trips(tmp_path):
    (_, _, _, _), (rec, requests, result, topo) = _recorded("least_loaded",
                                                            None)
    path = tmp_path / "trace.json"
    trace = rec.write(str(path), requests, topo)
    assert json.loads(path.read_text()) == trace
    assert ttel.validate_chrome_trace(trace) == len(trace["traceEvents"])


GARBAGE = [
    [], {"traceEvents": "nope"}, {"traceEvents": [3]},
    {"traceEvents": [dict(ph="Z", pid=0, ts=0, name="x")]},
    {"traceEvents": [dict(ph="X", pid=0, ts=-1.0, name="x", dur=1.0)]},
    {"traceEvents": [dict(ph="X", ts=0.0, name="x", dur=1.0)]},
    {"traceEvents": [dict(ph="i", pid=0, ts=1.0)]},
    {"traceEvents": [dict(ph="X", pid=0, ts=1.0, name="x", dur="1")]},
    {"traceEvents": [dict(ph="X", pid=0, ts=1.0, name="x")]},
]


@pytest.mark.parametrize("trace", GARBAGE)
def test_chrome_trace_validator_rejects_what_the_reference_rejects(trace):
    with pytest.raises(ValueError) as want:
        jtel.validate_chrome_trace(trace)
    with pytest.raises(ValueError) as got:
        ttel.validate_chrome_trace(trace)
    assert str(got.value) == str(want.value)


def test_recorder_summary_matches_reference():
    """The host summary of both heaps on the same run: counters and
    occupancy exactly (the port's event chain fuses each hop's delay as
    the fleet run does; the reference's rounds twice, which moves no
    event across an edge here), the integrals within DERIVED_ATOL."""
    (jrec, jreq, jres, jtopo), (trec, treq, tres, ttopo) = _recorded()
    horizon = float(tres.end_time)
    a = jrec.summary(jreq, jtopo, 16, horizon)
    b = trec.summary(treq, ttopo, 16, horizon)
    assert np.array_equal(a.counts, b.counts)
    assert np.array_equal(a.occupancy_hwm, b.occupancy_hwm)
    assert ttel.compare_summaries(a, b).ok
    assert b.kind_totals() == a.kind_totals()
    assert b.kind_totals()["forward"] == tres.forwards > 0


def test_recorder_chains_hooks_and_fuses_the_delay():
    """A chained hook still runs; each hop's delay is the fleet run's one
    rounding, at most an ulp from the trace's two-rounding span width."""
    calls = []
    topo = TTopology.full_mesh(3)
    link = TLinkModel.campus(topo)
    from repro_torch.orchestration import Hooks
    rec = ttel.TraceRecorder(network=link, hooks=Hooks(
        on_forward=lambda *a: calls.append(a)))
    result = TOrchestrator(topo, TFast, TRouter(topo, "random", seed=0,
                                                device="cpu"),
                           network=link, hooks=rec.hooks).run(
        THOT.generate(0))
    assert len(calls) == result.forwards > 0
    hops = [h for hs in rec.hops.values() for h in hs]
    net = link.net_params()
    for hop in hops[:50]:
        fused = core.kref.fma32(
            torch.tensor([np.float32(hop.payload)]),
            torch.tensor([net.inv_bw[hop.src, hop.dst]]),
            torch.tensor([net.latency[hop.src, hop.dst]]))
        assert rec._delay32(hop) == np.float32(fused[0])
        gap = abs(float(rec._delay32(hop)) - float(rec._span32(hop)))
        assert gap <= float(np.spacing(rec._delay32(hop)))


# ---------------------------------------------------------------------------
# the cross-validation and the comparator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,net", [("random", "campus"),
                                        ("round_robin", None)])
def test_run_validation_telemetry_matches_reference(policy, net):
    """``run_validation(telemetry=8)``: the reference's agreement (the
    counts of mismatching counters and buckets, the tolerances, the
    verdict), the integrals' errors within their tolerance."""
    jtopo = ttopo = jnet = tnet = None
    if net is not None:
        jtopo, ttopo = JTopology.full_mesh(3), TTopology.full_mesh(3)
        jnet, tnet = JLinkModel.preset(jtopo, net), TLinkModel.preset(ttopo,
                                                                      net)
    a = j_run_validation(JHOT, 0, policy=policy, topology=jtopo,
                         network=jnet, telemetry=8)
    b = validate.run_validation(THOT, 0, policy=policy, topology=ttopo,
                                network=tnet, telemetry=8, device="cpu")
    ja, tb = a.telemetry, b.telemetry
    for f in ("counts_mismatches", "occupancy_mismatches", "ok"):
        assert getattr(tb, f) == getattr(ja, f) == (
            True if f == "ok" else 0), f
    assert tb.depth_tol == pytest.approx(ja.depth_tol, rel=1e-6)
    assert tb.busy_tol_frac == ja.busy_tol_frac
    assert tb.depth_max_err <= tb.depth_tol
    assert tb.busy_max_err_frac <= tb.busy_tol_frac
    assert b.exact and "tel: counts 0 occ 0" in b.row()


def test_compare_summaries_flags_planted_disagreements():
    (_, _, _, _), (rec, requests, result, topo) = _recorded("least_loaded",
                                                            None)
    host = rec.summary(requests, topo, 8, float(result.end_time))
    assert ttel.compare_summaries(host, host).ok

    def planted(**changes):
        s = ttel.TelemetrySummary(
            counts=host.counts.copy(), queue_depth=host.queue_depth.copy(),
            busy_time=host.busy_time.copy(),
            occupancy_hwm=host.occupancy_hwm.copy(),
            bucket_width=host.bucket_width, horizon=host.horizon)
        for name, (idx, delta) in changes.items():
            getattr(s, name)[idx] += delta
        return ttel.compare_summaries(host, s)

    agr = planted(counts=((1, 2, ttel.KIND_SERVE), 1))
    assert not agr.ok and agr.counts_mismatches == 1
    agr = planted(occupancy_hwm=((3,), 1))
    assert not agr.ok and agr.occupancy_mismatches == 1
    agr = planted(busy_time=((0, 1), 0.05 * host.bucket_width))
    assert not agr.ok and agr.busy_max_err_frac > ttel.DERIVED_ATOL
    agr = planted(queue_depth=((2, 4), 0.5 * max(1.0, host.queue_depth.max())))
    assert not agr.ok and agr.depth_max_err > agr.depth_tol
    with pytest.raises(ValueError, match="shapes differ"):
        ttel.compare_summaries(host, rec.summary(requests, topo, 4,
                                                 float(result.end_time)))


def test_validate_cli_runs_with_telemetry(monkeypatch, capsys):
    """``python -m repro_torch.fleetsim.validate --telemetry --device cpu``
    (its arguments cut to one seed of the hot fleet) prints the telemetry
    agreement and passes."""
    monkeypatch.setattr(validate, "get_workload", lambda name: THOT)
    monkeypatch.setattr("sys.argv", [
        "validate", "--scenarios", "hot", "--seeds", "1", "--telemetry",
        "6", "--device", "cpu"])
    reports = validate.main()
    assert len(reports) == 1 and reports[0].telemetry.ok
    assert "tel: counts 0 occ 0" in capsys.readouterr().out
