"""The port's arrival processes against the JAX package's: Poisson,
diurnal and trace workloads give the same requests, field for field,
for several seeds and under any ``PYTHONHASHSEED``; ``from_counts``, the
``amplitude`` check, the trace round trip across the two packages,
``total_requests`` and the registry behave as the reference's do
(tests/test_workload.py)."""
import collections
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.orchestration as jo
import repro_torch.orchestration as to
from repro.core.scenarios import SCENARIOS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def key(requests):
    """What a workload hands the simulator, per request."""
    return [(r.service.name, r.service.proc_time, r.service.deadline,
             r.arrival_time, r.origin_node) for r in requests]


def both(cls_name, *args, **kw):
    return getattr(jo, cls_name)(*args, **kw), getattr(to, cls_name)(*args,
                                                                     **kw)


FACTORIES = {
    "poisson": lambda m: m.PoissonWorkload(
        [{"S1": 0.05, "S3": 0.1}, {"S2": 0.02, "S6": 0.04}], horizon=500.0,
        name="p"),
    "poisson_from_counts": lambda m: m.PoissonWorkload.from_counts(
        SCENARIOS[1], horizon=110_000.0),
    "diurnal": lambda m: m.DiurnalWorkload(
        [{"S1": 30, "S3": 50}, {"S2": 20}], window=500.0, peaks=3,
        name="d"),
    "diurnal_paper": lambda m: m.DiurnalWorkload(
        SCENARIOS[1], window=110_000.0, peaks=2, amplitude=0.8),
    "diurnal_flat": lambda m: m.DiurnalWorkload(
        [{"S4": 40}], window=300.0, amplitude=0.0),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_port_requests_equal_reference(name, seed):
    ref, port = (FACTORIES[name](m) for m in (jo, to))
    a, b = ref.generate(seed), port.generate(seed)
    assert len(a) > 0 and key(a) == key(b)
    assert (ref.name, ref.n_nodes) == (port.name, port.n_nodes)
    # and the packed arrays the simulator scans
    (ja, jn), (ta, tn) = ref.to_arrays(seed), port.to_arrays(seed)
    assert jn == tn
    for field, x, y in zip(ja._fields, ja, ta):
        assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_from_counts_rates_match_reference():
    counts = [{"S3": 400, "S1": 7}, {"S6": 200}]
    ref = jo.PoissonWorkload.from_counts(counts, horizon=1000.0)
    port = to.PoissonWorkload.from_counts(counts, horizon=1000.0)
    assert port.rates == ref.rates and port.horizon == ref.horizon
    n = len(port.generate(seed=0))
    assert 450 <= n <= 750          # ~607 expected, Poisson spread
    # a zero rate draws nothing, in both
    zero = [{"S3": 0.0, "S1": 0.01}]
    assert key(jo.PoissonWorkload(zero, 300.0).generate(2)) == key(
        to.PoissonWorkload(zero, 300.0).generate(2))


def test_poisson_respects_horizon_and_nodes():
    wl = to.PoissonWorkload([{"S3": 0.3}, {"S6": 0.3}], horizon=200.0)
    reqs = wl.generate(seed=1)
    assert wl.n_nodes == 2
    assert all(0 < r.arrival_time <= 200.0 for r in reqs)
    assert {r.origin_node for r in reqs} == {0, 1}
    times = [r.arrival_time for r in reqs]
    assert times == sorted(times)


def test_diurnal_counts_exact_and_peaked():
    ref, port = both("DiurnalWorkload", [{"S3": 4000}], window=1000.0,
                     peaks=1, amplitude=1.0)
    reqs = port.generate(seed=2)
    assert len(reqs) == 4000 and key(reqs) == key(ref.generate(2))
    first_half = sum(1 for r in reqs if r.arrival_time < 500.0)
    assert first_half > 0.6 * len(reqs)


@pytest.mark.parametrize("amplitude", [-0.1, 1.5])
def test_diurnal_amplitude_checked(amplitude):
    with pytest.raises(ValueError, match="amplitude"):
        to.DiurnalWorkload([{"S3": 1}], amplitude=amplitude)
    with pytest.raises(ValueError, match="amplitude"):
        jo.DiurnalWorkload([{"S3": 1}], amplitude=amplitude)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trace_round_trip_across_packages(tmp_path, writer):
    """A trace either package writes replays, in both, as the requests it
    was written from."""
    src_pkg = jo if writer == "reference" else to
    src = src_pkg.PoissonWorkload.from_counts(
        [{"S1": 5, "S4": 3}, {"S2": 4, "S6": 2}, {"S3": 6}],
        horizon=100.0, name="rt").generate(seed=3)
    path = str(tmp_path / "trace.jsonl")
    src_pkg.dump_trace(src, path)
    for m in (jo, to):
        wl = m.TraceWorkload(path)
        assert wl.n_nodes == 3 and wl.name == f"trace:{path}"
        assert key(wl.generate()) == key(src)
        assert key(wl.generate(seed=9)) == key(src)   # the seed is ignored
    other = str(tmp_path / "other.jsonl")
    (to if writer == "reference" else jo).dump_trace(src, other)
    with open(path) as f, open(other) as g:
        assert f.read() == g.read()


def test_trace_rejects_unknown_service(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"service": "S1", "arrival_time": 0.5, "node": 0}\n\n'
                    '{"service": "S99", "arrival_time": 1.0, "node": 0}\n')
    with pytest.raises(ValueError, match=r"bad.jsonl:3: unknown service"):
        to.TraceWorkload(str(path))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert to.TraceWorkload(str(empty)).n_nodes == 1
    assert to.TraceWorkload(str(empty)).generate() == []


def test_trace_of_paper_scenario_replays_its_arrays(tmp_path):
    """``paper/scenario1`` dumped and replayed packs into the arrays of
    the workload itself (what chip_smoke.py's trace replay relies on)."""
    wl = to.get_workload("paper/scenario1")
    path = str(tmp_path / "s1.jsonl")
    to.dump_trace(wl.generate(0), path)
    (a, an), (b, bn) = wl.to_arrays(0), to.TraceWorkload(path).to_arrays()
    assert an == bn
    for field, x, y in zip(a._fields, a, b):
        assert np.array_equal(x, y), field


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_total_requests(name):
    port = FACTORIES[name](to)
    assert port.total_requests() == FACTORIES[name](jo).total_requests() \
        == len(port.generate(0))
    assert port.total_requests(seed=1) == len(port.generate(1))


def test_registry_behaviour():
    assert {f"paper/scenario{s}" for s in (1, 2, 3)} <= set(
        to.available_workloads())
    with pytest.raises(ValueError, match="unknown workload"):
        to.get_workload("paper/scenario99")
    to.register_workload("t/poisson",
                         lambda: to.PoissonWorkload([{"S3": 0.1}], 50.0))
    with pytest.raises(ValueError, match="already registered"):
        to.register_workload("t/poisson",
                             lambda: to.PoissonWorkload([{"S3": 0.1}], 50.0))
    to.register_workload("t/poisson",
                         lambda: to.DiurnalWorkload([{"S3": 5}], 50.0),
                         overwrite=True)
    assert isinstance(to.get_workload("t/poisson"), to.DiurnalWorkload)
    counts = collections.Counter(
        (r.origin_node, r.service.name)
        for r in to.get_workload("paper/scenario2").generate(5))
    for node, svc_counts in enumerate(SCENARIOS[2]):
        for sname, want in svc_counts.items():
            assert counts[(node, sname)] == want


_HASHSEED_PROBE = """
import sys
sys.path.insert(0, {src!r})
from {pkg}.orchestration import DiurnalWorkload, PoissonWorkload
from {pkg}.netsim import LinkModel, RadioModel, RadioWorkload
from {pkg}.orchestration import Topology, get_workload
link = LinkModel.campus(Topology.full_mesh(3))
radio = RadioModel.from_link(link).with_random_mobility(3, 1000.0, 2.0)
for wl in (PoissonWorkload([{{'S3': 0.1, 'S1': 0.05}}], horizon=100.0),
           DiurnalWorkload([{{'S3': 4, 'S6': 3}}], window=100.0),
           RadioWorkload(get_workload('paper/scenario1'), radio, link=link)):
    print([(r.service.name, r.service.deadline, r.arrival_time,
            r.origin_node) for r in wl.generate(0)][:200])
"""


def test_streams_stable_across_hash_randomization():
    """The port's Poisson, diurnal and radio streams under two hash seeds,
    and the reference's under a third, are one stream."""
    outs = set()
    for pkg, hashseed in (("repro_torch", "1"), ("repro_torch", "2"),
                          ("repro", "3")):
        code = _HASHSEED_PROBE.format(src=os.path.join(ROOT, "src"), pkg=pkg)
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        res = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, env=env,
                             timeout=120)
        assert res.returncode == 0, res.stderr
        outs.add(res.stdout)
    assert len(outs) == 1, "arrival streams vary with PYTHONHASHSEED"
