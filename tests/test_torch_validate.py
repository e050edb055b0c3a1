"""The port's cross-validation (``repro_torch.fleetsim.validate``: the fleet
simulator against the port's event heap) against the reference's
(``repro.fleetsim.validate``), on the CPU.

Each cell runs four engines on the same workload: the two heaps (which
agree exactly, tests/test_torch_orchestration.py) and the two fleet
simulators (the port's eager loop on the CPU, the reference's
``lax.scan``), the deterministic policies replayed directly and the
stochastic ones by the heap's recorded trace.  The port's report must be
``exact`` and equal the reference's field by field: host and fleet
aggregates, the mismatch counts, the wire-time error, the capacity; the
fleet's two f32 sums over requests to 1e-5 relative.
"""
import dataclasses

import pytest
import torch

from repro.fleetsim.validate import run_validation as j_run_validation
from repro.netsim import LinkModel as JLinkModel
from repro.orchestration import (Topology as JTopology,
                                 UniformWorkload as JUniformWorkload)
from repro_torch.fleetsim import validate
from repro_torch.netsim import LinkModel as TLinkModel
from repro_torch.orchestration import (Topology as TTopology,
                                       UniformWorkload as TUniformWorkload)

# tests/test_fleetsim.py's HOT fleet
HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
JHOT = JUniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
THOT = TUniformWorkload(HOT_COUNTS, window=1200.0, name="hot")
POLICIES = ("random", "power_of_two", "least_loaded", "round_robin",
            "batched_feasible")
# the fleet's f32 sums over requests, which PyTorch and XLA take in
# another order: within 1e-5 relative, as in tests/test_torch_fleetsim.py
FLEET_SUMS = ("mean_response_time", "transfer_time")


def _both(seed, policy, topo=None, net=None, **kw):
    jtopo, ttopo = topo or (None, None)
    jnet = tnet = None
    if net is not None:
        jtopo, ttopo = jtopo or JTopology.full_mesh(3), \
            ttopo or TTopology.full_mesh(3)
        jnet, tnet = JLinkModel.preset(jtopo, net), TLinkModel.preset(ttopo,
                                                                      net)
    a = j_run_validation(JHOT, seed, policy=policy, topology=jtopo,
                         network=jnet, **kw)
    b = validate.run_validation(THOT, seed, policy=policy, topology=ttopo,
                                network=tnet, device="cpu", **kw)
    return a, b


def _assert_same_report(a, b):
    assert a.telemetry is None
    for f in dataclasses.fields(b):
        if f.name != "fleet":
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert a.fleet.keys() == b.fleet.keys()
    for k, v in a.fleet.items():
        if k in FLEET_SUMS:
            assert abs(b.fleet[k] - v) <= 1e-5 * abs(v), k
        else:
            assert b.fleet[k] == v, k
    assert b.exact, b.row()
    for k in ("met_deadline", "processed", "forwards", "discarded"):
        assert b.host[k] == b.fleet[k], k


@pytest.mark.parametrize("policy", POLICIES)
def test_hot_fleet_report_matches_reference(policy):
    for seed in (0, 1):
        a, b = _both(seed, policy)
        _assert_same_report(a, b)
        assert b.host["forwards"] > 0


def test_discard_variant_matches_reference():
    a, b = _both(0, "random", discard_on_exhaust=True)
    _assert_same_report(a, b)
    assert b.fleet["discarded"] > 0


def test_heterogeneous_ring_matches_reference():
    speeds = [1.0, 2.0, 0.5]
    a, b = _both(0, "round_robin", topo=(JTopology.ring(3, speeds=speeds),
                                         TTopology.ring(3, speeds=speeds)))
    _assert_same_report(a, b)


@pytest.mark.parametrize("policy", ["batched_feasible", "power_of_two"])
def test_campus_pricing_matches_reference(policy):
    a, b = _both(0, policy, net="campus")
    _assert_same_report(a, b)
    assert b.host["transfer_time"] > 0 and b.transfer_max_err <= 1e-3


def test_a_changed_trace_is_caught(monkeypatch):
    """The check is not vacuous: a replayed trace with one recorded
    forward target changed makes the report not exact."""
    real = validate._host_run

    def planted(*args, **kw):
        out = real(*args, **kw)
        targets = out[2]
        i, h = map(int, next(zip(*(targets >= 0).nonzero())))
        targets[i, h] = (targets[i, h] + 1) % 3
        if targets[i, h] == out[0][i].origin_node:
            targets[i, h] = (targets[i, h] + 1) % 3
        return out

    monkeypatch.setattr(validate, "_host_run", planted)
    rep = validate.run_validation(THOT, 0, policy="random", device="cpu")
    assert not rep.exact and rep.node_mismatches > 0


def test_unported_and_cuda_paths_raise(monkeypatch):
    """``telemetry=``, which raised until the telemetry plane was ported
    (ROADMAP item 2), runs; a CUDA run without CUDA raises."""
    rep = validate.run_validation(THOT, 0, telemetry=8, device="cpu")
    assert rep.telemetry is not None and rep.telemetry.ok and rep.exact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        validate.run_validation(THOT, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        validate.run_validation(THOT, 0, device="cuda")


# tests/test_fleetsim.py::test_property_random_fleets_match_host's stored
# counterexample (the reference's own test fails on it): one node,
# `random`, seed 0, (service time, deadline, arrival) a request
PROPERTY_MIX = [(5.0, 60.0, 0.0), (5.0, 60.0, 0.5), (180.0, 60.0, 0.0),
                (5.0, 60.0, 0.0), (5.0, 60.0, 0.0)]


def _fixed(pkg_request, pkg_workload, mix, n_nodes):
    import random as pyrandom

    class Fixed(pkg_workload):
        name = "prop"

        def __init__(self):
            self.n_nodes = n_nodes

        def generate(self, s):
            rng = pyrandom.Random(s)
            reqs = [pkg_request.Request(
                service=pkg_request.Service(f"p{p}d{d}", 1, "x", p, d),
                arrival_time=t, origin_node=rng.randrange(n_nodes))
                for (p, d, t) in mix]
            return self._finish(reqs)
    return Fixed()


def test_port_inherits_the_reference_property_counterexample(monkeypatch):
    """On the workload where the reference's fleetsim and its heap disagree
    (3 outcomes), the port's fleet simulator equals the reference's JAX
    fleetsim and the port's heap the reference's heap, request by
    request: the port inherits the disagreement, it does not add to it."""
    import numpy as np
    from repro.core import request as jreq
    from repro.fleetsim import validate as jval
    from repro.orchestration import Workload as JWorkload
    from repro_torch.core import request as treq
    from repro_torch.orchestration import Workload as TWorkload

    seen = {}
    for tag, mod in (("ref", jval), ("port", validate)):
        real_sim, real_host = mod.fcore.simulate, mod._host_outcomes

        def sim(*a, _tag=tag, _real=real_sim, **kw):
            seen.setdefault(_tag + "/fleet", _real(*a, **kw))
            return seen[_tag + "/fleet"]

        def host(*a, _tag=tag, _real=real_host):
            seen[_tag + "/host"] = _real(*a)
            return seen[_tag + "/host"]
        monkeypatch.setattr(mod.fcore, "simulate", sim)
        monkeypatch.setattr(mod, "_host_outcomes", host)
    a = jval.run_validation(_fixed(jreq, JWorkload, PROPERTY_MIX, 1), 0,
                            policy="random")
    b = validate.run_validation(_fixed(treq, TWorkload, PROPERTY_MIX, 1), 0,
                                policy="random", device="cpu")
    assert not a.exact and a.outcome_mismatches == 3
    assert (b.outcome_mismatches, b.node_mismatches) == \
        (a.outcome_mismatches, a.node_mismatches)
    assert b.host == a.host
    for k, v in a.fleet.items():
        assert abs(b.fleet[k] - v) <= 1e-5 * abs(v), k
    for part in (0, 1):                      # outcome, serving node
        np.testing.assert_array_equal(seen["port/host"][part],
                                      seen["ref/host"][part])
    for f in ("outcome", "served_by", "forwards_used"):
        np.testing.assert_array_equal(
            np.asarray(getattr(seen["port/fleet"], f)),
            np.asarray(getattr(seen["ref/fleet"], f)))
    np.testing.assert_allclose(
        np.asarray(seen["port/fleet"].completion, np.float64),
        np.asarray(seen["ref/fleet"].completion, np.float64), rtol=1e-6)
