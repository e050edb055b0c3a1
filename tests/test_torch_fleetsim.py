"""The port's fleet simulator (``repro_torch.fleetsim.simulate``, torch on
the CPU) against the JAX reference (``repro.fleetsim.simulate``), per
request.

Both packages pack their own copies of the same workload; the arrays are
checked equal and then each package simulates them.  The JAX side runs
``batched_feasible`` through the Pallas ``event_select`` kernel in
interpret mode, as its own tests do.

Bar: exact on ``outcome``, ``served_by``, ``forwards_used`` and the
never-silent counters ``overflow``, ``window_saturation`` and
``event_overflow``; ``completion`` and ``transfer_used`` bit for bit as
well (the port follows the reference's f32 arithmetic operation for
operation, its fused multiply-adds included), far inside ``validate.py``'s
``TRANSFER_ATOL`` = 1e-2, the ceiling a port could be held to.  The
whole-slice check, ``paper/scenario1`` at full volume, lives in
tests/test_torch_golden.py, which runs it once for both packages.
"""
import numpy as np
import pytest
import torch

import repro.fleetsim as jfs
from repro.core.request import Request as JRequest, Service as JService
from repro.netsim import LinkModel as JLinkModel
from repro.orchestration import (Topology as JTopology,
                                 UniformWorkload as JUniformWorkload,
                                 Workload as JWorkload)
import repro_torch.fleetsim as tfs
from repro_torch.core.request import Request as TRequest, Service as TService
from repro_torch.netsim import LinkModel as TLinkModel
from repro_torch.orchestration import (Topology as TTopology,
                                       UniformWorkload as TUniformWorkload,
                                       Workload as TWorkload)

# tests/test_fleetsim.py's HOT fleet: 3 nodes deep in overload
HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
EXACT = ("outcome", "served_by", "forwards_used")
COUNTERS = ("overflow", "window_saturation", "event_overflow", "forwards",
            "met_deadline", "processed", "discarded")


def _pair(jwl, twl, seed=0):
    """Both packages' arrays of one workload; asserts they are equal."""
    ja, _ = jwl.to_arrays(seed)
    ta, _ = twl.to_arrays(seed)
    for name, a, b in zip(ja._fields, ja, ta):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    return ja, ta


def _run_both(ja, ta, K, *, net=None, topo=None, targets=None, sla=1.0,
              **kw):
    jtopo = topo[0] if topo else JTopology.full_mesh(K)
    ttopo = topo[1] if topo else TTopology.full_mesh(K)
    jnet = tnet = None
    if net is not None:
        jnet = JLinkModel.preset(jtopo, net).net_params()
        tnet = TLinkModel.preset(ttopo, net).net_params()
        assert all(np.array_equal(a, b) for a, b in zip(jnet, tnet))
    use_pallas = kw.get("policy") == "batched_feasible"
    a = jfs.simulate(ja, jfs.topology_arrays(jtopo), jfs.SimParams.make(0, sla),
                     net=jnet, targets=targets, use_pallas=use_pallas, **kw)
    b = tfs.simulate(ta, tfs.topology_arrays(ttopo), tfs.SimParams.make(0, sla),
                     net=tnet, targets=targets, device="cpu", **kw)
    return a, b


def _assert_parity(a, b):
    for f in EXACT:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in COUNTERS:
        assert int(getattr(a, f)) == int(getattr(b, f)), f
    for f in ("completion", "transfer_used"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), \
            (f, np.abs(x - y).max())
    for f in ("mean_response_time", "end_time", "transfer_time"):
        x, y = float(getattr(a, f)), float(getattr(b, f))
        assert abs(x - y) <= 1e-5 * max(1.0, abs(x)), (f, x, y)


@pytest.mark.parametrize("net", [None, "campus"])
@pytest.mark.parametrize("policy", ["batched_feasible", "round_robin",
                                    "least_loaded", "trace"])
def test_hot_fleet_matches_reference(policy, net):
    ja, ta = _pair(JUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"),
                   TUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"))
    targets = None
    if policy == "trace":
        # recorded choices: any node id, -1 (clamped to 0) included
        rng = np.random.default_rng(1)
        targets = rng.integers(-1, 3, (ja.arrival.shape[0], 2)).astype(np.int32)
    a, b = _run_both(ja, ta, 3, net=net, policy=policy, capacity=512,
                     depth=256, targets=targets)
    _assert_parity(a, b)
    assert int(b.forwards) > 0 and b.events == int(b.total) + int(b.forwards)


def test_discard_variant_and_sla_scale_match_reference():
    ja, ta = _pair(JUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"),
                   TUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"))
    a, b = _run_both(ja, ta, 3, net="campus", policy="least_loaded",
                     capacity=512, depth=256, discard_on_exhaust=True,
                     sla=0.7)
    _assert_parity(a, b)
    assert int(b.discarded) > 0


def test_heterogeneous_ring_matches_reference():
    ja, ta = _pair(JUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"),
                   TUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"))
    speeds = [1.0, 2.0, 0.5]
    a, b = _run_both(ja, ta, 3, policy="batched_feasible", capacity=512,
                     depth=256, topo=(JTopology.ring(3, speeds=speeds),
                                      TTopology.ring(3, speeds=speeds)))
    _assert_parity(a, b)


def test_undersized_event_plane_reports_event_overflow():
    ja, ta = _pair(JUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"),
                   TUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"))
    a, b = _run_both(ja, ta, 3, policy="round_robin", capacity=512,
                     depth=256, max_events=200, event_buf=8)
    _assert_parity(a, b)
    assert int(b.event_overflow) > 0 and b.events == 200


def test_batched_feasible_scores_post_retire_state():
    """tests/test_fleetsim.py's stale-retire regression: at t=12 the
    d_abs=18 block has completed but is not yet retired when the event is
    selected; scoring the stale ledger would forward a request the host
    admits on the spot."""
    def fixed(Workload, Request, Service):
        class _Fixed(Workload):
            name = "stale-retire"
            n_nodes = 2

            def generate(self, seed):
                return self._finish([
                    Request(service=Service("a", 1, "x", 5.0, 100.0),
                            arrival_time=0.0, origin_node=0),
                    Request(service=Service("b", 1, "x", 5.0, 17.0),
                            arrival_time=1.0, origin_node=0),
                    Request(service=Service("c", 1, "x", 5.0, 9.0),
                            arrival_time=12.0, origin_node=0)])
        return _Fixed()

    ja, ta = _pair(fixed(JWorkload, JRequest, JService),
                   fixed(TWorkload, TRequest, TService))
    a, b = _run_both(ja, ta, 2, policy="batched_feasible", capacity=16,
                     depth=16)
    _assert_parity(a, b)
    assert int(a.forwards) == int(b.forwards) == 0


def test_unported_paths_raise():
    ta, _ = TUniformWorkload(HOT_COUNTS, window=1200.0).to_arrays(0)
    topo = tfs.topology_arrays(TTopology.full_mesh(3))
    for policy in ("random", "power_of_two"):
        with pytest.raises(NotImplementedError, match="threefry"):
            tfs.simulate(ta, topo, policy=policy, device="cpu")
    with pytest.raises(NotImplementedError, match="telemetry"):
        tfs.simulate(ta, topo, telemetry=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="simulate_fn"):
        tfs.simulate_fn(policy="least_loaded")
    with pytest.raises(ValueError, match="unknown fleetsim policy"):
        tfs.simulate(ta, topo, policy="nope", device="cpu")


def test_outputs_are_typed_like_the_reference():
    ta, _ = TUniformWorkload(HOT_COUNTS, window=1200.0).to_arrays(0)
    m = tfs.simulate(ta, tfs.topology_arrays(TTopology.full_mesh(3)),
                     policy="least_loaded", capacity=512, depth=256,
                     device="cpu")
    for f in ("outcome", "served_by", "forwards_used", "event_overflow",
              "overflow", "window_saturation"):
        assert getattr(m, f).dtype == torch.int32, f
    for f in ("completion", "transfer_used", "mean_response_time"):
        assert getattr(m, f).dtype == torch.float32, f
