"""The port's fleet simulator (``repro_torch.fleetsim.simulate``, torch on
the CPU) against the JAX reference (``repro.fleetsim.simulate``), per
request.

Both packages pack their own copies of the same workload; the arrays are
checked equal and then each package simulates them.  The JAX side runs
``batched_feasible`` through the Pallas ``event_select`` kernel in
interpret mode, as its own tests do.  Under ``random`` and
``power_of_two`` both draw from threefry (``jax.random`` and the port's
bit-exact ``fleetsim.rng``), so those runs are held to the same bar.

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
              seed=0, **kw):
    jtopo = topo[0] if topo else JTopology.full_mesh(K)
    ttopo = topo[1] if topo else TTopology.full_mesh(K)
    jnet = tnet = None
    if net is not None:
        jnet = JLinkModel.preset(jtopo, net).net_params()
        tnet = TLinkModel.preset(ttopo, net).net_params()
        assert all(np.array_equal(a, b) for a, b in zip(jnet, tnet))
    use_pallas = kw.get("policy") == "batched_feasible"
    a = jfs.simulate(ja, jfs.topology_arrays(jtopo),
                     jfs.SimParams.make(seed, sla), net=jnet,
                     targets=targets, use_pallas=use_pallas, **kw)
    b = tfs.simulate(ta, tfs.topology_arrays(ttopo),
                     tfs.SimParams.make(seed, sla), net=tnet,
                     targets=targets, device="cpu", **kw)
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


@pytest.mark.parametrize("net", [None, "campus"])
@pytest.mark.parametrize("policy", ["random", "power_of_two"])
def test_stochastic_policies_match_reference_on_hot_fleet(policy, net):
    """The reference's threefry draws, keyed by the run's seed, each
    request's row and its hop: every forward lands where JAX sends it."""
    ja, ta = _pair(JUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"),
                   TUniformWorkload(HOT_COUNTS, window=1200.0, name="hot"))
    for seed in (0, 2 ** 31 - 1):
        a, b = _run_both(ja, ta, 3, net=net, policy=policy, capacity=512,
                         depth=256, seed=seed)
        _assert_parity(a, b)
        assert int(b.forwards) > 0


# a 32-node mesh with four hot nodes: their referrals pick among 31
# neighbours; a star's leaves have one neighbour (power_of_two's deg <= 1)
STAR_COUNTS = [{"S6": 4}] + [HOT_COUNTS[0]] * 3
MESH32_COUNTS = [HOT_COUNTS[0]] * 4 + [{"S6": 2}] * 28


@pytest.mark.parametrize("shape", ["star", "mesh32"])
@pytest.mark.parametrize("policy", ["random", "power_of_two"])
def test_stochastic_policies_match_reference_on_star_and_wide_mesh(
        policy, shape):
    counts = STAR_COUNTS if shape == "star" else MESH32_COUNTS
    K = len(counts)
    ja, ta = _pair(JUniformWorkload(counts, window=1200.0, name=shape),
                   TUniformWorkload(counts, window=1200.0, name=shape))
    topo = ((JTopology.star(K), TTopology.star(K)) if shape == "star"
            else (JTopology.full_mesh(K), TTopology.full_mesh(K)))
    a, b = _run_both(ja, ta, K, net="campus", topo=topo, policy=policy,
                     capacity=512, depth=256)
    _assert_parity(a, b)
    assert int(b.forwards) > 0
    if shape == "mesh32":              # the hot nodes refer widely
        served = set(b.served_by.tolist())
        assert len(served - {0, 1, 2, 3}) > 8


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
    """Telemetry and simulate_fn, which raised until the telemetry plane and
    the cell axis were ported (ROADMAP items 2 and 3), now run; the
    stochastic policies run (ROADMAP item 1), ``random`` by default, as in
    the reference; what the reference refuses still raises."""
    from repro_torch.telemetry import TelemetryConfig
    ta, _ = TUniformWorkload(HOT_COUNTS, window=1200.0).to_arrays(0)
    topo = tfs.topology_arrays(TTopology.full_mesh(3))
    kw = dict(capacity=512, depth=256, device="cpu")
    default = tfs.simulate(ta, topo, **kw)
    drawn = tfs.simulate(ta, topo, policy="random", **kw)
    assert torch.equal(default.served_by, drawn.served_by)
    assert int(tfs.simulate(ta, topo, policy="power_of_two",
                            **kw).forwards) > 0
    tel = tfs.simulate(ta, topo, telemetry=TelemetryConfig(8, 3000.0), **kw)
    assert tel.telemetry.counts.shape == (3, 8, 5)
    assert int(tel.telemetry.counts[..., 0].sum()) == int(tel.total)
    assert default.telemetry is None
    one = tfs.simulate_fn(policy="least_loaded", **kw)(ta, topo)
    assert torch.equal(one.served_by, tfs.simulate(
        ta, topo, policy="least_loaded", **kw).served_by)
    with pytest.raises(ValueError, match="unknown fleetsim policy"):
        tfs.simulate(ta, topo, policy="nope", device="cpu")
    with pytest.raises(ValueError, match="positive horizon"):
        tfs.simulate(ta, topo, telemetry=TelemetryConfig(0, 10.0), **kw)
    with pytest.raises(ValueError, match="simulate_fn"):
        tfs.simulate(ta, topo, tfs.SimParams.make([0, 1]), **kw)


def test_eager_entry_refuses_what_simulate_refuses():
    """The eager loop's private entry (the plain version ``chip_smoke.py``
    runs on the card) refuses what ``simulate`` refuses, defaults to
    ``random`` as it does, and carries telemetry as it does."""
    from repro_torch.fleetsim import core
    from repro_torch.telemetry import TelemetryConfig
    ta, _ = TUniformWorkload(HOT_COUNTS, window=1200.0).to_arrays(0)
    topo = tfs.topology_arrays(TTopology.full_mesh(3))
    with pytest.raises(ValueError, match="unknown fleetsim policy"):
        core._simulate_eager(ta, topo, policy="nope", device="cpu")
    kw = dict(capacity=512, depth=256, device="cpu")
    assert torch.equal(core._simulate_eager(ta, topo, **kw).served_by,
                       tfs.simulate(ta, topo, **kw).served_by)
    with pytest.raises(ValueError, match="positive horizon"):
        core._simulate_eager(ta, topo, telemetry=TelemetryConfig(4, 0.0),
                             **kw)
    cfg = TelemetryConfig(4, 2000.0)
    assert torch.equal(
        core._simulate_eager(ta, topo, telemetry=cfg, **kw).telemetry.counts,
        tfs.simulate(ta, topo, telemetry=cfg, **kw).telemetry.counts)


def test_simulate_on_cpu_runs_the_eager_loop_and_launches_nothing(
        monkeypatch):
    """On the CPU ``simulate`` is the eager per-event loop: no kernel
    wrapper is called, and it gives what the private eager entry gives."""
    from repro_torch.fleetsim import core
    from repro_torch.kernels import event_scan, event_select

    def refuse(*_, **__):
        raise AssertionError("a kernel wrapper was called on the CPU")

    monkeypatch.setattr(event_scan, "event_scan", refuse)
    monkeypatch.setattr(event_select, "event_select", refuse)
    ta, _ = TUniformWorkload(HOT_COUNTS, window=1200.0).to_arrays(0)
    topo = tfs.topology_arrays(TTopology.full_mesh(3))
    kw = dict(policy="batched_feasible", capacity=512, depth=256,
              device="cpu")
    a = tfs.simulate(ta, topo, **kw)
    b = core._simulate_eager(ta, topo, **kw)
    assert a.events == b.events > int(a.total)
    for f in ("outcome", "served_by", "forwards_used", "completion"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _scan_inputs(R=5, K=3, M=2, dev="cpu"):
    return (torch.zeros(R, 4, device=dev),
            torch.zeros(R, dtype=torch.int32, device=dev),
            torch.zeros(R, M, dtype=torch.int32, device=dev),
            torch.zeros(K, K, dtype=torch.bool, device=dev),
            torch.zeros(K, dtype=torch.int32, device=dev),
            torch.ones(K, device=dev), torch.zeros(K, K, device=dev),
            torch.zeros(K, K, device=dev),
            torch.zeros(K, K - 1, dtype=torch.int32, device=dev))


_SCAN_KW = dict(policy="batched_feasible", max_forwards=2,
                discard_on_exhaust=False, capacity=8, depth=8, event_buf=4,
                max_events=15, priced=False, hop_bits=2)


def test_event_scan_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import event_scan
    before = event_scan.event_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        event_scan.event_scan(*_scan_inputs(), **_SCAN_KW)
    assert event_scan.event_scan.launches == before


@pytest.mark.parametrize("bad", ["cols", "targets", "adj_dtype", "depth",
                                 "policy", "noncontiguous", "misaligned",
                                 "neighbors"])
def test_event_scan_wrapper_refuses_malformed_inputs(bad):
    """Shapes, dtypes, contiguity and sizes are checked before the device,
    so each is refused on the CPU too."""
    from repro_torch.kernels import event_scan
    args, kw = list(_scan_inputs()), dict(_SCAN_KW)
    if bad == "cols":
        args[0] = torch.zeros(5, 3)
    elif bad == "targets":
        args[2] = torch.zeros(4, 2, dtype=torch.int32)
    elif bad == "adj_dtype":
        args[3] = torch.zeros(3, 3, dtype=torch.int32)
    elif bad == "depth":
        kw["depth"] = 9
    elif bad == "policy":
        kw["policy"] = "nope"
    elif bad == "neighbors":
        args[8] = torch.zeros(2, 2, dtype=torch.int32)
    elif bad == "noncontiguous":
        args[6] = torch.zeros(6, 3)[::2]
    else:                                # rows read as 16-byte vectors
        args[0] = torch.zeros(5 * 4 + 1)[1:].view(5, 4)
    with pytest.raises((ValueError, TypeError)) as err:
        event_scan.event_scan(*args, **kw)
    assert "CUDA" not in str(err.value)


def test_event_scan_shared_memory_layout():
    """Nine (K,) arrays, the ring of (time, rid, meta) beside them where it
    fits; the ctypes record is csrc/event_scan.cu's ScanArgs."""
    import ctypes

    from repro_torch.kernels import event_scan
    assert event_scan.shared_bytes(3, 1024, True) == 96 + 4 + 12 * 1024
    assert event_scan.shared_bytes(256, 1024, False) == 32 * 256 + 256
    assert event_scan.shared_bytes(256, 1024, True) <= event_scan.SHARED_LIMIT
    fields = [n for n, _ in event_scan._ScanArgs._fields_]
    assert fields[:9] == ["cols", "origin", "targets", "adj", "degree",
                          "speeds", "lat", "inv_bw", "neighbors"]
    assert fields[31:36] == ["tel_counts", "tel_occ", "seeds", "cols_cell",
                             "net_cell"]
    assert fields[-3:] == ["NB", "eps", "tel_inv_w"]
    # 34 pointers, two int64 cell strides, 15 ints, two floats, padded to 8
    assert ctypes.sizeof(event_scan._ScanArgs) == 34 * 8 + 2 * 8 + 15 * 4 \
        + 4 + 4 + 4
    assert set(event_scan.POLICIES) == set(tfs.POLICIES)


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
