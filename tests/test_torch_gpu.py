"""The port on an NVIDIA GPU: the hand-written kernels against their plain
PyTorch versions, the simulator (the event_scan kernel), the ViT, ResNet,
DiT, UNet and language models on the card against the same code on the
CPU (or DiT's and Granite's kernel paths against their plain paths), and
the graphed serve step against the eager one.
Imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test skips where ``torch.cuda.is_available()`` is false.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import (deit_b, dit_xl2, get_config,
                                 get_smoke_config, resnet50, vit_h14)
from repro_torch.fleetsim import simulate, topology_arrays
from repro_torch.kernels import ops, ref
from repro_torch.kernels import event_scan as scan
from repro_torch.kernels import event_select as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as moe_gemm_mod
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.launch import serve
from repro_torch.launch.graphs import GraphedStep
from repro_torch.models import (common, diffusion, dit, moe, resnet,
                                transformer, unet, vit)
from repro_torch.netsim import LinkModel
from repro_torch.orchestration import Topology, UniformWorkload

BIG = 1e30
NAMES = ("take_fresh", "t", "node", "feasible", "arrive", "j", "cap", "load")


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


# profiler windows that recorded no device entry, tried again
PROFILE_TRIES = 3


def _device_kernels(fn):
    """``fn()``'s result, each device entry's count by name over one call
    of ``fn`` under torch.profiler, and the number of calls made.  Now and
    then the profiler records no device entry at all for a window; such a
    window is profiled again (``fn`` called again), up to
    ``PROFILE_TRIES`` times in all, and a window with any device entry is
    taken as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        if kernels:
            break
    return out, kernels, tries


def _fleet_args(rng, K, W, dev):
    """Head-pointer ledger windows on a half grid (deadlines tie block
    edges), a priced network, two candidate events."""
    starts = np.full((K, W), BIG, np.float32)
    ends = np.full((K, W), BIG, np.float32)
    sizes = np.zeros((K, W), np.float32)
    head = rng.integers(0, W // 4 + 1, K).astype(np.int32)
    n = np.asarray([rng.integers(0, W - h + 1) for h in head], np.int32)
    for k in range(K):
        starts[k, :head[k]] = ends[k, :head[k]] = -BIG
        t = float(rng.integers(0, 200))
        for i in range(head[k], head[k] + n[k]):
            s = t + (0.0 if rng.random() < 0.6 else float(rng.integers(1, 60)) / 2)
            size = float(rng.choice([20.0, 44.0, 180.0]))
            starts[k, i], ends[k, i], sizes[k, i] = s, s + size, size
            t = s + size
    lat = rng.uniform(0, 120, (K, K)).astype(np.float32)
    ibw = rng.choice([0.0, 0.1, 0.8], (K, K)).astype(np.float32)
    np.fill_diagonal(lat, 0)
    np.fill_diagonal(ibw, 0)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    i = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    b = lambda x: torch.tensor(x, device=dev)
    d = float(starts[0, head[0]]) if n[0] else 500.0
    return (f(10.0), i(int(rng.integers(K))), f(d), f(44.0), f(24.8832),
            b(True), f(10.0), i(int(rng.integers(K))), f(900.0), f(20.0),
            f(6.2208), b(bool(rng.random() < 0.5)),
            *(torch.from_numpy(a).to(dev) for a in (starts, ends, sizes, n,
                                                    head)),
            torch.ones(K, device=dev),
            torch.from_numpy((rng.integers(0, 200, K) / 2).astype(np.float32)).to(dev),
            torch.from_numpy(lat).to(dev), torch.from_numpy(ibw).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("K,W", [(3, 64), (6, 1024), (32, 512)])
def test_event_select_kernel_matches_plain_version(K, W):
    _need_gpu()
    rng = np.random.default_rng(K * 1000 + W)
    for _ in range(4):
        args = _fleet_args(rng, K, W, torch.device("cuda"))
        before = es.event_select.launches
        got = ops.event_select(*args)
        want = ref.event_select_ref(*args)
        torch.cuda.synchronize()
        assert es.event_select.launches == before + 1
        for name, g, w in zip(NAMES, got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name


# the simulator's per-request fields and counters: event_scan on the card
# must give the CPU eager loop's, all of them exactly
PER_REQUEST = ("outcome", "served_by", "forwards_used", "completion",
               "transfer_used")
COUNTERS = ("overflow", "window_saturation", "event_overflow", "forwards",
            "met_deadline", "processed", "discarded", "events",
            "retire_iterations")
HOT = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3


def _hot_requests():
    return UniformWorkload(HOT, window=1200.0, name="hot").to_arrays(0)[0]


def _scan_matches_eager(reqs, topo, **kw):
    """One ``simulate`` on the CPU (the eager loop) and one on the card,
    which must be one event_scan launch and no event_select launch, and
    agree on every per-request field and counter; returns the card's."""
    cpu = simulate(reqs, topology_arrays(topo), device="cpu", **kw)
    scan.event_scan.launches = es.event_select.launches = 0
    gpu = simulate(reqs, topology_arrays(topo), device="cuda", **kw)
    torch.cuda.synchronize()
    assert scan.event_scan.launches == 1 and es.event_select.launches == 0
    for f in PER_REQUEST:
        g, c = getattr(gpu, f), getattr(cpu, f)
        assert g.device.type == "cuda" and g.dtype == c.dtype, f
        assert torch.equal(g.cpu(), c), f
    for f in COUNTERS:
        assert int(getattr(gpu, f)) == int(getattr(cpu, f)), f
    return gpu


@pytest.mark.gpu
def test_simulate_on_gpu_matches_cpu():
    _need_gpu()
    topo = Topology.full_mesh(3)
    gpu = _scan_matches_eager(_hot_requests(), topo,
                              policy="batched_feasible", capacity=512,
                              depth=256,
                              net=LinkModel.campus(topo).net_params())
    assert int(gpu.forwards) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("net", [None, "campus"])
@pytest.mark.parametrize("policy", ["batched_feasible", "round_robin",
                                    "least_loaded", "trace"])
def test_event_scan_matches_eager_loop(policy, net):
    _need_gpu()
    reqs = _hot_requests()
    topo = Topology.full_mesh(3)
    targets = None
    if policy == "trace":
        targets = np.random.default_rng(1).integers(
            -1, 3, (reqs.arrival.shape[0], 2)).astype(np.int32)
    gpu = _scan_matches_eager(
        reqs, topo, policy=policy, capacity=512, depth=256, targets=targets,
        net=None if net is None else LinkModel.preset(topo, net).net_params())
    assert int(gpu.forwards) > 0
    assert gpu.events == int(gpu.total) + int(gpu.forwards)


# the stochastic policies' fleets: the hot 3-node mesh, a 2-node mesh and
# a star (power_of_two at deg <= 1), and a 32-node mesh with four hot
# nodes (deg 31)
STOCHASTIC_FLEETS = {
    "mesh3": (HOT, Topology.full_mesh(3)),
    "mesh2": (HOT[:2], Topology.full_mesh(2)),
    "star4": ([{"S6": 4}] + HOT, Topology.star(4)),
    "mesh32": ([HOT[0]] * 4 + [{"S6": 2}] * 28, Topology.full_mesh(32)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("net", [None, "campus"])
@pytest.mark.parametrize("fleet", sorted(STOCHASTIC_FLEETS))
@pytest.mark.parametrize("policy", ["random", "power_of_two"])
def test_event_scan_stochastic_policies_match_eager_loop(policy, fleet, net):
    """The kernel's threefry draws (csrc/threefry.cuh) equal the eager
    loop's (fleetsim/rng.py), forward for forward, at two seeds."""
    _need_gpu()
    from repro_torch.fleetsim import SimParams
    counts, topo = STOCHASTIC_FLEETS[fleet]
    reqs, _ = UniformWorkload(counts, window=1200.0,
                              name=fleet).to_arrays(0)
    for seed in (0, 2 ** 31 - 1):
        gpu = _scan_matches_eager(
            reqs, topo, params=SimParams.make(seed), policy=policy,
            capacity=512, depth=256,
            net=None if net is None else
            LinkModel.preset(topo, net).net_params())
        assert int(gpu.forwards) > 0


@pytest.mark.gpu
def test_event_scan_discard_variant_and_sla_scale():
    _need_gpu()
    from repro_torch.fleetsim import SimParams
    topo = Topology.full_mesh(3)
    gpu = _scan_matches_eager(_hot_requests(), topo, params=SimParams.make(
        0, 0.7), policy="least_loaded", capacity=512, depth=256,
        discard_on_exhaust=True, net=LinkModel.campus(topo).net_params())
    assert int(gpu.discarded) > 0


@pytest.mark.gpu
def test_event_scan_undersized_event_plane():
    """An 8-entry re-arrival buffer and 200 steps: pushes are dropped and
    events are left, and both count into event_overflow."""
    _need_gpu()
    gpu = _scan_matches_eager(_hot_requests(), Topology.full_mesh(3),
                              policy="round_robin", capacity=512, depth=256,
                              max_events=200, event_buf=8)
    assert int(gpu.event_overflow) > 0 and gpu.events == 200


@pytest.mark.gpu
def test_event_scan_saturated_window():
    """A 4-slot live window that fills: window_saturation counts the
    events that met it full, and forced requests overflow."""
    _need_gpu()
    gpu = _scan_matches_eager(_hot_requests(), Topology.full_mesh(3),
                              policy="least_loaded", capacity=512, depth=4,
                              max_forwards=1)
    assert int(gpu.window_saturation) > 0


@pytest.mark.gpu
def test_event_scan_heterogeneous_ring():
    _need_gpu()
    topo = Topology.ring(3, speeds=[1.0, 2.0, 0.5])
    _scan_matches_eager(_hot_requests(), topo, policy="batched_feasible",
                        capacity=512, depth=256,
                        net=LinkModel.campus(topo).net_params())


@pytest.mark.gpu
def test_event_scan_256_node_fleet():
    """benchmarks/fleetsim_bench.py's largest fleet, K = 256, at 3,520
    requests (every eighth node as hot as the 3-node fleet, the rest idle
    neighbours): rows past the block's 32 warps, routing over 256 nodes,
    a ring in shared memory beside 256 nodes' scalars."""
    _need_gpu()
    reqs, _ = UniformWorkload([HOT[0] if i % 8 == 0 else {}
                               for i in range(256)], window=1200.0,
                              name="hot256").to_arrays(0)
    topo = Topology.full_mesh(256)
    gpu = _scan_matches_eager(reqs, topo, policy="batched_feasible",
                              capacity=256, depth=128,
                              net=LinkModel.campus(topo).net_params())
    assert int(gpu.total) == 3520 and int(gpu.forwards) > 0


# the 256-node fleet of tests/test_torch_fleet256.py: fleet_workload(256,
# div=200), 2,048 requests, at the paper's SLA and at sla_scale 0.05
# (hundreds of forwards over 255 neighbours a node)
FLEET256_POLICIES = ("batched_feasible", "round_robin", "least_loaded",
                     "trace", "random", "power_of_two")


@pytest.mark.gpu
@pytest.mark.parametrize("sla_scale", [1.0, 0.05])
@pytest.mark.parametrize("policy", FLEET256_POLICIES)
def test_event_scan_fleet256_div200_matches_eager_loop(policy, sla_scale):
    _need_gpu()
    from repro_torch.fleetsim import SimParams
    from repro_torch.orchestration import fleet_workload
    reqs, _ = fleet_workload(256, 200).to_arrays(0)
    targets = None
    if policy == "trace":
        targets = np.random.default_rng(1).integers(
            -1, 256, (reqs.arrival.shape[0], 2)).astype(np.int32)
    gpu = _scan_matches_eager(reqs, Topology.full_mesh(256),
                              params=SimParams.make(0, sla_scale),
                              policy=policy, capacity=128, depth=64,
                              targets=targets)
    assert int(gpu.total) == 2048
    assert int(gpu.overflow) == int(gpu.window_saturation) == \
        int(gpu.event_overflow) == 0
    if sla_scale < 1.0:
        assert int(gpu.forwards) > 300


@pytest.mark.gpu
def test_radio_dead_on_arrival_on_the_card():
    """An uplink that eats the whole SLA budget (budgets clamped to
    ``MIN_DEADLINE``): on the card, as on the CPU, every request is
    forced and late, and ``run_validation`` is exact against the heap."""
    _need_gpu()
    from repro_torch.fleetsim import validate
    from repro_torch.netsim import CellSite, RadioModel, RadioWorkload
    from repro_torch.netsim.radio import MIN_DEADLINE
    topo = Topology.full_mesh(2)
    radio = RadioModel([CellSite(0, node=0, uplink_latency=5000.0),
                        CellSite(1, node=1, uplink_latency=5000.0)])
    wl = RadioWorkload(UniformWorkload([{"S6": 4}, {"S6": 4}], window=200.0,
                                       name="doa"), radio)
    reqs, _ = wl.to_arrays(0)
    assert (reqs.rel_deadline == np.float32(MIN_DEADLINE)).all()
    for policy in ("round_robin", "random", "batched_feasible"):
        gpu = _scan_matches_eager(reqs, topo, policy=policy, capacity=64,
                                  depth=32)
        assert int(gpu.met_deadline) == 0 and int(gpu.processed) == 8
        rep = validate.run_validation(wl, 0, policy=policy, topology=topo,
                                      device="cuda")
        assert rep.exact, rep.row()
        assert rep.fleet["met_deadline"] == 0
        assert rep.fleet["processed"] == 8


@pytest.mark.gpu
def test_event_scan_ring_in_global_memory(monkeypatch):
    """A buffer too large for shared memory lives in global scratch: the
    same run as with the ring in shared memory."""
    _need_gpu()
    topo = Topology.full_mesh(3)
    kw = dict(policy="batched_feasible", capacity=512, depth=256,
              net=LinkModel.campus(topo).net_params())
    monkeypatch.setattr(scan, "SHARED_LIMIT", 2048)
    assert scan.shared_bytes(3, 340, True) > scan.SHARED_LIMIT
    _scan_matches_eager(_hot_requests(), topo, **kw)


def _captured_scans(monkeypatch, fn):
    """Run ``fn`` with every event_scan launch's arguments kept."""
    calls, real = [], scan.event_scan

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(scan, "event_scan", spy)
    out = fn()
    monkeypatch.setattr(scan, "event_scan", real)
    return out, calls


@pytest.mark.gpu
@pytest.mark.parametrize("telemetry", [None, (8, 3000.0)])
def test_event_scan_cells_equal_single_cell_launches(monkeypatch, telemetry):
    """A sweep of six cells (seeds, SLA scales and networks each their own)
    is one launch of six blocks, and each block's outputs equal, bit for
    bit, those of its cell launched alone."""
    _need_gpu()
    from repro_torch.fleetsim import NetParams, SimParams, simulate_fn
    from repro_torch.telemetry import TelemetryConfig
    nets = [NetParams.uniform(3, lam, ibw) for lam, ibw in
            ((0.0, 0.0), (5.0, 0.8), (30.0, 3.2))] * 2
    net = NetParams(np.stack([n.latency for n in nets]),
                    np.stack([n.inv_bw for n in nets]))
    run = simulate_fn(policy="random", capacity=512, depth=256,
                      network=True, device="cuda",
                      telemetry=None if telemetry is None
                      else TelemetryConfig(*telemetry))
    scan.event_scan.launches = scan.event_scan.telemetry_launches = 0
    m, calls = _captured_scans(monkeypatch, lambda: run(
        _hot_requests(), topology_arrays(Topology.full_mesh(3)),
        SimParams.make([0, 1, 2, 3, 2 ** 31 - 1, 5],
                       [1.0, 0.7, 1.0, 1.5, 1.0, 0.5]), None, net))
    torch.cuda.synchronize()
    assert scan.event_scan.launches == len(calls) == 1
    assert scan.event_scan.telemetry_launches == (telemetry is not None)
    (args, kw), = calls
    whole = scan.event_scan(*args, **kw)
    assert whole.counts.shape == (6, len(scan.COUNTS))
    for c in range(6):
        cut = lambda t: t[c:c + 1] if t.dim() == 3 else t
        one = scan.event_scan(*(cut(a) for a in args),
                              **dict(kw, seed=[kw["seed"][c]]))
        for f in scan.ScanOut._fields:
            x, y = getattr(whole, f), getattr(one, f)
            assert (x is None) == (y is None) == (
                telemetry is None and f.startswith("tel_")), f
            if x is not None:
                assert torch.equal(x[c], y[0]), (c, f)
    assert len(set(m.met_deadline.tolist())) > 1


@pytest.mark.gpu
@pytest.mark.parametrize("net", [None, "campus"])
@pytest.mark.parametrize("policy", ["batched_feasible", "random",
                                    "round_robin"])
def test_event_scan_telemetry_equals_eager_loop(policy, net):
    """The kernel's telemetry instantiation carries the eager loop's cube:
    counters and occupancy exactly, the integrals within DERIVED_ATOL;
    every other output equals the run without telemetry, which launches
    the instantiation without it."""
    _need_gpu()
    from repro_torch.telemetry import (TelemetryConfig, TelemetrySummary,
                                       compare_summaries)
    topo = Topology.full_mesh(3)
    kw = dict(policy=policy, capacity=512, depth=256,
              net=None if net is None else
              LinkModel.preset(topo, net).net_params())
    cfg = TelemetryConfig(16, 3000.0)
    cpu = simulate(_hot_requests(), topology_arrays(topo), device="cpu",
                   telemetry=cfg, **kw)
    scan.event_scan.telemetry_launches = 0
    on = _scan_matches_eager(_hot_requests(), topo, telemetry=cfg, **kw)
    assert scan.event_scan.telemetry_launches == 1
    off = _scan_matches_eager(_hot_requests(), topo, **kw)
    assert scan.event_scan.telemetry_launches == 1 and off.telemetry is None
    for f in PER_REQUEST:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert torch.equal(on.telemetry.counts.cpu(), cpu.telemetry.counts)
    assert torch.equal(on.telemetry.occupancy_hwm.cpu(),
                       cpu.telemetry.occupancy_hwm)
    agr = compare_summaries(TelemetrySummary.from_frame(cpu.telemetry),
                            TelemetrySummary.from_frame(on.telemetry))
    assert agr.ok, agr.row()


@pytest.mark.gpu
def test_event_scan_error_names_the_cell():
    """A recorded second-hop target off the fleet, read only where a
    request is forwarded once (the cell whose SLA is tight enough to
    forward), stops that cell and names it; an origin off the fleet stops
    every cell, and the first is named."""
    _need_gpu()
    from repro_torch.fleetsim import SimParams, simulate_fn
    reqs = _hot_requests()
    targets = np.stack([(reqs.origin + 1) % 3,
                        np.full_like(reqs.origin, 7)], 1).astype(np.int32)
    run = simulate_fn(policy="trace", capacity=512, depth=256,
                      device="cuda")
    topo = topology_arrays(Topology.full_mesh(3))
    with pytest.raises(ValueError, match="forwarding target.*sweep cell 1 "
                                         "of 2"):
        run(reqs, topo, SimParams.make(0, [1e6, 1.0]), targets)
    origin = reqs.origin.copy()
    origin[5] = 3
    with pytest.raises(ValueError, match="origin node.*sweep cell 0 of 2"):
        run(reqs._replace(origin=origin), topo, SimParams.make([0, 1]),
            None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,D,causal,window", [
    (1, 4, 4, 64, False, None), (129, 8, 2, 80, True, None),
    (578, 12, 12, 64, False, None), (300, 4, 1, 128, True, 50),
    (77, 6, 3, 12, False, 20)])
def test_flash_attention_kernel_matches_plain_version(S, H, KV, D, causal,
                                                      window, dtype):
    _need_gpu()
    g = torch.Generator().manual_seed(S * 7 + D)
    q, k, v = (torch.randn(2, S, h, D, generator=g).to("cuda", dtype)
               for h in (H, KV, KV))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.flash_attention_tolerance(want, v))


@pytest.mark.gpu
def test_flash_attention_kernel_on_misaligned_tensors():
    """Views one element into their storage: rows are no longer 16-byte
    aligned, which the kernel's loads must not assume."""
    _need_gpu()
    g = torch.Generator().manual_seed(3)
    n = 2 * 130 * 4 * 64
    buf = torch.randn(3 * n + 1, generator=g).to("cuda", torch.bfloat16)
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(2, 130, 4, 64)
               for i in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.flash_attention_tolerance(want, v))


@pytest.mark.gpu
def test_flash_attention_check_rejects_a_dropped_key():
    """At the served shape the kernel passes the tolerance and a planted
    fault, the output without the last key of the ragged tail tile, does
    not."""
    _need_gpu()
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 578, 12, 64, generator=g).to("cuda",
                                                            torch.bfloat16)
               for _ in range(3))
    want = ref.flash_attention_ref(q, k, v, causal=False).float()
    tol = ref.flash_attention_tolerance(want, v)
    got = ops.flash_attention(q, k, v, causal=False).float()
    dropped = ref.flash_attention_ref(q, k[:, :-1], v[:, :-1], causal=False)
    assert torch.allclose(got, want, **tol)
    assert not torch.allclose(dropped.float(), want, **tol)


@pytest.mark.gpu
def test_flash_attention_check_rejects_a_dropped_key_at_d80():
    """ViT-H/14's heads (16 of width 80) at its 730 tokens: the tma_wgmma
    kernel passes the tolerance, and the output without the last key of
    the ragged tail tile does not."""
    _need_gpu()
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 730, 16, 80, generator=g).to("cuda",
                                                            torch.bfloat16)
               for _ in range(3))
    assert fa.variant(q, k, v) == "tma_wgmma"
    want = ref.flash_attention_ref(q, k, v, causal=False).float()
    tol = ref.flash_attention_tolerance(want, v)
    got = ops.flash_attention(q, k, v, causal=False).float()
    dropped = ref.flash_attention_ref(q, k[:, :-1], v[:, :-1], causal=False)
    assert torch.allclose(got, want, **tol)
    assert not torch.allclose(dropped.float(), want, **tol)


@pytest.mark.gpu
def test_vit_on_gpu_matches_cpu():
    """The smoke DeiT in f32 on the kernel path (S = 18 > 16): one launch
    per layer; logits as on the CPU within 1e-4 (TF32 off)."""
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("deit-b"), attn_impl="pallas",
                              attn_chunk=16, param_dtype="float32")
    tree = vit.numpy_params(cfg, 0)
    img = torch.from_numpy(np.random.default_rng(0).random(
        (3, 32, 32, 3), dtype=np.float32))
    cpu = vit.forward(vit.params_from_numpy(tree, cfg, "cpu"), img, cfg)
    fa.flash_attention.launches = 0
    gpu = vit.forward(vit.params_from_numpy(tree, cfg, "cuda"), img.cuda(),
                      cfg)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == cfg.n_layers
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the entry-point kernels: fleet_feasibility, link_cost, rmsnorm, moe_gemm
# ---------------------------------------------------------------------------
def _ledgers(rng, K, N, dev):
    """Head-pointer ledgers on a half grid, row 0 full (head + n == N) and
    row 1 empty, with per-node ps / busy and the source's network rows."""
    starts = np.full((K, N), BIG, np.float32)
    ends = np.full((K, N), BIG, np.float32)
    sizes = np.zeros((K, N), np.float32)
    head = rng.integers(0, N // 4 + 1, K).astype(np.int32)
    n = np.asarray([rng.integers(0, N - h + 1) for h in head], np.int32)
    n[0] = N - head[0]
    if K > 1:
        n[1] = 0
    for k in range(K):
        starts[k, :head[k]] = ends[k, :head[k]] = -BIG
        gaps = np.where(rng.random(n[k]) < 0.6, 0.0,
                        rng.integers(1, 60, n[k]) / 2)
        size = rng.choice([20.0, 44.0, 180.0], n[k])
        s = float(rng.integers(0, 200)) + np.cumsum(gaps + size) - size
        starts[k, head[k]:head[k] + n[k]] = s
        ends[k, head[k]:head[k] + n[k]] = s + size
        sizes[k, head[k]:head[k] + n[k]] = size
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    live = starts[(starts > -BIG) & (starts < BIG)]
    return dict(
        starts=f(starts), ends=f(ends), sizes=f(sizes),
        n=torch.from_numpy(n).to(dev), head=torch.from_numpy(head).to(dev),
        ps=f(rng.choice([5.0, 20.0, 44.0, 180.0], K)),
        busy=f(rng.integers(0, 200, K) / 2),
        lat=f(rng.uniform(0, 120, K)), ibw=f(rng.choice([0.0, 0.1, 0.8], K)),
        edges=live.tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(1, 8), (5, 64), (37, 100), (256, 1024)])
def test_admission_kernels_match_plain_versions(K, N):
    """Both kernels, bit for bit, with deadlines on block edges; one launch
    per call."""
    _need_gpu()
    from repro_torch.kernels import admission
    rng = np.random.default_rng(K * 100 + N)
    L = _ledgers(rng, K, N, torch.device("cuda"))
    led = (L["starts"], L["ends"], L["sizes"], L["n"])
    deadlines = [500.0, 9000.0] + [float(rng.choice(L["edges"]))] * bool(
        L["edges"])
    for d in deadlines:
        dt = torch.tensor(d, device="cuda")
        before = admission.fleet_feasibility.launches
        got = ops.fleet_feasibility(*led, L["ps"], dt, L["busy"], L["head"])
        want = ref.fleet_feasibility_ref(*led, L["ps"], dt, L["busy"],
                                         L["head"])
        assert admission.fleet_feasibility.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        t, pay = torch.tensor(10.5, device="cuda"), torch.tensor(
            24.8832, device="cuda")
        before = admission.link_cost.launches
        got = ops.link_cost(*led, L["ps"], dt, L["busy"], L["head"], t,
                            L["lat"], L["ibw"], pay)
        want = ref.link_cost_ref(*led, L["ps"], dt, L["busy"], L["head"], t,
                                 L["lat"], L["ibw"], pay)
        torch.cuda.synchronize()
        assert admission.link_cost.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert not bool(got[0][0])                        # the full row


@pytest.mark.gpu
@pytest.mark.parametrize("K,W", [(3, 64), (32, 512), (6, 1024), (5, 1000)])
def test_event_select_scores_as_link_cost_on_gpu(K, W):
    """The three kernels on one input: event_select's feasible, arrive and
    load are link_cost's from the selected node's network row, and
    fleet_feasibility's from max(arrive, busy)."""
    _need_gpu()
    rng = np.random.default_rng(K + W)
    for _ in range(4):
        args = _fleet_args(rng, K, W, torch.device("cuda"))
        take, t, node, feas, arrive, _, _, load = ops.event_select(*args)
        starts, ends, sizes, n, head, speeds, busy, lat, ibw = args[12:]
        pick = lambda a, b: torch.where(take, a, b)
        d, ps = pick(args[2], args[8]), pick(args[3], args[9]) / speeds
        lc = ops.link_cost(starts, ends, sizes, n, ps, d, busy, head, t,
                           lat[node.long()], ibw[node.long()],
                           pick(args[4], args[10]))
        ff = ops.fleet_feasibility(starts, ends, sizes, n, ps, d,
                                   torch.maximum(arrive, busy), head)
        for g, w in ((lc[0], feas), (lc[1], arrive), (lc[2], load),
                     (ff[0], feas), (ff[1], load)):
            assert torch.equal(g, w)




def _wide_ledgers(rng, K, N, dyadic, dev):
    """Head-pointer ledgers built by whole arrays (K up to 1024, N up to
    20000): 15% of the rows full, row 0 full and row 1 empty where K > 2,
    heads up to N / 4; times on a 0.5 grid, or sizes over speed 3 where
    ``dyadic`` is false.  Returns the ledgers, per-node scalars and network
    rows, and the live block edges."""
    head = rng.integers(0, N // 4 + 1, K)
    n = rng.integers(0, N - head + 1)
    n = np.where(rng.random(K) < 0.15, N - head, n)
    if K > 2:
        n[0], n[1] = N - head[0], 0
    speeds = rng.choice([0.5, 1.0, 2.0] if dyadic else [1.0, 3.0], K)
    idx = np.arange(N)[None, :]
    live = (idx >= head[:, None]) & (idx < (head + n)[:, None])
    size = rng.choice([20.0, 44.0, 180.0], (K, N)) / speeds[:, None] * live
    gap = np.where(rng.random((K, N)) < 0.6, 0.0,
                   rng.integers(1, 100, (K, N)) / 2) * live
    ends = rng.integers(0, 400, K)[:, None] / 2 + np.cumsum(gap + size, 1)
    starts = ends - size
    retired = idx < head[:, None]
    starts = np.where(live, starts, np.where(retired, -BIG, BIG))
    ends = np.where(live, ends, np.where(retired, -BIG, BIG))
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    return dict(led=(f(starts), f(ends), f(size), i(n)), head=i(head),
                ps=f(rng.choice([20.0, 44.0, 180.0], K) / speeds),
                busy=f(rng.integers(0, 400, K) / 2),
                lat=f(rng.uniform(0, 120, K)),
                ibw=f(rng.choice([0.0, 0.1, 0.8, 1.0], K)),
                edges=np.asarray(starts, np.float32)[live])


def _admission_equal(kernel, got, want, dyadic, sizes):
    names = {"fleet_feasibility": ("feasible", "load"),
             "link_cost": ("feasible", "arrive", "load")}[kernel]
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "load":
            assert torch.equal(g, ref.lane_tree_sum(sizes)), kernel
        if name == "load" and not dyadic:
            assert torch.allclose(g, w, rtol=ref.load_rtol(sizes.shape[1]),
                                  atol=0.0), kernel
        else:
            assert torch.equal(g, w), (kernel, name)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 7, 8, 64, 1000, 1024, 20000])
@pytest.mark.parametrize("K", [1, 2, 5, 131, 133, 256, 1024])
def test_admission_kernels_at_their_edges(K, N):
    """The block-per-row kernels against their plain versions: N not a
    multiple of 4 (misaligned rows), rows longer than one staged chunk
    (N = 20000), K on both sides of the SM count; head-pointer rows, full
    and empty rows, deadlines on block edges and far past every block;
    dyadic sizes (every output bit for bit) and sizes over speed 3
    (``load`` within ``ref.load_rtol``); ``load`` always bit for bit the
    kernels' association, ``ref.lane_tree_sum``."""
    _need_gpu()
    from repro_torch.kernels import admission
    dev = torch.device("cuda")
    rng = np.random.default_rng(K * 100000 + N)
    sc = lambda v: torch.tensor([v], dtype=torch.float32, device=dev)
    for dyadic in (True, False):
        L = _wide_ledgers(rng, K, N, dyadic, dev)
        edges = L["edges"] if L["edges"].size else np.asarray([500.0])
        for d in (float(rng.choice(edges)), float(rng.choice(edges)),
                  float(rng.integers(0, 4 * N + 800)) / 2, 1e9):
            args = (*L["led"], L["ps"], sc(d), L["busy"], L["head"])
            before = admission.fleet_feasibility.launches
            got = ops.fleet_feasibility(*args)
            want = ref.fleet_feasibility_ref(*args)
            torch.cuda.synchronize()
            assert admission.fleet_feasibility.launches == before + 1
            _admission_equal("fleet_feasibility", got, want, dyadic,
                             L["led"][2])
            args = (*L["led"], L["ps"], sc(d), L["busy"], L["head"],
                    sc(120.5), L["lat"], L["ibw"], sc(24.8832))
            before = admission.link_cost.launches
            got = ops.link_cost(*args)
            want = ref.link_cost_ref(*args)
            torch.cuda.synchronize()
            assert admission.link_cost.launches == before + 1
            _admission_equal("link_cost", got, want, dyadic, L["led"][2])
    if K > 2:
        assert not bool(got[0][0])                # the full row


@pytest.mark.gpu
def test_admission_kernels_on_offset_views():
    """Ledgers that start 1, 2 and 3 floats past a 16-byte boundary, each
    array at another offset: every row's aligned body and its head and tail
    are staged apart."""
    _need_gpu()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    K, N = 9, 1030
    L = _wide_ledgers(rng, K, N, True, dev)
    views = []
    for shift, t in zip((1, 2, 3), L["led"][:3]):
        buf = torch.empty(K * N + shift, dtype=t.dtype, device=dev)
        v = buf[shift:].view(K, N)
        v.copy_(t)
        views.append(v)
    for d in (float(rng.choice(L["edges"])), 5000.0):
        sc = torch.tensor([d], device=dev)
        got = ops.fleet_feasibility(*views, L["led"][3], L["ps"], sc,
                                    L["busy"], L["head"])
        want = ref.fleet_feasibility_ref(*L["led"], L["ps"], sc, L["busy"],
                                         L["head"])
        _admission_equal("fleet_feasibility", got, want, True, L["led"][2])


def _hot_heap(device, calls=None):
    """The event heap on the hot 3-node mix under ``batched_feasible`` with
    campus pricing; counts the router's decisions into ``calls``."""
    from repro_torch.fleetsim import validate
    from repro_torch.orchestration import router as rmod
    real = rmod.Router._batched_feasible

    def decide(self, nodes, src, cand_ids, request, now):
        if calls is not None and request is not None:
            calls["decisions"] += 1
        return real(self, nodes, src, cand_ids, request, now)

    rmod.Router._batched_feasible = decide
    try:
        topo = Topology.full_mesh(3)
        out = validate._host_run(UniformWorkload(HOT, window=1200.0,
                                                 name="hot"),
                                 topo, 0, "batched_feasible", 2, False,
                                 network=LinkModel.campus(topo),
                                 device=device)
    finally:
        rmod.Router._batched_feasible = real
    return out


@pytest.mark.gpu
def test_router_on_gpu_matches_cpu():
    """The heap's decisions with the router scoring through the kernel on
    the card equal those with its plain version on the CPU, and each
    decision is one ``fleet_feasibility`` launch."""
    _need_gpu()
    import collections
    from repro_torch.kernels import admission
    calls = collections.Counter()
    before = admission.fleet_feasibility.launches
    gpu = _hot_heap("cuda", calls)
    assert admission.fleet_feasibility.launches - before == \
        calls["decisions"] > 50
    cpu = _hot_heap("cpu")
    decisions = lambda run: [(r.origin_node, r.served_by, r.forwards,
                              r.completion_time) for r in run[1].completed]
    assert decisions(gpu) == decisions(cpu)
    assert np.array_equal(gpu[2], cpu[2])


@pytest.mark.gpu
def test_routed_decisions_run_one_device_kernel_each():
    """Under torch.profiler, the heap's routed decisions on CUDA run one
    device kernel each, ``fleet_feasibility_kernel``, beside one copy in and
    one copy out each (no ``torch_queue.feasible_nodes`` kernels)."""
    _need_gpu()
    import collections
    calls = collections.Counter()

    def run():
        calls.clear()
        return _hot_heap("cuda", calls)

    _hot_heap("cuda")                                  # built and warm
    _, kernels, _ = _device_kernels(run)
    copies = {k: v for k, v in kernels.items() if k.startswith("Memcpy")}
    other = {k: v for k, v in kernels.items() if k not in copies}
    assert len(other) == 1, other
    (name, count), = other.items()
    assert "fleet_feasibility_kernel" in name
    assert count == calls["decisions"] > 50
    assert sorted(copies.values()) == [count, count], copies


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d", [(1, 7), (5, 64), (300, 128), (7, 7168),
                                 (3, 5376), (2, 20000)])
def test_rmsnorm_kernel_matches_plain_version(R, d, dtype):
    _need_gpu()
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator().manual_seed(R * 7 + d)
    x = torch.randn(R, d, generator=g).to("cuda", dtype)
    s = (torch.randn(d, generator=g) * 0.1).to("cuda", dtype)
    before = rn.rmsnorm.launches
    got = ops.rmsnorm(x, s)
    want = ref.rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.rmsnorm_tolerance(dtype))


@pytest.mark.gpu
def test_rmsnorm_kernel_on_misaligned_and_non_contiguous_tensors():
    """A view one element into its storage takes the scalar path; a
    non-contiguous one is refused."""
    _need_gpu()
    g = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn(4 * 512 + 1, generator=g).to("cuda", dtype)
        x = buf[1:].view(4, 512)
        s = torch.randn(512, generator=g).to("cuda") * 0.1
        torch.testing.assert_close(ops.rmsnorm(x, s).float(),
                                   ref.rmsnorm_ref(x, s).float(),
                                   **ref.rmsnorm_tolerance(dtype))
        with pytest.raises(ValueError, match="contiguous"):
            ops.rmsnorm(torch.randn(8, 64, device="cuda", dtype=dtype).t(),
                        torch.zeros(8, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f", [(4, 64, 128, 256), (8, 100, 64, 96),
                                     (3, 37, 40, 21), (2, 130, 1536, 500)])
def test_moe_gemm_kernel_matches_plain_version(E, C, d, f, dtype):
    _need_gpu()
    from repro_torch.kernels import moe_gemm as mg
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(E * 1000 + C + d + f)
    x = torch.randn(E, C, d, generator=g).to("cuda", dtype)
    w = torch.randn(E, d, f, generator=g).to("cuda", dtype)
    before = mg.moe_gemm.launches
    got = ops.moe_gemm(x, w)
    want = ref.moe_gemm_ref(x, w)
    torch.cuda.synchronize()
    assert mg.moe_gemm.launches == before + 1
    assert got.dtype == dtype and got.shape == (E, C, f)
    tol = ref.moe_gemm_tolerance(x, w)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    dropped = ref.moe_gemm_ref(x[..., :-8], w[:, :-8])
    assert not torch.allclose(dropped.float(), want.float(), **tol)


@pytest.mark.gpu
def test_moe_gemm_kernel_on_misaligned_and_non_contiguous_tensors():
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(6)
    E, C, d, f = 2, 70, 64, 48
    buf = torch.randn(E * C * d + E * d * f + 1, generator=g).to(
        "cuda", torch.bfloat16)
    x = buf[1:1 + E * C * d].view(E, C, d)
    w = buf[1 + E * C * d:].view(E, d, f)
    want = ref.moe_gemm_ref(x, w)
    torch.testing.assert_close(ops.moe_gemm(x, w).float(), want.float(),
                               **ref.moe_gemm_tolerance(x, w))
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_gemm(x, w.transpose(1, 2).contiguous().transpose(1, 2))


# ---------------------------------------------------------------------------
# the TMA / wgmma kernels at the edges of their design
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("E,C,d,f", [
    (1, 256, 256, 256),      # one expert
    (3, 1, 64, 256),         # one row of a 128-row tile
    (2, 127, 512, 264),      # C one short of a tile; f 8 past a 256 tile
    (2, 129, 512, 512),      # C one past a tile
    (2, 1000, 1536, 504),    # ragged C and f
    (4, 64, 8, 64),          # d = 8: a single partial 64-deep stage
    (2, 256, 1536, 256)])    # 24 stages through a 3-stage ring, many wraps
def test_moe_gemm_tma_kernel_at_its_edges(E, C, d, f):
    _need_gpu()
    from repro_torch.kernels import moe_gemm as mg
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(E * 7 + C + d + f)
    x = torch.randn(E, C, d, generator=g).to("cuda", torch.bfloat16)
    w = torch.randn(E, d, f, generator=g).to("cuda", torch.bfloat16)
    assert mg.variant(x, w) == "tma_wgmma"
    before = mg.moe_gemm.launches
    got = ops.moe_gemm(x, w)
    want = ref.moe_gemm_ref(x, w)
    torch.cuda.synchronize()
    assert mg.moe_gemm.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (E, C, f)
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.moe_gemm_tolerance(x, w))


_FLASH_MASKS = [(False, None, 12, 12), (True, None, 12, 4), (True, 100, 12, 12),
                (False, 40, 12, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window,H,KV", _FLASH_MASKS)
@pytest.mark.parametrize("S", [1, 63, 65, 578, 730, 1024])
@pytest.mark.parametrize("B", [1, 8])
def test_flash_attention_wgmma_kernel_at_its_edges(B, S, causal, window, H,
                                                   KV):
    """The key tiles split between two warpgroups (B = 1, and B = 8 at
    S <= 65) and the full grid (B = 8 at S = 578, 730 and 1024), causal,
    window and GQA, D = 64 and 128, and the heads read narrower than their
    boxes, D = 72 (DiT-XL/2) and 80 (ViT-H/14)."""
    _need_gpu()
    for D in (64, 72, 80, 128):
        g = torch.Generator().manual_seed(B * S + D + H * KV)
        q, k, v = (torch.randn(B, S, h, D, generator=g).to("cuda",
                                                           torch.bfloat16)
                   for h in (H, KV, KV))
        assert fa.variant(q, k, v) == "tma_wgmma"
        before = fa.flash_attention.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **ref.flash_attention_tolerance(want, v))


def test_flash_edge_cases_take_both_paths():
    """The parameters above reach both the split-key and the full-grid
    path on a 132-SM card (decided on the CPU)."""
    paths = {fa.split_keys(B, S, 12, 132) for B in (1, 8)
             for S in (1, 63, 65, 578, 1024)}
    assert paths == {True, False}


# (B, S, H, KV, D, causal, window) where the key band (the tiles some row
# of a query tile sees) has its edges: causal GQA past the served lengths
# at Granite's 24 / 8 and StarCoder2's 36 / 4 heads; windows of 1, 63, 64,
# 65 and 1,024 keys at S = 1,100 (not a multiple of 64), causal and not,
# in the split mode (B = 1, 4 heads) and the full grid (B = 2, 12 heads)
_FLASH_BANDS = [
    (1, 4097, 24, 8, 64, True, None), (1, 8192, 24, 8, 64, True, None),
    (1, 4097, 36, 4, 128, True, None), (1, 8192, 36, 4, 128, True, None),
    *[(B, 1100, H, KV, None, causal, w) for w in (1, 63, 64, 65, 1024)
      for causal in (True, False) for B, H, KV in ((1, 4, 2), (2, 12, 4))]]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", _FLASH_BANDS)
def test_flash_attention_wgmma_kernel_on_its_key_bands(B, S, H, KV, D,
                                                       causal, window):
    """The tma_wgmma kernel where the band cuts the key loop (the causal
    diagonal, the window's first key, both), in both grid modes, against
    the plain attention by blocks of query rows; D = 64 and 128 where the
    case names none."""
    _need_gpu()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (64, 128) if D is None else (D,):
        g = torch.Generator().manual_seed(B * S + d + H * KV + (window or 0))
        q, k, v = (torch.randn(B, S, h, d, generator=g).to("cuda",
                                                           torch.bfloat16)
                   for h in (H, KV, KV))
        assert fa.variant(q, k, v) == "tma_wgmma"
        if D is None:
            assert fa.split_keys(B, S, H, sms) == (B == 1)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref_by_blocks(q, k, v, causal=causal,
                                                 window=window)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **ref.flash_attention_tolerance(want, v))


@pytest.mark.gpu
def test_flash_attention_causal_launch_skips_the_masked_tiles():
    """At (1, 8192, 24 / 8, 64) bf16 the causal launch walks 8,256 of the
    16,384 key-tile products a head and takes under 0.7 of the non-causal
    launch on the same inputs (CUDA events, the median of 5; 128 query
    tiles a head leave a longer tail than Granite's 32k prefill)."""
    _need_gpu()
    g = torch.Generator().manual_seed(27)
    q, k, v = (torch.randn(1, 8192, h, 64, generator=g).to("cuda",
                                                           torch.bfloat16)
               for h in (24, 8, 8))

    def median_ms(causal):
        fa.flash_attention(q, k, v, causal=causal)
        times = []
        for _ in range(5):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fa.flash_attention(q, k, v, causal=causal)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return sorted(times)[2]

    causal, full = median_ms(True), median_ms(False)
    assert causal < 0.7 * full, (causal, full)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (8, 578, 12, 12, 64, False, None), (2, 1, 4, 4, 80, True, None),
    (2, 63, 8, 2, 80, True, None), (2, 65, 8, 1, 80, True, 20),
    (2, 65, 4, 4, 80, False, 40), (2, 129, 6, 3, 128, True, None),
    (2, 100, 4, 2, 12, False, None), (2, 70, 4, 4, 7, True, 30)])
def test_flash_attention_f32_kernel_at_its_edges(B, S, H, KV, D, causal,
                                                 window):
    """The register-tiled f32 kernel at DeiT-B's shape at 384 px and at
    ragged S (a single key, one past and one short of a 64-key tile),
    causal, window and GQA, D = 80 (padded to 128 with 32-key tiles),
    128, 12, and D = 7 (4-byte copies)."""
    _need_gpu()
    g = torch.Generator().manual_seed(B * S + D + H * KV)
    q, k, v = (torch.randn(B, S, h, D, generator=g).to("cuda")
               for h in (H, KV, KV))
    assert fa.variant(q, k, v) == "f32_regtile"
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want,
                               **ref.flash_attention_tolerance(want, v))


@pytest.mark.gpu
def test_flash_attention_f32_kernel_on_misaligned_tensors():
    """f32 views one element into their storage: the kernel copies 4
    bytes at a time there."""
    _need_gpu()
    g = torch.Generator().manual_seed(6)
    n = 2 * 130 * 4 * 64
    buf = torch.randn(3 * n + 1, generator=g).to("cuda")
    q, k, v = (buf[1 + i * n:1 + (i + 1) * n].view(2, 130, 4, 64)
               for i in range(3))
    assert fa.variant(q, k, v) == "f32_regtile"
    got = ops.flash_attention(q, k, v, causal=True, window=50)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=50)
    torch.testing.assert_close(got, want,
                               **ref.flash_attention_tolerance(want, v))


RMSNORM_GRID = [(1000, 5376), (1, 5376), (300, 7), (333, 20008), (4096, 1536)]
# the backward kernel at the train step's shapes (phase 6a of chip_smoke.py)
RMSNORM_BWD_SHAPES = [(8192, 1536), (4096, 1536), (7, 7168), (1000, 1023)]
# Profiles rmsnorm cases in fresh processes, a few each: in a long test
# process the profiler's windows now and then record no device entry at all
# (in 1, 19 and 20 of these 20 cases in full-file runs, three windows in a
# row), and a fresh process saw it once in 28 windows; so each process
# profiles at most RMSNORM_CASES_A_PROCESS cases, each window retried up to
# PROFILE_TRIES times while it holds no device entry.  Prints one JSON
# object: case -> {kernel name: count}.
RMSNORM_CASES_A_PROCESS = 6
_PROFILE_RMSNORM = r"""
import json, sys, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import rmsnorm as rn
cases, out = json.loads(sys.argv[1]), {}
for key, (kind, R, d, dt, sdt) in cases.items():
    g = torch.Generator().manual_seed(R + d)
    dtype, sdtype = getattr(torch, dt), getattr(torch, sdt)
    x = torch.randn(R, d, generator=g).to("cuda", dtype)
    s = (torch.randn(d, generator=g) * 0.1).to("cuda", sdtype)
    dy = torch.randn(R, d, generator=g).to("cuda", dtype)
    fn = (lambda: rn.rmsnorm(x, s)) if kind == "fwd" else \
        (lambda: rn.rmsnorm_bwd(x, s, dy))
    fn()
    torch.cuda.synchronize()
    for _ in range(int(sys.argv[2])):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        out[key] = {e.key: e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA}
        if out[key]:
            break
print(json.dumps(out))
"""


def _case(kind, R, d, dtype, scale_dtype):
    return f"{kind}:{R}x{d}:{dtype}:{scale_dtype}".replace("torch.", "")


@pytest.fixture(scope="module")
def rmsnorm_kernel_counts():
    """Device kernels of one call of each rmsnorm case (forward grid and
    backward shapes, f32 and bf16), profiled in a fresh process."""
    _need_gpu()
    import json
    import os
    import subprocess
    import sys
    cases = {}
    for R, d in RMSNORM_GRID:
        for dt in ("float32", "bfloat16"):
            for sdt in ("float32", "bfloat16"):
                cases[_case("fwd", R, d, dt, sdt)] = ("fwd", R, d, dt, sdt)
    for R, d in RMSNORM_BWD_SHAPES:
        for dt in ("float32", "bfloat16"):
            cases[_case("bwd", R, d, dt, dt)] = ("bwd", R, d, dt, dt)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    keys, counts = list(cases), {}
    for i in range(0, len(keys), RMSNORM_CASES_A_PROCESS):
        part = {k: cases[k] for k in keys[i:i + RMSNORM_CASES_A_PROCESS]}
        proc = subprocess.run([sys.executable, "-c", _PROFILE_RMSNORM,
                               json.dumps(part), str(PROFILE_TRIES)],
                              capture_output=True, text=True, env=env,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        counts.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d", RMSNORM_GRID)
def test_rmsnorm_kernel_scale_dtypes_and_grid(R, d, dtype, scale_dtype,
                                              rmsnorm_kernel_counts):
    """The scale read in its own dtype (f32 or bf16) by one launch; R not a
    multiple of the persistent grid, one row, d = 7 (single elements) and
    a d past the register cache (20008: the rest read again).  The device
    kernels of one call are counted in a fresh process
    (``rmsnorm_kernel_counts``)."""
    _need_gpu()
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator().manual_seed(R + d)
    x = torch.randn(R, d, generator=g).to("cuda", dtype)
    s = (torch.randn(d, generator=g) * 0.1).to("cuda", scale_dtype)
    want = ref.rmsnorm_ref(x, s)
    before = rn.rmsnorm.launches
    got = ops.rmsnorm(x, s)
    assert rn.rmsnorm.launches == before + 1
    kernels = rmsnorm_kernel_counts[_case("fwd", R, d, dtype, scale_dtype)]
    assert list(kernels.values()) == [1], kernels
    assert "rmsnorm" in next(iter(kernels)), kernels
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.rmsnorm_tolerance(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d", RMSNORM_BWD_SHAPES)
def test_rmsnorm_backward_kernel_matches_plain(R, d, dtype,
                                               rmsnorm_kernel_counts):
    """dx and dscale of one launch (one device kernel) against
    ``ref.rmsnorm_bwd_ref``, deterministic (a second launch gives the same
    bits); the same through ``ops.rmsnorm``'s autograd."""
    _need_gpu()
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator().manual_seed(R + d)
    x = torch.randn(R, d, generator=g).to("cuda", dtype)
    s = (torch.randn(d, generator=g) * 0.1).to("cuda", dtype)
    dy = torch.randn(R, d, generator=g).to("cuda", dtype)
    before = rn.rmsnorm_bwd.launches
    dx, ds = rn.rmsnorm_bwd(x, s, dy)
    assert rn.rmsnorm_bwd.launches == before + 1
    kernels = rmsnorm_kernel_counts[_case("bwd", R, d, dtype, dtype)]
    assert list(kernels.values()) == [1], kernels
    assert "rmsnorm_bwd" in next(iter(kernels)), kernels
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, s, dy)
    tol = ref.rmsnorm_bwd_tolerance(x, s, dy)
    torch.testing.assert_close(dx.float(), want_dx.float(), **tol["dx"])
    torch.testing.assert_close(ds.float(), want_ds.float(), **tol["dscale"])
    dx2, ds2 = rn.rmsnorm_bwd(x, s, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    lx, ls = x.clone().requires_grad_(), s.clone().requires_grad_()
    ops.rmsnorm(lx, ls).backward(dy)
    assert torch.equal(lx.grad, dx) and torch.equal(ls.grad, ds)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [853, 1706, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_gemm_backward_products_match_plain(C, dtype):
    """``ops.moe_gemm``'s gradients on the card (dx = moe_gemm(dy, w^T),
    dw = moe_gemm(x^T, dy), C padded to a multiple of 8) against autograd
    of the plain version, at Granite's expert widths; bf16 dw takes the
    ``tma_wgmma`` kernel whatever C is."""
    _need_gpu()
    E, d, f = 8, 1536, 512
    g = torch.Generator().manual_seed(C)
    x = (torch.randn(E, C, d, generator=g) * 0.1).to("cuda", dtype)
    w = (torch.randn(E, d, f, generator=g) * 0.1).to("cuda", dtype)
    dy = (torch.randn(E, C, f, generator=g) * 0.1).to("cuda", dtype)
    lx, lw = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = moe_gemm_mod.moe_gemm.launches
    ops.moe_gemm(lx, lw).backward(dy)
    assert moe_gemm_mod.moe_gemm.launches == before + 3
    px, pw = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref.moe_gemm_ref(px, pw).backward(dy)
    wt = w.transpose(1, 2).contiguous()
    torch.testing.assert_close(lx.grad, px.grad,
                               **ref.moe_gemm_tolerance(dy, wt))
    xt = ops._pad_rows(x.transpose(1, 2).contiguous(), 8, 2)
    dyp = ops._pad_rows(dy, 8, 1)
    torch.testing.assert_close(lw.grad, pw.grad,
                               **ref.moe_gemm_tolerance(xt, dyp))
    if dtype == torch.bfloat16:
        assert moe_gemm_mod.variant(xt, dyp) == "tma_wgmma"
        assert moe_gemm_mod.variant(dy, wt) == "tma_wgmma"


@pytest.mark.gpu
def test_kernel_wrappers_without_a_backward_raise_under_grad():
    _need_gpu()
    q = torch.randn(1, 300, 4, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 300, 4, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        ops.flash_attention(q, k, k)
    starts = torch.zeros(2, 64, device="cuda", requires_grad=True)
    z = torch.zeros(2, 64, device="cuda")
    n = torch.zeros(2, dtype=torch.int32, device="cuda")
    ps = torch.ones(2, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fleet_feasibility(starts, z, z, n, ps, 5.0, torch.zeros(2))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.link_cost(starts, z, z, n, ps, 5.0, torch.zeros(2), None, 0.0,
                      torch.zeros(2), torch.zeros(2), 0.0)


@pytest.mark.gpu
def test_granite_train_step_on_gpu_matches_cpu():
    """The smoke Granite's train step (chunked attention in 3 query chunks,
    remat) on the card, through the rmsnorm and moe_gemm kernels and their
    backwards, against the same step on the CPU in f32 (TF32 off)."""
    _need_gpu()
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import train_golden as tg
    g = np.load(Path(__file__).resolve().parent / "data"
                / "torch_train_golden.npz")
    name = "smoke/granite-moe-smoke"
    cfg = tg.port_configs()[name]
    counts = (rmsnorm_mod.rmsnorm_bwd.launches, moe_gemm_mod.moe_gemm.launches)
    rec, losses = tg.port_record(name, cfg, g, device="cuda")
    assert rmsnorm_mod.rmsnorm_bwd.launches > counts[0]
    assert moe_gemm_mod.moe_gemm.launches > counts[1]
    assert not tg.fails(tg.compare(rec, g, name, "float32"))
    np.testing.assert_allclose(losses, g[name + "/losses"], rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["smoke/dit-smoke", "smoke/unet-smoke"])
def test_diffusion_train_step_on_gpu_matches_golden(name):
    """The smoke DiT's and UNet's three train steps on the card in f32
    (their noise drawn there) within the golden's limits."""
    _need_gpu()
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import train_golden as tg
    g = np.load(Path(__file__).resolve().parent / "data"
                / "torch_train_golden.npz")
    cfg = tg.port_configs()[name]
    rec, losses = tg.port_record(name, cfg, g, device="cuda")
    assert not tg.fails(tg.compare(rec, g, name, "float32"))
    np.testing.assert_allclose(losses, g[name + "/losses"], rtol=2e-5)


@pytest.mark.gpu
def test_noise_and_embedding_backward_on_gpu_equal_cpu():
    """The diffusion losses' threefry draws and the embedding's row-order
    bf16 backward give the CPU's bits on the card."""
    _need_gpu()
    x = torch.zeros(16, 8, 8, 4)
    t, eps = diffusion.diffusion_noise(3, x)
    tg_, eg = diffusion.diffusion_noise(3, x.cuda())
    assert torch.equal(tg_.cpu(), t) and torch.equal(eg.cpu(), eps)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 8, 3000))
    dy = torch.randn(3000, 96).bfloat16()
    want = common.row_order_sum(ids, dy, 50)
    assert torch.equal(common.row_order_sum(ids.cuda(), dy.cuda(), 50).cpu(),
                       want)


# ---------------------------------------------------------------------------
# ResNet on the card, and the serve step captured as CUDA graphs
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_resnet_on_gpu_matches_cpu_in_f32():
    """The narrow 4-stage ResNet in f32 on the card against the CPU within
    1e-4, with cuDNN's TF32 switched on by the caller: the f32 forward
    turns it off for its convolutions (TF32 would be ~1e-3 off) and
    restores it."""
    _need_gpu()
    cfg = dataclasses.replace(resnet50.CONFIG, width=8, depths=(1, 1, 1, 1),
                              n_classes=10, param_dtype="float32")
    tree = resnet.numpy_params(cfg, 0)
    img = torch.from_numpy(np.random.default_rng(0).random(
        (2, 100, 100, 3), dtype=np.float32))
    cpu = resnet.forward(resnet.params_from_numpy(tree, cfg, "cpu"), img, cfg)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        gpu = resnet.forward(resnet.params_from_numpy(tree, cfg, "cuda"),
                             img.cuda(), cfg)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def vision_models():
    """DeiT-B (the kernel path at 384 px) and ResNet-50 at full width, bf16,
    seeded weights, on the card."""
    _need_gpu()
    out = {}
    for name, cfg, mod in (
            ("deit-b", dataclasses.replace(deit_b.CONFIG, attn_impl="pallas"),
             vit),
            ("resnet-50", resnet50.CONFIG, resnet)):
        out[name] = (mod, mod.params_from_numpy(mod.numpy_params(cfg, 0),
                                                cfg, "cuda"), cfg)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("name,res", [("deit-b", 224), ("deit-b", 384),
                                      ("resnet-50", 224)])
def test_graphed_step_equals_eager_step(vision_models, name, res, b):
    """Bit for bit at the served classes' shapes; a second replay with new
    frames gives those frames' logits (no stale buffer)."""
    mod, params, cfg = vision_models[name]
    step = GraphedStep.for_model(mod, params, cfg)
    g = torch.Generator().manual_seed(res + b)
    x1, x2 = (torch.rand(b, res, res, 3, generator=g).cuda()
              for _ in range(2))
    got1 = step(x1).clone()
    assert torch.equal(got1, mod.serve_step(params, x1, cfg))
    got2 = step(x2)
    assert torch.equal(got2, mod.serve_step(params, x2, cfg))
    assert not torch.equal(got2, got1)
    assert len(step.graphs) == 1
    assert next(iter(step.graphs.values())).replays == 2


@pytest.mark.gpu
def test_graphed_deit_b_counts_its_captured_flash_launches(vision_models):
    """A 384-px graph holds one flash_attention launch per layer; replays
    run no wrapper, so the launches are counted as captured x replays."""
    mod, params, cfg = vision_models["deit-b"]
    step = GraphedStep.for_model(mod, params, cfg)
    x = torch.rand(2, 384, 384, 3).cuda()
    step(x)
    assert [g.flash_launches for g in step.graphs.values()] \
        == [cfg.n_layers]
    wrapper = fa.flash_attention.launches
    step(x)
    step(x)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == wrapper
    assert step.launches() == 3 * cfg.n_layers
    step(x[:, :224, :224].contiguous())          # 198 tokens: naive path
    assert sorted(g.flash_launches
                  for g in step.graphs.values()) == [0, cfg.n_layers]
    step.reset_counts()
    assert step.launches() == 0


@pytest.fixture(scope="module")
def vit_h14_model():
    """ViT-H/14 at full width (32 layers, 632 M parameters), bf16, seeded
    weights, attention through the kernel past 512 tokens, on the card."""
    _need_gpu()
    cfg = dataclasses.replace(vit_h14.CONFIG, attn_impl="pallas")
    return vit.params_from_numpy(vit.numpy_params(cfg, 0), cfg, "cuda"), cfg


@pytest.mark.gpu
def test_graphed_vit_h14_runs_the_d80_kernel_in_each_layer(vit_h14_model):
    """A 384-px graph (730 tokens, heads 80 wide) holds one flash_attention
    launch per layer, 32, and a profiled replay shows 32 tma_wgmma kernels
    of width 80 on the device, the instantiation without the key band (no
    mask); its logits equal the eager step's bit for
    bit; a 224-px graph (257 tokens, the naive path) holds none."""
    params, cfg = vit_h14_model
    step = GraphedStep.for_model(vit, params, cfg)
    x = torch.rand(2, 384, 384, 3,
                   generator=torch.Generator().manual_seed(0)).cuda()
    got = step(x).clone()
    assert [g.flash_launches for g in step.graphs.values()] \
        == [cfg.n_layers]
    assert torch.equal(got, vit.serve_step(params, x, cfg))
    _, kernels, tries = _device_kernels(lambda: step(x))
    flash = {k: n for k, n in kernels.items() if "flash_attention" in k}
    assert list(flash.values()) == [cfg.n_layers], kernels
    name = next(iter(flash))
    assert "wgmma" in name and "128, 80, false>" in name, name
    assert step.launches() == (1 + tries) * cfg.n_layers
    step(x[:, :224, :224].contiguous())
    assert sorted(g.flash_launches
                  for g in step.graphs.values()) == [0, cfg.n_layers]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deit-b", "resnet-50"])
def test_serve_launcher_on_gpu_replays_graphs(arch, capsys):
    """The launcher on the card (graphed by default) prints what it prints
    on the CPU: the engine's decisions do not depend on the device."""
    _need_gpu()
    serve.main(["--arch", arch, "--requests", "24", "--device", "cpu"])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    serve.main(["--arch", arch, "--requests", "24"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == want
    cfg = get_smoke_config(arch)
    mod = serve.model_module(cfg)
    params = mod.params_from_numpy(mod.numpy_params(cfg, 0), cfg, "cuda")
    run_batch = serve.make_run_batch(params, cfg)
    assert isinstance(run_batch.step, GraphedStep)
    img = torch.rand(cfg.img_res, cfg.img_res, 3).cuda()
    eager = serve.make_run_batch(params, cfg, graphed=False)
    assert run_batch("hd", [img] * 3) == eager("hd", [img] * 3)


@pytest.mark.gpu
def test_failed_capture_raises():
    """A step that reads a value back to the host cannot be captured: the
    error propagates (no eager fallback), no graph is kept, and the card
    goes on working."""
    _need_gpu()

    def host_read(images):
        y = images * 2
        if float(y.sum()) < 0:
            y = -y
        return y

    step = GraphedStep(host_read)
    with pytest.raises(RuntimeError):
        step(torch.ones(2, 4, device="cuda"))
    assert not step.graphs
    assert float(torch.ones(3, device="cuda").sum()) == 3.0


# ---------------------------------------------------------------------------
# the diffusion serve step: DiT-XL/2's 72-wide heads on the flash kernel,
# the UNet
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("B,causal", [(1, False), (4, False), (1, True)])
def test_flash_attention_wgmma_kernel_at_4096_keys(B, causal):
    """DiT-XL/2 at 1024 px: 4,096 tokens, heads 72 wide, 64 key tiles a
    query tile (the edge tests above stop at 1,024 keys)."""
    _need_gpu()
    g = torch.Generator().manual_seed(B + 7 * causal)
    q, k, v = (torch.randn(B, 4096, 16, 72, generator=g).to("cuda",
                                                            torch.bfloat16)
               for _ in range(3))
    assert fa.variant(q, k, v) == "tma_wgmma"
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.flash_attention_tolerance(want, v))


@pytest.mark.gpu
@pytest.mark.parametrize("px", [512, 1024])
def test_dit_runs_the_d72_kernel_in_each_layer(px):
    """DiT-XL/2's width (d 1152, 16 heads 72 wide) at 2 layers, bf16,
    every weight leaf random: at 512 px (1,024 tokens) and 1024 px (4,096)
    a profiled step shows one tma_wgmma kernel of width 72 a layer (the
    instantiation without the key band), and
    the step equals the plain path (``chunked``) within 1% rms of its
    output."""
    _need_gpu()
    cfg = dataclasses.replace(dit_xl2.CONFIG, n_layers=2, attn_impl="pallas")
    params = dit.params_from_numpy(dit.numpy_params(cfg, 0, 0.02), cfg,
                                   "cuda")
    g = torch.Generator().manual_seed(px)
    lat = torch.randn(2, px // 8, px // 8, 4, generator=g).cuda()
    t = torch.tensor([10, 900]).cuda()
    y = torch.tensor([3, cfg.n_classes]).cuda()
    before = fa.flash_attention.launches
    got, kernels, tries = _device_kernels(
        lambda: dit.serve_step(params, lat, t, y, cfg))
    flash = {k: n for k, n in kernels.items() if "flash_attention" in k}
    assert list(flash.values()) == [cfg.n_layers], kernels
    name = next(iter(flash))
    assert "wgmma" in name and "128, 72, false>" in name, name
    assert fa.flash_attention.launches == before + tries * cfg.n_layers
    want = dit.serve_step(params, lat, t, y, dataclasses.replace(
        cfg, attn_impl="chunked")).float()
    got = got.float()
    assert torch.isfinite(got).all()
    assert float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt()) < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 5e-2)])
def test_unet_on_gpu_matches_cpu(dtype, atol):
    """The smoke UNet, every weight leaf random, on the card against the
    CPU: f32 within 1e-4 (cuDNN's TF32 off for its convolutions), bf16
    within 5e-2 (cuBLAS and cuDNN round elsewhere than the CPU)."""
    _need_gpu()
    cfg = dataclasses.replace(get_smoke_config("unet-sd15"),
                              param_dtype=dtype)
    tree = unet.numpy_params(cfg, 0, 0.02)
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.standard_normal((2, 8, 8, 4),
                                               dtype=np.float32))
    t = torch.tensor([5, 900])
    ctx = torch.from_numpy(rng.standard_normal((2, cfg.ctx_len, cfg.ctx_dim),
                                               dtype=np.float32))
    cpu = unet.serve_step(unet.params_from_numpy(tree, cfg, "cpu"), lat, t,
                          ctx, cfg)
    gpu = unet.serve_step(unet.params_from_numpy(tree, cfg), lat.cuda(),
                          t.cuda(), ctx.cuda(), cfg)
    assert gpu.device.type == "cuda" and gpu.dtype == cpu.dtype
    torch.testing.assert_close(gpu.float().cpu(), cpu.float(), rtol=0,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("mod,arch", [(dit, "dit-xl2"), (unet, "unet-sd15")])
def test_diffusion_params_default_to_cuda(monkeypatch, mod, arch):
    """``params_from_numpy(..., device=None)`` puts every leaf on CUDA in
    its def's dtype, and raises once CUDA is gone."""
    _need_gpu()
    cfg = get_smoke_config(arch)
    tree = mod.numpy_params(cfg, 0)
    params = mod.params_from_numpy(tree, cfg)
    for path, d in mod.param_defs(cfg).items():
        leaf = common.nested(params, path)
        assert leaf.device.type == "cuda" and str(leaf.dtype) == \
            f"torch.{d.dtype}", path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.params_from_numpy(tree, cfg)


# ---------------------------------------------------------------------------
# the language models: prefill and decode through the flash, rmsnorm and
# moe_gemm kernels
# ---------------------------------------------------------------------------
LM_ARCHS = ("granite-moe-3b-a800m", "starcoder2-7b", "gemma3-27b",
            "kimi-k2-1t-a32b")


def _lm_counts():
    return (fa.flash_attention.launches, rmsnorm_mod.rmsnorm.launches,
            moe_gemm_mod.moe_gemm.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_on_gpu_matches_cpu(arch):
    """Each SMOKE LM in f32 (TF32 off), every weight leaf random, on the
    card (rmsnorm and moe_gemm through their kernels) against the CPU (the
    plain versions): the prefill's last logits and cache and three decode
    steps within 1e-5; gemma3-smoke's ring-buffer decode past its window."""
    _need_gpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    tree = transformer.numpy_params(cfg, 0, 0.02)
    cpu_p = transformer.params_from_numpy(tree, cfg, "cpu")
    gpu_p = transformer.params_from_numpy(tree, cfg)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    close = lambda g, c: torch.testing.assert_close(g.float().cpu(),
                                                    c.float(), rtol=0,
                                                    atol=1e-5)
    before = _lm_counts()
    lc, cc = transformer.prefill(cpu_p, tok, cfg, max_len=16)
    lg, cg = transformer.prefill(gpu_p, tok.cuda(), cfg, max_len=16)
    close(lg, lc)
    close(cg["k"], cc["k"])
    close(cg["v"], cc["v"])
    L = cfg.n_layers
    assert _lm_counts()[1] - before[1] == 2 * L + 1
    assert _lm_counts()[2] - before[2] == (3 * L if cfg.moe else 0)
    for s in ([1, 2], [3, 4], [5, 6]):
        lc, cc = transformer.decode_step(cpu_p, cc, torch.tensor(s), cfg)
        lg, cg = transformer.decode_step(gpu_p, cg, torch.tensor(s).cuda(),
                                         cfg)
        close(lg, lc)
    if cfg.sliding_window and cfg.global_every:
        cc = transformer.init_sliding_cache(cfg, 2, 16, "cpu")
        cg = transformer.init_sliding_cache(cfg, 2, 16)
        for i in range(12):
            s = torch.tensor([i, 2 * i + 1])
            lc, cc = transformer.decode_step_sliding(cpu_p, cc, s, cfg)
            lg, cg = transformer.decode_step_sliding(gpu_p, cg, s.cuda(), cfg)
            close(lg, lc)


@pytest.mark.gpu
def test_granite_layers_run_the_three_kernels():
    """Granite-3.0 MoE at full width, 2 layers, bf16, attn_impl "pallas":
    a 1,100-token prefill launches flash once a layer, rmsnorm 2L + 1 and
    moe_gemm 3L times; a decode step no flash and the same norms and
    products; the prefill's last logits within 0.05 (rms, relative) of the
    plain path's (chunked attention, the plain rmsnorm and moe_gemm),
    routed as the kernel path was (a routing flip at a near-tie drops the
    last token's copy from a full expert: ``chip_smoke.pinned_routing``)."""
    _need_gpu()
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              n_layers=2, attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init_params(cfg, gen)
    assert params["layers"]["we_gate"].device.type == "cuda"
    tok = torch.randint(0, cfg.vocab_size, (1, 1100), generator=gen,
                        device="cuda")
    routing, real_route = [], moe.route_topk

    def recording(logits, top_k, n_real=None):
        gates, experts = real_route(logits, top_k, n_real)
        routing.append(experts)
        return gates, experts

    def pinned(logits, top_k, n_real=None):
        e = routing.pop(0)
        gates = torch.softmax(logits.float(), -1).gather(1, e.long())
        return gates / gates.sum(-1, keepdim=True), e

    before = _lm_counts()
    moe.route_topk = recording
    try:
        last, cache = transformer.prefill(params, tok, cfg, max_len=1102)
    finally:
        moe.route_topk = real_route
    assert tuple(np.subtract(_lm_counts(), before)) == (2, 5, 6)
    before = _lm_counts()
    logits, cache = transformer.decode_step(params, cache,
                                            last.argmax(-1), cfg)
    assert tuple(np.subtract(_lm_counts(), before)) == (0, 5, 6)
    assert torch.isfinite(logits).all() and logits.dtype == torch.float32
    real_norm, real_gemm = ops.rmsnorm, ops.moe_gemm
    ops.rmsnorm, ops.moe_gemm = ref.rmsnorm_ref, ref.moe_gemm_ref
    moe.route_topk = pinned
    try:
        want, _ = transformer.prefill(params, tok, dataclasses.replace(
            cfg, attn_impl="chunked"))
    finally:
        ops.rmsnorm, ops.moe_gemm = real_norm, real_gemm
        moe.route_topk = real_route
    assert not routing
    assert float((last - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt()) < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 4, 6826])
@pytest.mark.parametrize("which", ["gate", "down"])
def test_moe_gemm_at_granite_capacities(C, which):
    """The grouped product at Granite's 48 experts and the capacities its
    serve path gives (decode at B = 1 and 16: C = 1 and 4, where the
    tensor map's 128-row box passes the tensor's extent; the 32k prefill:
    6,826) on tma_wgmma, against the plain version."""
    _need_gpu()
    d, f = (1536, 512) if which == "gate" else (512, 1536)
    g = torch.Generator(device="cuda").manual_seed(C)
    x = (torch.randn(48, C, d, generator=g, device="cuda") * 0.1).bfloat16()
    w = (torch.randn(48, d, f, generator=g, device="cuda") * 0.1).bfloat16()
    assert moe_gemm_mod.variant(x, w) == "tma_wgmma"
    got = moe_gemm_mod.moe_gemm(x, w)
    want = ref.moe_gemm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.moe_gemm_tolerance(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_no_window_equals_no_window_at_all(dtype):
    """The window a language model without a sliding window passes every
    layer (``transformer.NO_WINDOW``, 1 << 30) on causal GQA as Granite's
    prefill gives it: the output without a window, bit for bit, and the
    plain version's within its tolerance."""
    _need_gpu()
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 1100, h, 64, generator=g).to("cuda", dtype)
               for h in (24, 8, 8))
    got = fa.flash_attention(q, k, v, causal=True,
                             window=transformer.NO_WINDOW)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=True))
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               **ref.flash_attention_tolerance(want, v))


# ---------------------------------------------------------------------------
# distribution (chip_smoke.py phase 4i): the sharded MoE on a 1 x 1 mesh of
# an NCCL group of one rank
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl_mesh():
    """An NCCL group of one rank from an in-memory store and its 1 x 1
    (data, model) mesh on the card; destroyed after the test."""
    _need_gpu()
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_host_mesh()
    finally:
        shd.clear_rules()
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -6)])
def test_sharded_moe_on_an_nccl_mesh_matches_local_dispatch(nccl_mesh, dtype,
                                                            atol):
    """``moe_ffn_sharded`` on the card (Granite's 48 experts, 40 real,
    top-8, expert-sharded over 'model', FSDP gathers over 'data') equals
    ``_local_dispatch_ffn`` on the CPU (the plain ``moe_gemm``) on the
    same inputs: three ``moe_gemm`` launches, no copy to a padded expert;
    bf16 within 2^-6 (the products round to bf16 on both sides)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    T, d, E, f = 512, 256, 48, 128
    n = lambda *s, sc=0.1: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32))
    x, rw = n(T, d, sc=1.0).to(dtype), n(d, E)
    w = [n(E, d, f).to(dtype), n(E, d, f).to(dtype), n(E, f, d).to(dtype)]
    kw = dict(top_k=8, capacity_factor=1.25)
    want, aux_want = moe._local_dispatch_ffn(x, rw, *w, n_experts=E,
                                             expert_offset=0, n_real=40, **kw)
    before = moe_gemm_mod.moe_gemm.launches
    got, aux = moe.moe_ffn_sharded(
        x.cuda(), rw.cuda(), *(a.cuda() for a in w), mesh=nccl_mesh,
        dp_axes=("data",), model_axis="model", fsdp_axes="data",
        expert_sharded=True, n_real=40, **kw)
    assert moe_gemm_mod.moe_gemm.launches - before == 3
    assert got.dtype == dtype and got.device.type == "cuda"
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=0,
                               atol=atol * float(want.float().abs().max()))
    torch.testing.assert_close(aux.cpu(), aux_want, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_granite_mesh_branch_on_gpu_matches_cpu(nccl_mesh):
    """Granite's SMOKE config made a mesh config (``moe_impl="shard_map"``,
    5 experts padded to 8) in f32 under the 1 x 1 mesh with
    ``install_rules``: its prefill on the card against the CPU's, where the
    MoE layer is ``_local_dispatch_ffn`` called directly (what the sharded
    path computes on one rank), within 1e-5; one ``moe_ffn_sharded`` call a
    layer."""
    from repro_torch.launch.mesh import install_rules
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              param_dtype="float32", moe_impl="shard_map",
                              n_experts_pad=8, capacity_factor=1.25)
    tree = transformer.numpy_params(cfg, 0, 0.02)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))

    def direct(x, rw, wg, wu, wd, *, top_k, capacity_factor, n_real=None,
               **mesh_args):
        return moe._local_dispatch_ffn(
            x, rw, wg, wu, wd, top_k=top_k, capacity_factor=capacity_factor,
            n_experts=rw.shape[-1], expert_offset=0, n_real=n_real)

    install_rules(nccl_mesh, cfg, 2, kind="prefill")
    real, calls = moe.moe_ffn_sharded, []
    moe.moe_ffn_sharded = direct
    try:
        want, _ = transformer.prefill(
            transformer.params_from_numpy(tree, cfg, "cpu"), tok, cfg)
    finally:
        moe.moe_ffn_sharded = real

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    moe.moe_ffn_sharded = counted
    try:
        got, _ = transformer.prefill(transformer.params_from_numpy(tree, cfg),
                                     tok.cuda(), cfg)
    finally:
        moe.moe_ffn_sharded = real
    assert len(calls) == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("E,C,d,f", [(48, 8192, 1536, 512),
                                     (48, 8192, 512, 1536)])
def test_moe_gemm_at_the_meshed_prefill_capacity(E, C, d, f):
    """The meshed 32k prefill's gate and down products (capacity 8,192
    from Granite's 40 real experts over its 48): the ``tma_wgmma`` variant,
    within the tolerance of the plain version."""
    _need_gpu()
    from repro_torch.kernels import moe_gemm as mg
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(C + d)
    x = torch.randn(E, C, d, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(E, d, f, generator=g, device="cuda").to(torch.bfloat16)
    assert mg.variant(x, w) == "tma_wgmma"
    torch.testing.assert_close(ops.moe_gemm(x, w).float(),
                               ref.moe_gemm_ref(x, w).float(),
                               **ref.moe_gemm_tolerance(x, w))



# ---------------------------------------------------------------------------
# the model-path kernels as torch.library operators (kernels/library.py)
# ---------------------------------------------------------------------------
def _op_launches():
    return (fa.flash_attention.launches, rmsnorm_mod.rmsnorm.launches,
            rmsnorm_mod.rmsnorm_bwd.launches,
            moe_gemm_mod.moe_gemm.launches)


@pytest.mark.gpu
def test_library_operators_launch_on_real_tensors():
    """On real CUDA tensors each operator launches its kernel (one launch
    a call, counted by its wrapper) and equals the plain version."""
    _need_gpu()
    from repro_torch.kernels import library
    g = torch.Generator(device="cuda").manual_seed(29)
    q = torch.randn(2, 600, 8, 64, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    k = torch.randn(2, 600, 2, 64, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    x = torch.randn(6, 100, 48, device="cuda", generator=g)
    w = torch.randn(6, 48, 24, device="cuda", generator=g)
    r = torch.randn(300, 48, device="cuda", generator=g)
    s = torch.randn(48, device="cuda", generator=g) * 0.1
    before = _op_launches()
    o = library.ops.flash_attention(q, k, k, True, 0)
    y = library.ops.moe_gemm(x, w)
    n = library.ops.rmsnorm(r, s)
    dx, ds = library.ops.rmsnorm_bwd(r, s, n)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_op_launches(), before)) == \
        (1, 1, 1, 1)
    want = ref.flash_attention_ref(q, k, k, causal=True)
    assert torch.allclose(o.float(), want.float(),
                          **ref.flash_attention_tolerance(want, k))
    assert torch.allclose(y, ref.moe_gemm_ref(x, w), atol=1e-3, rtol=1e-3)
    assert torch.allclose(n, ref.rmsnorm_ref(r, s, eps=rmsnorm_mod.EPS),
                          atol=1e-5, rtol=1e-5)
    pdx, pds = ref.rmsnorm_bwd_ref(r, s, n, eps=rmsnorm_mod.EPS)
    assert torch.allclose(dx, pdx, atol=1e-4, rtol=1e-4)
    assert torch.allclose(ds, pds, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_library_operators_on_fake_cuda_tensors_count_without_launch():
    """On fake CUDA tensors the operators give shapes and their FLOP
    formulas' counts, and launch nothing; the cost model counts a smoke
    Granite prefill past 1,024 tokens through flash and moe_gemm."""
    _need_gpu()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import library
    from repro_torch.launch import dryrun, steps
    before = _op_launches()
    with FakeTensorMode():
        q = torch.empty(2, 1100, 8, 64, dtype=torch.bfloat16, device="cuda")
        x = torch.empty(6, 100, 48, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(6, 48, 24, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fc:
            o = ops.flash_attention(q, q, q, causal=True)
            y = ops.moe_gemm(x, w)
    assert o.shape == q.shape and y.shape == (6, 100, 24)
    assert fc.get_total_flops() == \
        4 * 2 * 8 * 64 * library.flash_pairs(1100, True, None) \
        + 2 * 6 * 100 * 48 * 24
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              attn_impl="pallas", attn_chunk=1024)
    shape = ShapeSpec("smoke_pallas", "prefill", seq_len=1100,
                      global_batch=1)
    cell = steps.build_cell("granite-moe-3b-a800m", shape.name, cfg=cfg,
                            shape=shape)
    costs, mode, out = dryrun.count_step(cell, "cuda")
    assert _op_launches() == before
    flash = sum(p[3] for p in mode.products if p[0] == "flash_attention")
    assert flash == cfg.n_layers * 4 * cfg.n_heads * cfg.hd * \
        library.flash_pairs(1100, True, None)
    assert any(p[0] == "moe_gemm" for p in mode.products)
    plain, _, _ = dryrun.count_step(cell, "cpu")
    assert plain.flops > costs.flops        # the plain attention's full square
