"""The port on an NVIDIA GPU: the hand-written event_select kernel against
its plain PyTorch version, and the simulator on the card against the
same simulator on the CPU.  Imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test skips where ``torch.cuda.is_available()`` is false.
"""
import numpy as np
import pytest
import torch

from repro_torch.fleetsim import simulate, topology_arrays
from repro_torch.kernels import ops, ref
from repro_torch.kernels import event_select as es
from repro_torch.netsim import LinkModel
from repro_torch.orchestration import Topology, UniformWorkload

BIG = 1e30
NAMES = ("take_fresh", "t", "node", "feasible", "arrive", "j", "cap", "load")


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


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


@pytest.mark.gpu
def test_simulate_on_gpu_matches_cpu():
    _need_gpu()
    counts = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
    reqs, _ = UniformWorkload(counts, window=1200.0, name="hot").to_arrays(0)
    topo = Topology.full_mesh(3)
    kw = dict(policy="batched_feasible", capacity=512, depth=256,
              net=LinkModel.campus(topo).net_params())
    cpu = simulate(reqs, topology_arrays(topo), device="cpu", **kw)
    es.event_select.launches = 0
    gpu = simulate(reqs, topology_arrays(topo), device="cuda", **kw)
    torch.cuda.synchronize()
    assert es.event_select.launches == gpu.events == cpu.events
    for f in ("outcome", "served_by", "forwards_used", "completion",
              "transfer_used"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
