"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports JAX or the JAX package, and its entry points raise, rather than
fall back to the CPU, when CUDA is asked for and absent."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.core import torch_queue as tq
from repro_torch.device import resolve_device
from repro_torch.fleetsim import simulate, to_device, topology_arrays
from repro_torch.launch import serve
from repro_torch.models import dit, transformer, unet, vit
from repro_torch.orchestration import Router, Topology, UniformWorkload
from repro_torch.serving import DeadlineAwareEngine, ServingReplica

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
{extra}
bad = sorted(n for n, mod in sys.modules.items() if mod is not None and (
    n in ("jax", "repro") or n.startswith(("jax.", "repro."))))
print(len(names), bad)
"""


def _run_probe(extra=""):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE.format(extra=extra)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split(None, 1)


def test_no_port_module_imports_jax_or_repro():
    n, bad = _run_probe()
    assert int(n) >= 15 and bad.strip() == "[]"


def test_probe_walks_the_fleet_kernel_modules():
    """The walk above imports the fleet kernels' wrappers too (each builds
    nothing at import)."""
    _, bad = _run_probe("assert {'repro_torch.kernels.event_scan', "
                        "'repro_torch.kernels.event_select'} <= set(names)")
    assert bad.strip() == "[]"


def test_probe_walks_the_workload_and_radio_modules():
    """The arrival processes and the radio model are the port's own copies
    (the reference's are numpy-only, and still not imported)."""
    _, bad = _run_probe(
        "assert {'repro_torch.netsim.radio', "
        "'repro_torch.orchestration.workload'} <= set(names)\n"
        "from repro_torch.netsim import RadioWorkload\n"
        "from repro_torch.orchestration import TraceWorkload, dump_trace\n"
        "assert RadioWorkload.__module__ == 'repro_torch.netsim.radio'\n"
        "assert TraceWorkload.__module__ == "
        "'repro_torch.orchestration.workload'")
    assert bad.strip() == "[]"


def test_probe_walks_the_resnet_and_graph_modules():
    """ResNet-50's config and model and the graphed serve step are the
    port's own (the reference's ``ResNetConfig`` is not imported)."""
    _, bad = _run_probe(
        "assert {'repro_torch.models.resnet', 'repro_torch.launch.graphs', "
        "'repro_torch.configs.resnet50'} <= set(names)\n"
        "from repro_torch.configs import ResNetConfig, get_config\n"
        "assert ResNetConfig.__module__ == 'repro_torch.configs.base'\n"
        "assert type(get_config('resnet-50')) is ResNetConfig")
    assert bad.strip() == "[]"


def test_probe_walks_the_diffusion_modules():
    """DiT, the UNet, their configs and the shape tables are the port's
    own (the reference's ``DiTConfig`` / ``UNetConfig`` are not
    imported)."""
    _, bad = _run_probe(
        "assert {'repro_torch.models.dit', 'repro_torch.models.unet', "
        "'repro_torch.configs.shapes', 'repro_torch.configs.dit_xl2', "
        "'repro_torch.configs.unet_sd15'} <= set(names)\n"
        "from repro_torch.configs import DiTConfig, UNetConfig, get_config\n"
        "assert type(get_config('dit-xl2')) is DiTConfig\n"
        "assert type(get_config('unet-sd15')) is UNetConfig\n"
        "assert DiTConfig.__module__ == 'repro_torch.configs.base'")
    assert bad.strip() == "[]"


def test_probe_walks_the_language_model_modules():
    """The transformer, the MoE layer, the KV-cache pool and the four LM
    configs are the port's own (the reference's ``LMConfig`` is not
    imported)."""
    _, bad = _run_probe(
        "assert {'repro_torch.models.transformer', 'repro_torch.models.moe', "
        "'repro_torch.serving.kv_cache', "
        "'repro_torch.configs.granite_moe_3b_a800m', "
        "'repro_torch.configs.starcoder2_7b', 'repro_torch.configs.gemma3_27b', "
        "'repro_torch.configs.kimi_k2_1t_a32b'} <= set(names)\n"
        "from repro_torch.configs import LMConfig, all_cells, get_config\n"
        "assert LMConfig.__module__ == 'repro_torch.configs.base'\n"
        "assert type(get_config('kimi-k2-1t-a32b')) is LMConfig\n"
        "assert len(all_cells()[0]) == 37\n"
        "from repro_torch.serving import KVCachePool\n"
        "assert KVCachePool.__module__ == 'repro_torch.serving.kv_cache'")
    assert bad.strip() == "[]"


def test_probe_walks_the_training_modules():
    """The optimizer, data pipeline, checkpoints, compression, train loop,
    cell builder and train launcher are the port's own, and a train step
    runs with ``jax`` unimportable (the checkpoints' bf16 leaves without
    ``ml_dtypes``)."""
    _, bad = _run_probe(
        "assert {'repro_torch.training.optimizer', "
        "'repro_torch.training.data', 'repro_torch.training.checkpoint', "
        "'repro_torch.training.compression', "
        "'repro_torch.training.train_loop', 'repro_torch.launch.steps', "
        "'repro_torch.launch.train'} <= set(names)\n"
        "import contextlib, io, tempfile\n"
        "from repro_torch.launch import train\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    train.main(['--arch', 'granite-moe-3b-a800m', '--steps', '1', "
        "'--batch', '1', '--seq', '8', '--device', 'cpu', '--ckpt-dir', "
        "tempfile.mkdtemp()])\n"
        "assert 'ml_dtypes' not in sys.modules")
    assert bad.strip() == "[]"


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    """``params_from_numpy`` and the caches' ``device=None`` mean CUDA and
    raise without it; the CPU, asked for, runs the model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("granite-moe-3b-a800m")
    tree = transformer.numpy_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg, torch.Generator())
    params = transformer.params_from_numpy(tree, cfg, "cpu")
    logits, cache = transformer.prefill(params, torch.tensor([[1, 2, 3]]),
                                        cfg, max_len=4)
    assert logits.device.type == "cpu" and cache["k"].device.type == "cpu"


def test_chip_smoke_imports_neither_jax_nor_repro():
    _, bad = _run_probe(f"sys.path.insert(0, {ROOT!r}); import chip_smoke")
    assert bad.strip() == "[]"


def _tiny():
    reqs, _ = UniformWorkload([{"S1": 2, "S3": 2}] * 2, window=50.0
                              ).to_arrays(0)
    return reqs, topology_arrays(Topology.full_mesh(2))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reqs, topo = _tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(reqs, topo)
    with pytest.raises(RuntimeError, match="cuda"):
        simulate(reqs, topo, device="cuda")
    with pytest.raises(RuntimeError):
        to_device(reqs, topo)
    with pytest.raises(RuntimeError):
        tq.empty_ledger(8)
    assert resolve_device("cpu") == torch.device("cpu")
    m = simulate(reqs, topo, policy="least_loaded", capacity=16,
                 device="cpu")
    assert m.outcome.device.type == "cpu" and int(m.processed) == 8


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("deit-b")
    tree = vit.numpy_params(cfg, 0)
    reps = [ServingReplica(i, lambda c, p: [0] * len(p)) for i in range(2)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeadlineAwareEngine(reps)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Router(Topology.full_mesh(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vit.params_from_numpy(tree, cfg)
    args = serve.parser().parse_args(["--requests", "3"])
    assert args.device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "3"])
    # asked for explicitly, the CPU runs the plain versions
    eng, reqs = serve.run(serve.parser().parse_args(
        ["--requests", "3", "--device", "cpu"]))
    assert len(reqs) == 3 and eng.router.device.type == "cpu"
    params = vit.params_from_numpy(tree, cfg, "cpu")
    assert params["head"]["w"].device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("mod,arch", [(dit, "dit-xl2"), (unet, "unet-sd15")])
def test_diffusion_params_raise_without_cuda(monkeypatch, mod, arch):
    """``params_from_numpy(..., device=None)`` means CUDA and raises
    without it; the CPU, asked for, takes the weights."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config(arch)
    tree = mod.numpy_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.params_from_numpy(tree, cfg, "cuda")
    params = mod.params_from_numpy(tree, cfg, "cpu")
    assert params["t_mlp"]["w1"].device.type == "cpu"


def test_to_device_keeps_the_reference_dtypes():
    reqs, topo = _tiny()
    r, t, _ = to_device(reqs, topo, device="cpu")
    assert [a.dtype for a in r] == [torch.float32] * 3 + [torch.int32] * 2 \
        + [torch.float32]
    assert [a.dtype for a in t] == [torch.bool, torch.int32, torch.int32,
                                    torch.float32]
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(reqs, r))
    assert repro_torch.resolve_device is resolve_device
