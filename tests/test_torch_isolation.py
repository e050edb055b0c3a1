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
from repro_torch.core import torch_queue as tq
from repro_torch.device import resolve_device
from repro_torch.fleetsim import simulate, to_device, topology_arrays
from repro_torch.orchestration import Topology, UniformWorkload

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


def test_to_device_keeps_the_reference_dtypes():
    reqs, topo = _tiny()
    r, t, _ = to_device(reqs, topo, device="cpu")
    assert [a.dtype for a in r] == [torch.float32] * 3 + [torch.int32] * 2 \
        + [torch.float32]
    assert [a.dtype for a in t] == [torch.bool, torch.int32, torch.int32,
                                    torch.float32]
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(reqs, r))
    assert repro_torch.resolve_device is resolve_device
