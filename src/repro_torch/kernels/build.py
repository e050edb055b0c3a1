"""Build the CUDA kernels of the port at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it
for Hopper (``sm_90a``) into a shared library, named by a hash of the
source, the ``csrc/*.cuh`` headers it includes and the flags, so an
edited source or header never loads a stale build.  The library goes
into ``$REPRO_TORCH_BUILD_DIR`` when that is set, else into
``build/kernels/`` at the root of a source checkout, else (an installed
package) into ``~/.cache/repro_torch/kernels``.  It is loaded with
``ctypes``; a failed build raises.  ``ptxas``'s resource report of each
build (registers, shared memory and spills per kernel instantiation) is
kept beside the library.  Nothing here runs at import time.

Also here: what every launch wrapper needs around the library, the
argument checks (:func:`check_tensors`) and the launch target
(:func:`stream_of`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> the checkout's root
_CHECKOUT = Path(__file__).resolve().parents[3]

# IEEE arithmetic only: no implicit FMA contraction (each fused
# multiply-add a kernel needs is written out, to match the plain version
# operation for operation) and never --use_fast_math (p / speed must be a
# correctly rounded division)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, else ``PATH``, else /usr/local/cuda."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def build_dir() -> Path:
    """Where built libraries go (see the module's docstring)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    if (_CHECKOUT / "pyproject.toml").is_file() and \
            (_CHECKOUT / "src" / "repro_torch").is_dir():
        return _CHECKOUT / "build" / "kernels"
    return Path.home() / ".cache" / "repro_torch" / "kernels"


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc`` that it includes,
    directly or through another header, in the order first met."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(
            path.read_bytes()) if (CSRC / inc.decode()).is_file()]
    return seen


def _library(name: str) -> Path:
    """The library's path: named by a hash of the source, the headers it
    includes and the flags, so an edited header never loads a stale
    build either."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an identical build exists; return
    the shared library's path."""
    src = CSRC / f"{name}.cu"
    out = _library(name)
    out_dir = out.parent
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        out.with_suffix(".ptxas").write_text("\n".join(
            line for line in proc.stderr.splitlines()
            if "ptxas info" in line and ("Compiling" in line
                                          or "registers" in line)
            or "spill" in line or "wgmma" in line
            or "setmaxnreg" in line) + "\n")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def ptxas_report(name: str) -> str:
    """``ptxas``'s report of the build of kernel ``name`` that
    :func:`build` made: per kernel instantiation, its registers, shared
    memory and spill stores and loads."""
    return _library(name).with_suffix(".ptxas").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib


def check_tensors(kernel: str, dev: torch.device, specs) -> None:
    """Raise unless each ``(name, tensor, dtype, shape)`` of ``specs`` is a
    contiguous tensor of that dtype and shape on ``dev``."""
    for name, x, dtype, shape in specs:
        if x.device != dev:
            raise ValueError(f"{kernel}: {name} is on {x.device}, "
                             f"expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


# hopper.cuh: a failed cuTensorMapEncodeTiled comes back as this plus its
# CUresult, apart from every cudaError_t
ENCODE_ERROR = 100000


def raise_on(kernel: str, err: int) -> None:
    """Raise unless a C launcher's return code ``err`` is 0 (a good
    launch); names a failed tensor-map encode as such."""
    if err == 0:
        return
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"{kernel}: tensor-map encode failed "
                           f"(CUresult {err - ENCODE_ERROR})")
    raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def stream_of(dev: torch.device) -> Tuple[int, int]:
    """The CUDA device index of ``dev`` and the raw handle of PyTorch's
    current stream there, as every kernel's C launcher takes them."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream
