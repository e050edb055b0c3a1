"""Build the CUDA kernels of the port at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it
for Hopper (``sm_90a``) into a shared library, named by a hash of the
source and the flags, so an edited source never loads a stale build.  The
library goes into ``$REPRO_TORCH_BUILD_DIR`` when that is set, else into
``build/kernels/`` at the root of a source checkout, else (an installed
package) into ``~/.cache/repro_torch/kernels``.  It is loaded with
``ctypes``; a failed build raises.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> the checkout's root
_CHECKOUT = Path(__file__).resolve().parents[3]

# IEEE arithmetic only: no implicit FMA contraction (each fused
# multiply-add a kernel needs is written out, to match the plain version
# operation for operation) and never --use_fast_math (p / speed must be a
# correctly rounded division)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

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


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an identical build exists; return
    the shared library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    out = out_dir / f"lib{name}-{digest}.so"
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
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
