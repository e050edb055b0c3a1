"""Wrapper of the Hopper ``moe_gemm`` kernel (``csrc/moe_gemm.cu``).

The kernel replaces the TPU kernel ``repro/kernels/moe_gemm.py``
(``_moe_gemm_kernel`` / ``moe_gemm``); its plain version is
:func:`repro_torch.kernels.ref.moe_gemm_ref`.  At the Granite-3.0 MoE
shapes it sits near the ridge of an H100: ~69 us for each 64.4 GFLOP,
230.7 MB bf16 product (bytes at 3.35 TB/s; the products alone 65 us at
989 TFLOP/s); bf16 runs on the tensor cores through ``mma.sync``, f32 on
scalar FMAs (see the source's note).  This wrapper checks device, dtype,
shape and contiguity, allocates the output, launches on PyTorch's current
stream and raises on a refused launch.  It never synchronises and never
falls back: a CPU tensor is refused here (the dispatch in
:mod:`repro_torch.kernels.ops` sends those to the plain version).
``moe_gemm.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_EXPERTS = 65535                 # the grid's z dimension

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def _lib():
    fn = build.load("moe_gemm").moe_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA x (E, C, d) and w (E, d, f), one dtype of
    f32 / bf16, contiguous (any alignment); returns (E, C, f) in x's
    dtype."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"moe_gemm launches on CUDA tensors, got {dev}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be (E, C, d) and (E, d, f)")
    E, C, d = x.shape
    f = w.shape[2]
    if tuple(w.shape[:2]) != (E, d):
        raise ValueError(f"moe_gemm: w {tuple(w.shape)} must be (E, d, f) = "
                         f"({E}, {d}, f)")
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_gemm: {E} experts, the kernel takes at most "
                         f"{MAX_EXPERTS}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gemm: dtypes {x.dtype}/{w.dtype}; the kernel "
                        f"takes one of {DTYPES}")
    if w.device != dev:
        raise ValueError(f"moe_gemm: w is on {w.device}, x on {dev}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"moe_gemm: {name} is not contiguous")
    out = torch.empty((E, C, f), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    err = _lib()(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
                 int(x.dtype == torch.bfloat16), *build.stream_of(dev))
    if err != 0:
        raise RuntimeError(f"moe_gemm launch failed: CUDA error {err}")
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
