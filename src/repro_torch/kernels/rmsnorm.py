"""Wrapper of the Hopper ``rmsnorm`` kernel (``csrc/rmsnorm.cu``).

The kernel replaces the TPU kernel ``repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` :16 / ``rmsnorm_fwd`` :23, ``pallas_call`` :32); its
plain version is :func:`repro_torch.kernels.ref.rmsnorm_ref`.  Bound by
bytes: x read once and the output written once, 26.3 us for (4096, 5376)
bf16 on an H100 (3.35 TB/s).  The kernel reads the scale in its own
dtype, f32 or bf16, once a thread over a persistent grid, and keeps the
next row's loads in flight while a row reduces (see the source's note),
so a call is one launch.  This wrapper checks device, dtype, shape and
contiguity, passes an f32 or bf16 ``scale`` as it is and casts any other
float dtype to f32 (the reference's own ``astype(f32)``;
:func:`kernel_scale`), allocates the output, launches on PyTorch's
current stream and raises on a refused launch.  It never synchronises
and never falls back: a CPU tensor is refused here (the dispatch in
:mod:`repro_torch.kernels.ops` sends those to the plain version).
``rmsnorm.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

EPS = 1e-6
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, scale, out, R, d, eps, x is bf16, scale is bf16, device, stream
_ARGTYPES = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I, _P]


def _lib():
    fn = build.load("rmsnorm").rmsnorm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def kernel_scale(scale: torch.Tensor) -> torch.Tensor:
    """The scale as the kernel reads it: an f32 or bf16 ``scale`` itself
    (contiguous, so no copy and no launch for a contiguous one), any other
    float dtype cast to f32."""
    if scale.dtype not in DTYPES:
        scale = scale.to(torch.float32)
    return scale.contiguous()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA x (R, d), f32 or bf16, contiguous (any
    alignment), and scale (d,) of any float dtype; returns (R, d) in x's
    dtype."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm launches on CUDA tensors, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"rmsnorm: x must be (R, d), got {tuple(x.shape)}")
    R, d = x.shape
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: x is {x.dtype}; the kernel takes one of "
                        f"{DTYPES}")
    if not scale.dtype.is_floating_point:
        raise TypeError(f"rmsnorm: scale is {scale.dtype}, not a float type")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale has shape {tuple(scale.shape)}, "
                         f"expected ({d},)")
    if scale.device != dev:
        raise ValueError(f"rmsnorm: scale is on {scale.device}, x on {dev}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x is not contiguous")
    s = kernel_scale(scale)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    err = _lib()(x.data_ptr(), s.data_ptr(), out.data_ptr(), R, d, EPS,
                 int(x.dtype == torch.bfloat16),
                 int(s.dtype == torch.bfloat16), *build.stream_of(dev))
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
