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

:func:`rmsnorm_bwd` launches the backward kernel of the same source (the
port's own: the reference differentiates its jnp ``rms_norm``; its plain
version is :func:`repro_torch.kernels.ref.rmsnorm_bwd_ref`): dx and
dscale in one cooperative launch.  Bound by bytes: x and dy read and dx
written once, 75.5 MB at (8192, 1536) bf16, 22.5 us at 3.35 TB/s.  The
kernel reads each row once into registers, keeps several rows in flight
and each thread's dscale sums in registers, and sums dscale over its
persistent grid (at most two blocks an SM) in an order fixed by the grid
and d, without float atomics, so it is deterministic (see the source's
note).  The grid a call needs comes from a plan computed once per
(library, device, dtype pair, vector path, d) and cached, so a call is
one ctypes call and no occupancy query; the (grid, d) f32 partial buffer
comes from PyTorch's caching allocator.  ``rmsnorm_bwd.launches`` counts
its launches.
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


# x, scale, dy, dx, dscale, partial, R, d, eps, x is bf16, scale is bf16,
# vectors, grid, device, stream; and the plan's d, x is bf16, scale is
# bf16, vectors, device, &cap, &rows
_BWD_ARGTYPES = {
    "rmsnorm_bwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float,
                           _I, _I, _I, _I, _I, _P],
    "rmsnorm_bwd_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                         ctypes.POINTER(_I)]}
# (library handle, device, x is bf16, scale is bf16, vectors, d) -> (the
# blocks the card holds at once, rows a block takes at a time)
_BWD_PLANS: dict = {}


def _lib(name: str = "rmsnorm_launch"):
    fn = getattr(build.load("rmsnorm"), name)
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES.get(name, _ARGTYPES)
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


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor):
    """Launch the backward kernel on CUDA x (R, d) and dy (R, d) of one
    dtype, f32 or bf16, contiguous, and scale (d,) of any float dtype;
    returns (dx (R, d) in x's dtype, dscale (d,) in scale's dtype)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_bwd launches on CUDA tensors, got {dev}")
    if x.dim() != 2 or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} must be one (R, d)")
    R, d = x.shape
    if x.dtype not in DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd: x is {x.dtype}, dy {dy.dtype}; the "
                        f"kernel takes one of {DTYPES} for both")
    if not scale.dtype.is_floating_point or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm_bwd: scale is {scale.dtype}"
                         f"{tuple(scale.shape)}, expected a float ({d},)")
    for name, t in (("dy", dy), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"rmsnorm_bwd: {name} is on {t.device}, x on "
                             f"{dev}")
    for name, t in (("x", x), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm_bwd: {name} is not contiguous")
    s = kernel_scale(scale)
    dx = torch.empty_like(x)
    ds = torch.empty_like(s)
    if R == 0:
        return dx, torch.zeros_like(scale)
    if d == 0:
        return dx, ds.to(scale.dtype)
    bf16, sbf16 = int(x.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16)
    vec = int(d % (16 // x.element_size()) == 0 and (
        x.data_ptr() | dy.data_ptr() | dx.data_ptr()) % 16 == 0)
    index, stream = build.stream_of(dev)
    key = (build.load("rmsnorm")._handle, index, bf16, sbf16, vec, d)
    plan = _BWD_PLANS.get(key)
    if plan is None:
        cap, rows = ctypes.c_int(0), ctypes.c_int(0)
        build.raise_on("rmsnorm_bwd (plan)", _lib("rmsnorm_bwd_plan")(
            d, bf16, sbf16, vec, index, ctypes.byref(cap),
            ctypes.byref(rows)))
        plan = _BWD_PLANS[key] = (cap.value, rows.value)
    grid = min(plan[0], -(-R // plan[1]))
    partial = torch.empty((grid, d), dtype=torch.float32, device=dev)
    build.raise_on("rmsnorm_bwd", _lib("rmsnorm_bwd_launch")(
        x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ds.data_ptr(), partial.data_ptr(), R, d, EPS, bf16, sbf16, vec, grid,
        index, stream))
    rmsnorm_bwd.launches += 1
    return dx, ds.to(scale.dtype)


rmsnorm_bwd.launches = 0
