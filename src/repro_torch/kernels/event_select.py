"""Wrapper of the Hopper ``event_select`` kernel (``csrc/event_select.cu``).

The kernel replaces the TPU kernel ``repro/kernels/event_select.py``
(``_event_select_kernel`` / ``event_select_fwd``); its plain version is
:func:`repro_torch.kernels.ref.event_select_ref`.  This wrapper checks
device, dtype, shape and contiguity, allocates the outputs, launches on
PyTorch's current stream and raises on a refused launch.  It never
synchronises and never falls back: a CPU tensor is refused here (the
dispatch in :mod:`repro_torch.kernels.ops` sends those to the plain
version).  ``event_select.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

EPS = 1e-6

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 19 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                         ctypes.c_int, _P]


def _lib():
    lib = build.load("event_select")
    fn = lib.event_select_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, x, dtype, shape, dev):
    if x.device != dev:
        raise ValueError(f"event_select: {name} is on {x.device}, "
                         f"expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"event_select: {name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"event_select: {name} has shape "
                         f"{tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"event_select: {name} is not contiguous")


def event_select(fscal: torch.Tensor, iscal: torch.Tensor,
                 starts: torch.Tensor, ends: torch.Tensor,
                 sizes: torch.Tensor, n: torch.Tensor, head: torch.Tensor,
                 speeds: torch.Tensor, busy: torch.Tensor,
                 latency: torch.Tensor, inv_bw: torch.Tensor):
    """Launch the kernel.

    ``fscal`` is the (8,) f32 buffer ``(t, d, p, payload)`` of the fresh
    candidate then of the buffer head; ``iscal`` the (4,) int32 buffer
    ``(node_a, avail_a, node_b, avail_b)`` — device tensors, so a launch
    needs no host read.  ``starts``/``ends``/``sizes`` are the (K, W) f32
    live windows, ``n``/``head`` (K,) int32, ``speeds``/``busy`` (K,) f32,
    ``latency``/``inv_bw`` (K, K) f32.  Returns ``(take_fresh, t, node,
    feasible (K,), arrive (K,), j (K,), cap (K,), load (K,))``.
    """
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"event_select launches on CUDA tensors, got {dev}")
    K, W = starts.shape
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (
            ("fscal", fscal, f32, (8,)), ("iscal", iscal, i32, (4,)),
            ("starts", starts, f32, (K, W)), ("ends", ends, f32, (K, W)),
            ("sizes", sizes, f32, (K, W)), ("n", n, i32, (K,)),
            ("head", head, i32, (K,)), ("speeds", speeds, f32, (K,)),
            ("busy", busy, f32, (K,)), ("latency", latency, f32, (K, K)),
            ("inv_bw", inv_bw, f32, (K, K))):
        _check(name, x, dtype, shape, dev)
    take = torch.empty((), dtype=torch.bool, device=dev)
    t = torch.empty((), dtype=f32, device=dev)
    node = torch.empty((), dtype=i32, device=dev)
    feas = torch.empty((K,), dtype=torch.bool, device=dev)
    arrive = torch.empty((K,), dtype=f32, device=dev)
    j = torch.empty((K,), dtype=i32, device=dev)
    cap = torch.empty((K,), dtype=f32, device=dev)
    load = torch.empty((K,), dtype=f32, device=dev)
    ptrs = [x.data_ptr() for x in (fscal, iscal, starts, ends, sizes, n, head,
                                   speeds, busy, latency, inv_bw, take, t,
                                   node, feas, arrive, j, cap, load)]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    err = _lib()(*ptrs, K, W, EPS, index, stream)
    if err != 0:
        raise RuntimeError(f"event_select launch failed: CUDA error {err}")
    event_select.launches += 1
    return take, t, node, feas, arrive, j, cap, load


event_select.launches = 0
