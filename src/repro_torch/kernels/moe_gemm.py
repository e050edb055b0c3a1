"""Wrapper of the Hopper ``moe_gemm`` kernels (``csrc/moe_gemm.cu``).

The kernels replace the TPU kernel ``repro/kernels/moe_gemm.py``
(``_moe_gemm_kernel`` / ``moe_gemm``); their plain version is
:func:`repro_torch.kernels.ref.moe_gemm_ref`.  At the Granite-3.0 MoE
shapes it sits near the ridge of an H100: ~69 us for each 64.4 GFLOP,
230.7 MB bf16 product (bytes at 3.35 TB/s; the products alone 65 us at
989 TFLOP/s).  Three variants, one per kind of input, chosen here by
:func:`variant` before the launch from dtype, shape and alignment alone
(never as a fallback after a failure):

* ``tma_wgmma``: bf16 where a tensor map can describe x and w (d and f
  multiples of 8, both 16-byte aligned): a persistent, warp-specialised
  kernel, TMA into an mbarrier ring, ``wgmma`` products;
* ``mma_sync``: every other bf16 input (a ragged f such as 500, an odd d,
  a misaligned view), ``mma.sync`` tiles staged by the threads;
* ``f32_simt``: f32, scalar FMAs on ``cp.async`` double-buffered slices
  (the tensor cores would round f32 to TF32).

This wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on PyTorch's current stream and raises on a refused
launch or a failed tensor-map encode.  It never synchronises and never
falls back: a CPU tensor is refused here (the dispatch in
:mod:`repro_torch.kernels.ops` sends those to the plain version).
``moe_gemm.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_EXPERTS = 65535                 # the mma_sync / f32 grid's z dimension
VARIANTS = ("tma_wgmma", "mma_sync", "f32_simt")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"moe_gemm_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
             "moe_gemm_tma_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P]}


def _lib(name: str):
    fn = getattr(build.load("moe_gemm"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel that :func:`moe_gemm` launches for x (E, C, d) and w
    (E, d, f): ``tma_wgmma`` for bf16 with d and f multiples of 8 and both
    data pointers 16-byte aligned (what a tensor map takes), ``mma_sync``
    for other bf16, ``f32_simt`` for f32.  A pure function of dtype,
    shape and alignment; touches no device."""
    if x.dtype == torch.float32:
        return "f32_simt"
    d, f = x.shape[-1], w.shape[-1]
    if d >= 8 and d % 8 == 0 and f % 8 == 0 and x.data_ptr() % 16 == 0 \
            and w.data_ptr() % 16 == 0:
        return "tma_wgmma"
    return "mma_sync"


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of :func:`variant` on CUDA x (E, C, d) and w
    (E, d, f), one dtype of f32 / bf16, contiguous (any alignment);
    returns (E, C, f) in x's dtype."""
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
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gemm: dtypes {x.dtype}/{w.dtype}; the kernel "
                        f"takes one of {DTYPES}")
    if w.device != dev:
        raise ValueError(f"moe_gemm: w is on {w.device}, x on {dev}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"moe_gemm: {name} is not contiguous")
    kind = variant(x, w)
    if kind != "tma_wgmma" and E > MAX_EXPERTS:
        raise ValueError(f"moe_gemm: {E} experts, the {kind} kernel takes "
                         f"at most {MAX_EXPERTS}")
    out = torch.empty((E, C, f), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    if kind == "tma_wgmma":
        err = _lib("moe_gemm_tma_launch")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
            *build.stream_of(dev))
    else:
        err = _lib("moe_gemm_launch")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d, f,
            int(x.dtype == torch.bfloat16), *build.stream_of(dev))
    build.raise_on(f"moe_gemm ({kind})", err)
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
