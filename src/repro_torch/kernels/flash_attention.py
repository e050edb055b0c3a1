"""Wrapper of the Hopper ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

The kernel replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``_fa_kernel`` / ``flash_attention_fwd``) and the head folding, GQA
repeat and D padding of its wrapper ``repro/kernels/ops.py``; its plain
version is :func:`repro_torch.kernels.ref.flash_attention_ref`.  This
wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on PyTorch's current stream and raises on a refused
launch.  It never synchronises and never falls back: a CPU tensor is
refused here (the dispatch in :mod:`repro_torch.kernels.ops` sends those
to the plain version).  ``flash_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 5 + [ctypes.c_float] + [_I] * 4 + [_P]


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int]) -> None:
    """What the kernel takes: q (B,S,H,D), k and v (B,S,KV,D) with
    H % KV == 0, one dtype of f32 / bf16, 1 <= D <= 128, contiguous, on
    one device, and a window of at least one key.  Raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d "
                         "(B, S, heads, D)")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, D) or tuple(v.shape) != (B, S, KV, D):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, KV, D) = "
                         f"({B}, {S}, KV, {D})")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} kv heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside the "
                         f"kernel's 1..{MAX_HEAD_DIM}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; the kernel takes one of {DTYPES}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1 masks "
                         "every key")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors q (B,S,H,D), k/v (B,S,KV,D);
    returns (B,S,H,D) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors, got "
                         f"{q.device}")
    check_args(q, k, v, window)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], D, D ** -0.5, int(causal),
                 0 if window is None else int(window),
                 int(q.dtype == torch.bfloat16), *build.stream_of(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
