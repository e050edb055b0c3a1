"""Wrapper of the Hopper ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

The kernel replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``_fa_kernel`` :32 / ``flash_attention_fwd`` :76, ``pallas_call`` :105)
and the head folding, GQA repeat and D padding of its wrapper
``repro/kernels/ops.py``; its plain
version is :func:`repro_torch.kernels.ref.flash_attention_ref`.  This
wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on PyTorch's current stream and raises on a refused
launch.  It never synchronises and never falls back: a CPU tensor is
refused here (the dispatch in :mod:`repro_torch.kernels.ops` sends those
to the plain version).  ``flash_attention.launches`` counts the launches.

Three variants, chosen by :func:`variant` before the launch from dtype,
head width and alignment alone (never as a fallback after a failure):
``tma_wgmma`` for bf16 at D = 64, 72, 80 or 128 with 16-byte aligned q,
k, v (TMA into an mbarrier ring, ``wgmma`` for Q K^T and, with P from
registers, for P V; the key tiles split between two warpgroups where
:func:`split_keys` says so; a head 72 or 80 wide is read through tensor
maps of its true width into 128-wide tiles, zero past D, and its P V is
one ``wgmma`` of width D); ``mma_sync`` for other bf16 inputs (D below
64 or outside those four, views off 16-byte alignment, B * H past the
grid);
``f32_regtile`` for every f32 input.

Every variant walks only the key tiles that some row of its query tile(s)
can see, :func:`key_tile_band`: under ``causal`` none past the tile of
the last row's own key, under a ``window`` none before the tile of the
first row's first key.  Skipping the rest is exact (a tile past the
diagonal adds zeros, one before the window is wiped by the first live
tile), so the output equals a walk over every tile bit for bit.  The
f32 kernel is bound by
operations on the FMA pipes (TF32 would round the inputs): 122.5 us at
DeiT-B's B=8, S=578, H=12, D=64 on an H100 (67 TFLOP/s).  It holds 4 x 8
register tiles of scores a thread, so each shared-memory read feeds 8 to
10 FMAs where the scalar kernel it replaces fed 4, and double-buffers its
K / V tiles through cp.async (see the source's note).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)

VARIANTS = ("tma_wgmma", "mma_sync", "f32_regtile")
WGMMA_HEAD_DIMS = (64, 72, 80, 128)
WGMMA_MAX_HEADS = 65535         # B * H: the tma_wgmma grid's y dimension
ROWS = 64                       # query rows of one warpgroup (tma_wgmma)

_P = ctypes.c_void_p
_I = ctypes.c_int
# both launchers: q, k, v, out, B, S, H, KV, D, scale, causal, window, then
# is_bf16 (flash_attention_launch) or split (flash_attention_wgmma_launch),
# device, stream
_ARGTYPES = [_P] * 4 + [_I] * 5 + [ctypes.c_float] + [_I] * 4 + [_P]


def _lib(name: str):
    fn = getattr(build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that :func:`flash_attention` launches: ``tma_wgmma`` for
    bf16 with D in ``WGMMA_HEAD_DIMS`` (64, 72, 80, 128), q, k, v 16-byte
    aligned (what a tensor map takes) and B * H within its grid,
    ``mma_sync`` for other bf16,
    ``f32_regtile`` for f32 (any shape and alignment: the kernel copies 4
    bytes at a time where 16 do not fit).  A pure function of dtype, shape
    and alignment; touches no device."""
    if q.dtype == torch.float32:
        return "f32_regtile"
    if q.shape[-1] in WGMMA_HEAD_DIMS \
            and q.shape[0] * q.shape[2] <= WGMMA_MAX_HEADS \
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)):
        return "tma_wgmma"
    return "mma_sync"


def key_tile_band(q_lo: int, rows: int, S: int, causal: bool,
                  window: Optional[int], keys: int = 64) -> range:
    """The key tiles of ``keys`` keys that the kernels walk for query
    rows ``[q_lo, q_lo + rows)`` of a sequence of ``S``: those that some
    row below ``S`` can see.  Under ``causal`` the last is the tile of key
    ``min(S - 1, q_hi)``, else the last tile of ``S``; under a ``window``
    (``window > 0``; ``None`` or ``0`` is none) the first is the tile of
    key ``max(0, q_lo - window + 1)``, else tile 0.  Empty where ``q_lo >=
    S``.  The Python statement of ``csrc/flash_attention.cu::key_band``."""
    if q_lo >= S:
        return range(0)
    q_hi = min(S - 1, q_lo + rows - 1)
    hi = (q_hi if causal else S - 1) // keys
    lo = max(0, q_lo - window + 1) // keys if window and window > 0 else 0
    return range(lo, hi + 1)


def split_keys(B: int, S: int, H: int, sm_count: int) -> bool:
    """Whether the ``tma_wgmma`` kernel splits each query tile's key tiles
    between its two consumer warpgroups: where one 64-row warpgroup per
    query tile, B * H * ceil(S / 64) of them, would fill less than two
    waves of the card's SMs.  Else each block's two warpgroups take two
    query tiles and share every K / V tile."""
    return B * H * -(-S // ROWS) < 2 * sm_count


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
    kind = variant(q, k, v)
    index, stream = build.stream_of(q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], D, D ** -0.5, int(causal),
            0 if window is None else int(window))
    if kind == "tma_wgmma":
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        err = _lib("flash_attention_wgmma_launch")(
            *args, int(split_keys(B, S, H, sms)), index, stream)
    else:
        err = _lib("flash_attention_launch")(
            *args, int(q.dtype == torch.bfloat16), index, stream)
    build.raise_on(f"flash_attention ({kind})", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
