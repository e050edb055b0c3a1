"""The model-path kernels as ``torch.library`` operators, so that fake
tensors (``FakeTensorMode``: the dry run and the cost model,
:mod:`repro_torch.launch.op_cost`) see their shapes and their work
without a launch.

Four operators in the ``repro_torch`` namespace, each defined by a schema
with a CUDA implementation that launches the hand-written kernel through
its wrapper (the wrapper's launch counter counts it, as before), a fake
implementation (shapes and dtypes only, registered for ``Meta`` too), a
FLOP formula for ``torch.utils.flop_counter`` and a DTensor sharding rule
for a DTensor that reaches one outside ``local_map``:

* ``flash_attention(q, k, v, causal, window) -> out`` (``window`` 0:
  none), :mod:`.flash_attention`;
* ``rmsnorm(x, scale) -> out`` and ``rmsnorm_bwd(x, scale, dy) -> (dx,
  dscale)``, :mod:`.rmsnorm`;
* ``moe_gemm(x, w) -> out``, :mod:`.moe_gemm` (the backward's two
  products too).

The schemas go through ``Library.define`` / ``Library.impl`` (the
dispatcher calls the Python implementation directly), not
``torch.library.custom_op``, whose Python wrapper adds per-call work.
:mod:`repro_torch.kernels.ops` calls these operators for CUDA tensors
only: a CPU tensor still takes the plain version there, and nothing
catches a build or launch error.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gemm as _mg
from repro_torch.kernels import rmsnorm as _rn

NS = "repro_torch"
_LIB = torch.library.Library(NS, "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> Tensor")
_LIB.define("rmsnorm(Tensor x, Tensor scale) -> Tensor")
_LIB.define("rmsnorm_bwd(Tensor x, Tensor scale, Tensor dy) -> "
            "(Tensor, Tensor)")
_LIB.define("moe_gemm(Tensor x, Tensor w) -> Tensor")

ops = getattr(torch.ops, NS)


def _flash_cuda(q, k, v, causal: bool, window: int):
    return _fa.flash_attention(q, k, v, causal=causal,
                               window=window or None)


_LIB.impl("flash_attention", _flash_cuda, "CUDA")
_LIB.impl("rmsnorm", _rn.rmsnorm, "CUDA")
_LIB.impl("rmsnorm_bwd", _rn.rmsnorm_bwd, "CUDA")
_LIB.impl("moe_gemm", _mg.moe_gemm, "CUDA")


# ---------------------------------------------------------------------------
# fake implementations: the wrappers' checks of shape and dtype, then empty
# outputs of the kernels' shapes
# ---------------------------------------------------------------------------
@torch.library.register_fake(f"{NS}::flash_attention", lib=_LIB)
def _flash_fake(q, k, v, causal, window):
    _fa.check_args(q, k, v, window or None)
    return torch.empty_like(q)


@torch.library.register_fake(f"{NS}::rmsnorm", lib=_LIB)
def _rmsnorm_fake(x, scale):
    if x.dim() != 2 or tuple(scale.shape) != (x.shape[1],):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}")
    return torch.empty_like(x)


@torch.library.register_fake(f"{NS}::rmsnorm_bwd", lib=_LIB)
def _rmsnorm_bwd_fake(x, scale, dy):
    if x.dim() != 2 or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}")
    return torch.empty_like(x), torch.empty_like(scale)


@torch.library.register_fake(f"{NS}::moe_gemm", lib=_LIB)
def _moe_gemm_fake(x, w):
    if x.dim() != 3 or w.dim() != 3 or tuple(w.shape[:2]) != (
            x.shape[0], x.shape[2]):
        raise ValueError(f"moe_gemm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


# ---------------------------------------------------------------------------
# FLOP formulas: the work each kernel does, as torch.utils.flop_counter
# counts matrix products (2 per multiply-add)
# ---------------------------------------------------------------------------
def flash_pairs(S: int, causal: bool, window: Optional[int],
                rows: int = _fa.ROWS, keys: int = 64) -> int:
    """(query row, key) pairs the kernel multiplies for one (batch, head):
    each tile of ``rows`` query rows against every key of the key tiles
    of :func:`flash_attention.key_tile_band` (the bf16 kernels' 64 x 64
    tiles), the tiles cut at ``S``.  Not the exact triangle: a tile on
    the diagonal or the window's edge counts whole, as the kernel computes
    it whole."""
    total = 0
    for q_lo in range(0, S, rows):
        band = _fa.key_tile_band(q_lo, rows, S, causal, window, keys)
        if not len(band):
            continue
        k_lo, k_hi = band[0] * keys, min(S, (band[-1] + 1) * keys)
        total += min(rows, S - q_lo) * (k_hi - k_lo)
    return total


@register_flop_formula(ops.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal=True, window=0,
                 *args, out_shape=None, **kwargs) -> int:
    B, S, H, D = q_shape
    return 4 * B * H * D * flash_pairs(S, causal, window or None)


@register_flop_formula(ops.moe_gemm)
def _moe_gemm_flops(x_shape, w_shape, *args, out_shape=None, **kwargs
                    ) -> int:
    E, C, d = x_shape
    return 2 * E * C * d * w_shape[2]


@register_flop_formula([ops.rmsnorm, ops.rmsnorm_bwd])
def _rmsnorm_flops(*args, **kwargs) -> int:
    """No matrix product: the cost model, as the reference's, counts the
    FLOPs of products and convolutions only (a norm moves bytes)."""
    return 0


# ---------------------------------------------------------------------------
# DTensor sharding rules (a DTensor that reaches an operator outside
# local_map): the kernels work on independent rows / experts / heads
# ---------------------------------------------------------------------------
def _register_sharding() -> None:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R = Replicate()

    @register_sharding(ops.flash_attention.default)
    def _flash(q, k, v, causal, window):
        # batch, or heads (GQA: the query heads of one KV head stay together)
        return [([R], [R, R, R, None, None]),
                ([Shard(0)], [Shard(0), Shard(0), Shard(0), None, None]),
                ([Shard(2)], [Shard(2), Shard(2), Shard(2), None, None])]

    @register_sharding(ops.rmsnorm.default)
    def _norm(x, scale):
        return [([R], [R, R]), ([Shard(0)], [Shard(0), R])]

    @register_sharding(ops.rmsnorm_bwd.default)
    def _norm_bwd(x, scale, dy):
        # rows split: each rank's dscale is a partial sum over its rows
        from torch.distributed.tensor import Partial
        return [([R, R], [R, R, R]),
                ([Shard(0), Partial()], [Shard(0), R, Shard(0)])]

    @register_sharding(ops.moe_gemm.default)
    def _moe(x, w):
        # experts, capacity rows or output columns split
        return [([R], [R, R]), ([Shard(0)], [Shard(0), Shard(0)]),
                ([Shard(1)], [Shard(1), R]), ([Shard(2)], [R, Shard(2)])]


_register_sharding()
