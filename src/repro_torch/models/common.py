"""Shared model-building utilities (the port of ``repro/models/common.py``).

Parameters are nested dicts of tensors.  A model module defines a
``param_defs(cfg) -> dict[path, ParamDef]`` table; :func:`init_params`
builds real tensors from it with an explicit ``torch.Generator``, and
:func:`numpy_params` builds the same tree as seeded numpy arrays, the
form both packages can consume (the tests and the golden generator feed
them to the JAX reference too).  :func:`param_specs` gives each leaf's
shape and dtype without allocating it: a ``Spec`` (shape, torch dtype),
the port's counterpart of the reference's ``ShapeDtypeStruct``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ref
from repro_torch.training.data import Spec

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0
    dtype: str = "bfloat16"


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the configs name dtypes as
    strings, as the reference's do)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def param_specs(defs: Dict[str, ParamDef]) -> Dict[str, Any]:
    """The parameter tree's leaves as ``Spec(shape, torch dtype)``: no
    allocation (the dry run's input)."""
    out: Dict[str, Any] = {}
    for path, d in defs.items():
        assign(out, path, Spec(d.shape, torch_dtype(d.dtype)))
    return out


def _std(d: ParamDef) -> float:
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return d.scale / math.sqrt(max(1, fan_in))


# the most values a normal draw of :func:`init_params` holds in f32 at once
# (1 GiB): a larger leaf is drawn slice by slice along its leading axis
# into its preallocated result (a full-width Gemma-3 27B MLP leaf is 7.2 G
# values, whose whole f32 draw beside its bf16 result would not fit one
# card)
INIT_SLICE = 1 << 28


def _fill_normal(out: torch.Tensor, std: float, generator: torch.Generator,
                 limit: int) -> None:
    """``out`` filled with normals of ``std`` drawn in f32 from
    ``generator`` on the generator's device, then cast into ``out``'s
    dtype and device, at most ``limit`` values a draw: whole leading-axis
    rows a draw, a row larger than ``limit`` itself sliced the same way."""
    if out.numel() <= limit:
        val = torch.randn(out.shape, generator=generator,
                          dtype=torch.float32, device=generator.device)
        out.copy_(val.mul_(std))
        return
    row = out[0].numel()
    if row > limit:
        for i in range(out.shape[0]):
            _fill_normal(out[i], std, generator, limit)
        return
    step = limit // row
    for i in range(0, out.shape[0], step):
        _fill_normal(out[i:i + step], std, generator, limit)


def init_params(defs: Dict[str, ParamDef], generator: torch.Generator,
                device: DeviceLike = None) -> PyTree:
    """Random parameters: zeros / ones, else normal with std ``scale /
    sqrt(fan_in)`` drawn in f32 from ``generator`` on the generator's own
    device and cast to each def's dtype on ``device``, a leaf larger than
    ``INIT_SLICE`` values slice by slice (:func:`_fill_normal`), so no f32
    temporary exceeds 1 GiB.  A generator on the card draws the weights
    where they live (a full-depth language model has billions of values);
    a CPU generator draws them on the host and copies them."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for path, d in sorted(defs.items()):
        dt = torch_dtype(d.dtype)
        if d.init == "zeros":
            val = torch.zeros(d.shape, dtype=dt, device=dev)
        elif d.init == "ones":
            val = torch.ones(d.shape, dtype=dt, device=dev)
        else:
            val = torch.empty(d.shape, dtype=dt, device=dev)
            _fill_normal(val, _std(d), generator, INIT_SLICE)
        assign(out, path, val)
    return out


def iter_numpy_params(defs: Dict[str, ParamDef], seed: int,
                      constant_std: Optional[float] = None):
    """The leaves of :func:`numpy_params` one at a time, ``(path,
    array)`` in its order from its one stream: a caller that converts
    each leaf and drops it holds one numpy leaf at a time."""
    rng = np.random.default_rng(seed)
    for path, d in sorted(defs.items()):
        if d.init in ("zeros", "ones") and constant_std is not None:
            val = (rng.standard_normal(d.shape, dtype=np.float32)
                   * np.float32(constant_std)
                   + np.float32(d.init == "ones"))
        elif d.init == "zeros":
            val = np.zeros(d.shape, np.float32)
        elif d.init == "ones":
            val = np.ones(d.shape, np.float32)
        else:
            val = (rng.standard_normal(d.shape, dtype=np.float32)
                   * np.float32(_std(d)))
        yield path, val


def numpy_params(defs: Dict[str, ParamDef], seed: int,
                 constant_std: Optional[float] = None) -> PyTree:
    """Seeded f32 numpy weights in the same tree and layouts: one
    ``np.random.default_rng(seed)`` stream over the defs in sorted path
    order (:func:`iter_numpy_params`).  Each package casts them to the
    config's dtype itself (numpy has no bfloat16).

    ``constant_std`` makes every leaf random: a ``"zeros"`` or ``"ones"``
    leaf becomes its constant plus normals of that std.  The parity checks
    of models that zero-initialise their output paths need it (DiT's
    adaLN-Zero gates and final layer, the UNet's ``c2`` and ``conv_out``):
    with those leaves at 0 the output is 0 for every input, and any
    forward at all would match.  Serving keeps the default."""
    out: Dict[str, Any] = {}
    for path, val in iter_numpy_params(defs, seed, constant_std):
        assign(out, path, val)
    return out


def params_from_numpy(defs: Dict[str, ParamDef], tree: Mapping, name: str,
                      device: DeviceLike = None, layout=None) -> PyTree:
    """The reference's parameter tree (nested dict of numpy arrays, or of
    anything ``np.asarray`` reads, in the JAX layouts) as tensors of each
    def's dtype on ``device`` (``None``: CUDA, raising without it), each
    leaf's shape checked against its def (``name`` names the config in the
    error); ``layout`` maps a leaf to the port's layout where it has
    another."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for path, d in sorted(defs.items()):
        arr = np.asarray(nested(tree, path), dtype=np.float32)
        if arr.shape != d.shape:
            raise ValueError(f"parameter {path}: shape {arr.shape}, "
                             f"expected {d.shape} for {name}")
        t = torch.from_numpy(arr).to(torch_dtype(d.dtype))
        assign(out, path, (layout(t) if layout else t).to(dev))
    return out


def nested(tree: Mapping, path: str):
    """The node at ``"a/b/c"`` of a nested parameter tree."""
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def assign(tree: Dict[str, Any], path: str, val: Any) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = val


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (population variance), cast
    back to ``x``'s dtype — ``repro.models.common.layer_norm``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# RMSNorm over the last axis in f32, scaled by ``1 + scale``, cast back to
# ``x``'s dtype (``repro.models.common.rms_norm``): the rmsnorm kernel's
# plain version.  The language models call the kernel's entry point
# instead (``kernels.ops.rmsnorm``, the same function; a port choice, see
# ``models/transformer.py``)
rms_norm = ref.rmsnorm_ref


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SiLU of ``gate`` in f32, cast back to ``gate``'s dtype, times ``up``
    — ``repro.models.common.swiglu``."""
    return silu32(gate) * up


def silu32(x: torch.Tensor) -> torch.Tensor:
    """SiLU in f32, cast back to ``x``'s dtype — the reference's
    ``jax.nn.silu(h.astype(jnp.float32)).astype(x.dtype)``."""
    return F.silu(x.float()).to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel (last) axis of an NHWC tensor, in f32:
    each sample's mean and population variance over (H, W, C / groups),
    consecutive channels grouped, cast back to ``x``'s dtype —
    ``repro.models.common.group_norm``.  ``F.group_norm`` on the NCHW
    view groups channels the same way."""
    y = F.group_norm(x.float().permute(0, 3, 1, 2), groups, scale.float(),
                     bias.float(), eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal diffusion timestep embedding, (B,) -> (B, dim) in f32:
    cosines then sines of ``t`` times ``max_period ** (-i / half)`` —
    ``repro.models.common.timestep_embedding``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def row_order_sum(ids: torch.Tensor, rows: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """(n, d) sums of ``rows`` (N, d) onto ``ids`` (N,), each id's rows
    added in row order in ``rows``' dtype, one rounding per add: what
    XLA's scatter-add (the gradient of ``jnp.take``) computes on the CPU.

    A stable sort by id ranks each row within its id; the rows of one
    rank fall on distinct ids, so one ``index_add_`` a rank adds each
    exactly and rounds once.  ``max rank + 1`` adds (the most rows of one
    id), after one host read of the ranks' sizes."""
    g = rows.new_zeros((n, rows.shape[-1]))
    if ids.numel() == 0:
        return g
    if is_fake(rows):
        # no data to rank by (the dry run's fake tensors): the same
        # scatter-add in one pass, which is what a cost model counts
        return g.index_add_(0, ids, rows)
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    pos = torch.arange(sid.numel(), device=sid.device)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    src, dst = order[by_rank], sid[by_rank]
    start = 0
    for count in torch.bincount(rank).tolist():
        sl = slice(start, start + count)
        g.index_add_(0, dst[sl], rows[src[sl]])
        start += count
    return g


def is_fake(x: torch.Tensor) -> bool:
    """Whether ``x`` is a fake tensor (``FakeTensorMode``: shapes and
    dtypes without data)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(x)


class _Embedding(torch.autograd.Function):
    """``w[ids]`` whose backward is :func:`row_order_sum`."""

    @staticmethod
    def forward(ctx, w, ids):
        ctx.save_for_backward(ids)
        ctx.n = w.shape[0]
        return F.embedding(ids, w)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        return row_order_sum(ids.reshape(-1), dy.reshape(-1, dy.shape[-1]),
                             ctx.n), None


def embedding(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(w, ids, axis=0)``, rows (V, d) -> (*ids.shape, d), with
    the reference's gradient: each id's rows summed in row order in
    ``w``'s dtype (:func:`row_order_sum`).  ``F.embedding``'s own
    backward sums a bf16 table's rows in f32, another number after ~100
    rows an id."""
    return _Embedding.apply(w, ids)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of f32 logits (..., V) against int labels (...):
    the f32 logsumexp minus the gold logit, averaged —
    ``repro.models.common.softmax_xent``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def checkpointed(fn, *args):
    """``fn(*args)``, recomputed in the backward instead of keeping its
    intermediates (``torch.utils.checkpoint``, non-reentrant: the
    reference's ``jax.checkpoint``) when grad mode is on; a plain call
    otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _grad_leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    leaf = p.detach().requires_grad_(True)
    leaf.grad = g
    return leaf


def _live(params: PyTree, grads: PyTree, stacked: bool) -> PyTree:
    if isinstance(params, Mapping):
        return {k: _live(v, grads[k], stacked or k == "layers")
                for k, v in params.items()}
    if stacked:
        return [_grad_leaf(p, g) for p, g in zip(params, grads)]
    return _grad_leaf(params, grads)


def value_and_grad(loss_fn, params: PyTree, *args):
    """``((loss, metrics), grads)`` of ``loss_fn(params, *args) -> (loss,
    metrics)``, as ``jax.value_and_grad(..., has_aux=True)``: the loss and
    metrics detached, the gradient of every leaf (zeros where the loss does
    not reach it) in a tree like ``params``, each leaf in its parameter's
    dtype; cuDNN's TF32 off throughout (:func:`exact_f32`).

    Each gradient is a preallocated buffer that the backward adds into in
    place.  A stacked leaf under ``"layers"`` (layers on its leading axis)
    reaches ``loss_fn`` as a list of its layers, each a leaf whose
    gradient is its row of the stacked buffer: the models index
    ``w[l]`` alike in both forms, and no layer's backward materialises a
    zero tensor of the whole stack (what the backward of ``w[l]`` on one
    stacked leaf does, 2.4 GB a layer for a Granite expert leaf).  Needs
    no ``requires_grad`` on ``params``; changes none of them."""
    grads = tree_map(lambda p: torch.zeros_like(
        p, memory_format=torch.preserve_format), params)
    live = _live(params, grads, False)
    with torch.enable_grad(), exact_f32():
        loss, metrics = loss_fn(live, *args)
        loss.backward()
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            grads)


def make_train_step(loss_fn, cfg, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of ``loss_fn(params, batch, cfg)`` and one
    AdamW update (applied in place: the reference donates both trees),
    the loss's metrics merged with the optimizer's."""
    from repro_torch.training.optimizer import adamw_update

    def train_step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, batch, cfg), params)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


@contextlib.contextmanager
def exact_f32():
    """cuDNN's f32 convolutions in f32, not TF32, inside the block
    (restored after): the backward of an f32 forward runs outside the
    forward's own guard (``resnet._exact_f32``), after it returns.
    cuBLAS's TF32 is off by PyTorch's default and left alone."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of nested dicts (and of ``rest``, trees of
    the same structure), into a tree of the same structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree: PyTree):
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def count_params(tree: PyTree) -> int:
    """The number of values in a parameter tree."""
    return sum(int(x.numel()) for x in leaves(tree))


def check_finite(tree: PyTree) -> torch.Tensor:
    """A 0-d bool tensor: whether every value of the tree is finite."""
    flags = [torch.isfinite(x.float()).all() for x in leaves(tree)]
    return torch.stack(flags).all()
