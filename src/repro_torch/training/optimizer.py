"""AdamW + schedules over parameter trees (the port of
``repro/training/optimizer.py``).

The math follows the reference operation for operation: f32 arithmetic,
moments stored in ``cfg.state_dtype`` (``float32`` by default;
``bfloat16`` where f32 moments cannot fit), each parameter rounded back
to its own dtype.  Two differences of form, not of value:

* the update is applied **in place**: the returned parameters and moments
  are the tensors passed in, overwritten (the reference's train loop
  donates both trees to its jitted step, so no caller of it keeps the
  old values either).  A full-width Granite-3.0 MoE holds 47.7 GB of
  parameters, gradients and f32 moments on one card; a second copy of
  the moments would not fit;
* large leaves are updated a chunk of their leading axis at a time (at
  most ``CHUNK`` values), and ``global_norm`` sums their squares chunk by
  chunk: the stacked expert leaves of that model are (32, 48, 1536, 512),
  4.83 GB per f32 temporary, and the update makes about eight.  The
  elementwise arithmetic is the same; a norm's sum is taken in another
  association, as XLA's own reduction order differs from any eager one.

XLA may contract ``b1 * m + (1 - b1) * g`` and the like into fused
multiply-adds under ``jit``; this module rounds each product, so the
moments agree with the reference's within a few f32 ulp, not bit for bit
(``tests/test_torch_optimizer.py`` states the limits).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.common import leaves, torch_dtype, tree_map
from repro_torch.training.data import Spec

PyTree = Any
# values of a leaf updated at once (a chunk of its leading axis)
CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    schedule: str = "cosine"          # cosine | constant | linear_warmup
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    step: torch.Tensor                # 0-d int32
    m: PyTree
    v: PyTree


def init_opt_state(params: PyTree, cfg: AdamWConfig) -> OptState:
    """Zero moments of ``cfg.state_dtype`` beside each parameter, and step
    0, on the parameters' device."""
    dt = torch_dtype(cfg.state_dtype)
    first = next(leaves(params))

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def opt_state_specs(param_specs: PyTree, cfg: AdamWConfig) -> OptState:
    """``Spec`` mirror of :func:`init_opt_state` (shapes and torch dtypes,
    no allocation) for the dry run."""
    dt = torch_dtype(cfg.state_dtype)
    spec = lambda p: Spec(tuple(p.shape), dt)  # noqa: E731
    return OptState(step=Spec((), torch.int32), m=tree_map(spec, param_specs),
                    v=tree_map(spec, param_specs))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (0-d int tensor) as a 0-d f32 tensor
    on its device: linear warmup over ``warmup_steps``, then constant,
    linear decay or cosine decay to 0 at ``total_steps``."""
    step_f = step.to(torch.float32)
    warm = torch.clamp((step_f + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step_f - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "linear_warmup":
        return cfg.lr * warm * (1.0 - frac)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def _chunks(*xs: torch.Tensor):
    """Matching views of ``xs`` (one shape), a chunk of the leading axis
    at a time, each of at most ``CHUNK`` values (a whole leaf when it is
    small or 0-d)."""
    x = xs[0]
    if x.dim() == 0 or x.numel() <= CHUNK:
        yield xs
        return
    rows = max(1, CHUNK // max(1, x.numel() // x.shape[0]))
    for i in range(0, x.shape[0], rows):
        yield tuple(t[i:i + rows] for t in xs)


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    total = None
    for (c,) in _chunks(x):
        s = c.float().square().sum()
        total = s if total is None else total + s
    return total


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack([_sum_squares(x)
                                   for x in leaves(tree)]).sum())


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """(grads scaled by ``min(1, max_norm / (norm + 1e-9))`` in f32, each
    rounded back to its dtype; the norm)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _update(p, g, m, v, cfg: AdamWConfig, lr, bc1, bc2, scale):
    """One chunk of the AdamW update, written into p, m and v."""
    g32 = g.float()
    if scale is not None:                     # the clip, rounded as its own
        g32 = (g32 * scale).to(g.dtype).float()
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32.square()
    mhat = m32 / bc1
    vhat = v32 / bc2
    p32 = p.float()
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
    p.copy_(p32 - lr * delta)
    m.copy_(m32)
    v.copy_(v32)


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: OptState,
                 cfg: AdamWConfig) -> Tuple[PyTree, OptState, dict]:
    """One AdamW step (math in f32, moments in ``cfg.state_dtype``),
    applied in place to ``params`` and the moments of ``state``.  Returns
    (params, the new state, {"lr", "grad_norm"}), the metrics 0-d f32
    tensors.  ``grads`` is not changed (the clip is applied chunk by chunk
    as it is read)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state.step + 1
    lr = schedule_lr(cfg, state.step)
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.b1).to(step.device), step_f)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2).to(step.device), step_f)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        for chunk in _chunks(p, g, m, v):
            _update(*chunk, cfg, lr, bc1, bc2, scale)
    return params, OptState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gnorm}
