"""Vision Transformer (ViT-L/16, ViT-H/14) and DeiT-B (distillation token)
— the port of ``repro/models/vit.py``.

Patch embedding is part of the model.  Pre-LN blocks, learned positional
embeddings (bilinearly interpolated for other resolutions), tanh-GELU
MLP, and a classifier on the mean of the extra tokens.  Parameters are a
nested dict of tensors in the reference's layouts (HWIO patch kernel,
``(d_in, d_out)`` projections, per-layer weights stacked on a leading L
axis), so :func:`params_from_numpy` carries one set of numpy weights into
either package.  The reference's ``shd.hint`` sharding annotations are
no-ops without a device mesh and are dropped here; so is ``remat``,
which only matters for training.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ViTConfig
from repro_torch.device import DeviceLike
from repro_torch.models import attention as attn
from repro_torch.models import common

PyTree = Any


def param_defs(cfg: ViTConfig) -> Dict[str, common.ParamDef]:
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    p, c = cfg.patch, cfg.in_channels
    dt = cfg.param_dtype
    n_extra = 1 + int(cfg.distill_token)
    n_tok = (cfg.img_res // p) ** 2 + n_extra
    P = common.ParamDef
    return {
        "patch_embed/w": P((p, p, c, d), dtype=dt),
        "patch_embed/b": P((d,), "zeros", dtype=dt),
        "cls_token": P((n_extra, d), "zeros", dtype=dt),
        "pos_embed": P((n_tok, d), scale=0.02, dtype=dt),
        "final_ln/scale": P((d,), "ones", dtype=dt),
        "final_ln/bias": P((d,), "zeros", dtype=dt),
        "head/w": P((d, cfg.n_classes), dtype=dt),
        "head/b": P((cfg.n_classes,), "zeros", dtype=dt),
        "layers/ln1/scale": P((L, d), "ones", dtype=dt),
        "layers/ln1/bias": P((L, d), "zeros", dtype=dt),
        "layers/ln2/scale": P((L, d), "ones", dtype=dt),
        "layers/ln2/bias": P((L, d), "zeros", dtype=dt),
        "layers/wq": P((L, d, d), dtype=dt),
        "layers/wk": P((L, d, d), dtype=dt),
        "layers/wv": P((L, d, d), dtype=dt),
        "layers/wo": P((L, d, d), dtype=dt),
        "layers/bq": P((L, d), "zeros", dtype=dt),
        "layers/bk": P((L, d), "zeros", dtype=dt),
        "layers/bv": P((L, d), "zeros", dtype=dt),
        "layers/bo": P((L, d), "zeros", dtype=dt),
        "layers/w_in": P((L, d, f), dtype=dt),
        "layers/b_in": P((L, f), "zeros", dtype=dt),
        "layers/w_out": P((L, f, d), dtype=dt),
        "layers/b_out": P((L, d), "zeros", dtype=dt),
    }


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device: DeviceLike = None) -> PyTree:
    """Random weights from a ``torch.Generator`` (not the reference's
    numbers: use :func:`numpy_params` to share weights with it)."""
    return common.init_params(param_defs(cfg), generator, device)


def numpy_params(cfg: ViTConfig, seed: int) -> PyTree:
    """Seeded f32 numpy weights in the reference's layout; the card and
    the golden generator build identical weights from them without JAX."""
    return common.numpy_params(param_defs(cfg), seed)


def params_from_numpy(tree: Mapping, cfg: ViTConfig,
                      device: DeviceLike = None) -> PyTree:
    """The reference's parameter tree (nested dict of numpy arrays, or of
    anything ``np.asarray`` reads, in the JAX layouts) as the port's
    parameters: tensors of ``cfg.param_dtype`` on ``device``, each checked
    against :func:`param_defs`."""
    return common.params_from_numpy(param_defs(cfg), tree, cfg.name, device)


def _interp_pos_embed(pos: torch.Tensor, n_extra: int, grid_from: int,
                      grid_to: int) -> torch.Tensor:
    """Bilinear pos-embed interpolation for resolution changes, in f32.

    ``jax.image.resize(..., "bilinear")`` samples at half-pixel centres
    with a triangle kernel, renormalised at the edges, widened when it
    shrinks (antialiasing); ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=True)`` is the same filter, enlarging
    and shrinking (``tests/test_torch_vit.py``).  Without ``antialias`` a
    shrink would differ.
    """
    if grid_from == grid_to:
        return pos
    extra, grid = pos[:n_extra], pos[n_extra:]
    d = grid.shape[-1]
    g = grid.reshape(grid_from, grid_from, d).float().permute(2, 0, 1)[None]
    g = F.interpolate(g, size=(grid_to, grid_to), mode="bilinear",
                      align_corners=False, antialias=True)
    g = g[0].permute(1, 2, 0).reshape(grid_to * grid_to, d).to(pos.dtype)
    return torch.cat([extra, g], dim=0)


def _patch_embed(images: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 patch: int) -> torch.Tensor:
    """The reference's stride-``patch`` VALID convolution (NHWC input,
    HWIO kernel) as one matmul: each patch flattened in (row, column,
    channel) order against the kernel flattened the same way.  The same
    sums as the convolution, with no layout conversion and no cuDNN."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images[:, :gh * patch, :gw * patch]
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, patch * patch * C)
    return x @ w.reshape(patch * patch * C, -1) + b


def forward(params: PyTree, images: torch.Tensor, cfg: ViTConfig
            ) -> torch.Tensor:
    """images (B, H, W, C) -> logits (B, n_classes) in f32, on the
    parameters' device; attention per ``cfg.attn_impl`` (``"pallas"``
    selects the Hopper flash-attention kernel for sequences longer than
    ``cfg.attn_chunk``)."""
    B, H, W, C = images.shape
    if H != W:
        raise ValueError(f"square images only (the pos-embed grid is "
                         f"square), got {H}x{W}")
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    n_extra = 1 + int(cfg.distill_token)
    dt = common.torch_dtype(cfg.param_dtype)

    pe = params["patch_embed"]
    x = _patch_embed(images.to(dt), pe["w"], pe["b"], cfg.patch)
    gh = H // cfg.patch
    tok = params["cls_token"][None].expand(B, n_extra, d).to(x.dtype)
    x = torch.cat([tok, x], dim=1)
    pos = _interp_pos_embed(params["pos_embed"], n_extra,
                            cfg.img_res // cfg.patch, gh)
    x = x + pos[None]
    S = x.shape[1]

    lay = params["layers"]
    for i in range(cfg.n_layers):
        y = common.layer_norm(x, lay["ln1"]["scale"][i], lay["ln1"]["bias"][i])
        q = (y @ lay["wq"][i] + lay["bq"][i]).reshape(B, S, nh, hd)
        k = (y @ lay["wk"][i] + lay["bk"][i]).reshape(B, S, nh, hd)
        v = (y @ lay["wv"][i] + lay["bv"][i]).reshape(B, S, nh, hd)
        o = attn.attention(q, k, v, causal=False, impl=cfg.attn_impl,
                           q_chunk=cfg.attn_chunk)
        x = x + o.reshape(B, S, d) @ lay["wo"][i] + lay["bo"][i]
        y2 = common.layer_norm(x, lay["ln2"]["scale"][i], lay["ln2"]["bias"][i])
        z = common.gelu(y2 @ lay["w_in"][i] + lay["b_in"][i])
        x = x + z @ lay["w_out"][i] + lay["b_out"][i]
    x = common.layer_norm(x, params["final_ln"]["scale"],
                          params["final_ln"]["bias"])
    # DeiT averages its cls and distill heads at inference; the reference
    # classifies the mean of the extra tokens for every variant
    feat = x[:, :n_extra].mean(dim=1)
    return feat.float() @ params["head"]["w"].float() \
        + params["head"]["b"].float()


def serve_step(params: PyTree, images: torch.Tensor, cfg: ViTConfig
               ) -> torch.Tensor:
    return forward(params, images, cfg)
