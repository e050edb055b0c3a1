"""Vision Transformer (ViT-L/16, ViT-H/14) and DeiT-B (distillation token)
— the port of ``repro/models/vit.py``.

Patch embedding is part of the model.  Pre-LN blocks, learned positional
embeddings (bilinearly interpolated for other resolutions), tanh-GELU
MLP, and a classifier on the mean of the extra tokens.  Parameters are a
nested dict of tensors in the reference's layouts (HWIO patch kernel,
``(d_in, d_out)`` projections, per-layer weights stacked on a leading L
axis), so :func:`params_from_numpy` carries one set of numpy weights into
either package.  The reference's ``shd.hint`` sharding annotations stand
where its stand (after the positional embedding and after each block):
no-ops without rules and on plain tensors, the dry run's constraints on
a mesh.  With ``cfg.remat``
each layer is recomputed in the backward under grad (the reference's
``jax.checkpoint`` on its scan body).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ViTConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed import sharding as shd
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


def param_specs(cfg: ViTConfig) -> PyTree:
    return common.param_specs(param_defs(cfg))


def param_logical(cfg: ViTConfig) -> Dict[str, Tuple]:
    """Logical sharding axes aligned with ``param_defs`` paths."""
    return {
        "patch_embed/w": (None, None, None, "tp"),
        "patch_embed/b": ("tp",),
        "cls_token": (None, None),
        "pos_embed": (None, None),
        "final_ln/scale": (None,), "final_ln/bias": (None,),
        "head/w": ("fsdp", "tp"), "head/b": ("tp",),
        "layers/ln1/scale": (None, None), "layers/ln1/bias": (None, None),
        "layers/ln2/scale": (None, None), "layers/ln2/bias": (None, None),
        "layers/wq": (None, "fsdp", "tp"),
        "layers/wk": (None, "fsdp", "tp"),
        "layers/wv": (None, "fsdp", "tp"),
        "layers/wo": (None, "tp", "fsdp"),
        "layers/bq": (None, "tp"), "layers/bk": (None, "tp"),
        "layers/bv": (None, "tp"), "layers/bo": (None, None),
        "layers/w_in": (None, "fsdp", "tp"), "layers/b_in": (None, "tp"),
        "layers/w_out": (None, "tp", "fsdp"), "layers/b_out": (None, None),
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


def _at(node, i: int):
    """Layer ``i`` of a stacked leaf, or of each leaf of a nested dict."""
    if isinstance(node, Mapping):
        return {k: _at(v, i) for k, v in node.items()}
    return node[i]


def _layer(x: torch.Tensor, lp: PyTree, cfg: ViTConfig) -> torch.Tensor:
    """One pre-LN block on x (B, S, d) with layer weights ``lp``."""
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    y = common.layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
    q = (y @ lp["wq"] + lp["bq"]).reshape(B, S, nh, hd)
    k = (y @ lp["wk"] + lp["bk"]).reshape(B, S, nh, hd)
    v = (y @ lp["wv"] + lp["bv"]).reshape(B, S, nh, hd)
    o = attn.attention(q, k, v, causal=False, impl=cfg.attn_impl,
                       q_chunk=cfg.attn_chunk)
    x = x + o.reshape(B, S, d) @ lp["wo"] + lp["bo"]
    y2 = common.layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
    z = common.gelu(y2 @ lp["w_in"] + lp["b_in"])
    return shd.hint(x + z @ lp["w_out"] + lp["b_out"], "dp", None, None)


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
    d = cfg.d_model
    n_extra = 1 + int(cfg.distill_token)
    dt = common.torch_dtype(cfg.param_dtype)

    pe = params["patch_embed"]
    x = _patch_embed(images.to(dt), pe["w"], pe["b"], cfg.patch)
    gh = H // cfg.patch
    tok = params["cls_token"][None].expand(B, n_extra, d).to(x.dtype)
    x = torch.cat([tok, x], dim=1)
    pos = _interp_pos_embed(params["pos_embed"], n_extra,
                            cfg.img_res // cfg.patch, gh)
    x = shd.hint(x + pos[None], "dp", None, None)

    lay = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: _at(v, i) for k, v in lay.items()}
        x = common.checkpointed(_layer, x, lp, cfg) if cfg.remat \
            else _layer(x, lp, cfg)
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


def loss_fn(params: PyTree, batch: Dict[str, torch.Tensor], cfg: ViTConfig):
    """(xent, {"loss", "accuracy"}) of a batch of ``images`` (B, H, W, C)
    and ``labels`` (B,)."""
    logits = forward(params, batch["images"], cfg)
    loss = common.softmax_xent(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"]).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def make_train_step(cfg: ViTConfig, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of :func:`loss_fn` and one AdamW update,
    applied in place (:func:`common.make_train_step`)."""
    return common.make_train_step(loss_fn, cfg, opt_cfg)
