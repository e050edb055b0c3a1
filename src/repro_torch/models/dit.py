"""DiT-XL/2 (Peebles & Xie, arXiv:2212.09748): the latent diffusion
transformer — the port of ``repro/models/dit.py``.

adaLN-Zero conditioning on (timestep, class); patch-2 tokens of the f8
VAE latent (the VAE is a stub: inputs are latents).  ``serve_step`` is one
denoising step's network evaluation; a k-step sampler runs it k times.
Parameters are a nested dict of tensors in the reference's layouts (HWIO
patch kernel, ``(d_in, d_out)`` projections, per-layer weights stacked on a
leading L axis), so :func:`params_from_numpy` carries one set of numpy
weights into either package.  The reference's ``shd.hint`` annotations
stand where its stand (after the positional embedding and after each
block): no-ops without rules and on plain tensors, the dry run's
constraints on a mesh.  ``loss_fn`` /
``make_train_step`` train it as the reference does: ``t`` and ``eps`` are
JAX's threefry draws, bit for bit (``models.diffusion``), and with ``cfg.remat`` each layer is recomputed in the
backward (the reference's ``jax.checkpoint`` on its scan body; a no-op
without grad, so the serve step is unchanged).

With ``attn_impl="pallas"`` a sequence longer than ``attn_chunk`` (512)
takes the hand-written flash-attention kernel: DiT-XL/2's heads are 1152 /
16 = 72 wide, the kernel's ``tma_wgmma`` variant at D = 72, at 512 px
(1,024 tokens) and 1024 px (4,096 tokens).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DiTConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import common, diffusion, vit

PyTree = Any


def param_defs(cfg: DiTConfig) -> Dict[str, common.ParamDef]:
    L, d = cfg.n_layers, cfg.d_model
    f = cfg.d_ff
    p, c = cfg.patch, cfg.latent_channels
    dt = cfg.param_dtype
    n_tok = cfg.n_tokens()
    P = common.ParamDef
    return {
        "patch_embed/w": P((p, p, c, d), dtype=dt),
        "patch_embed/b": P((d,), "zeros", dtype=dt),
        "pos_embed": P((n_tok, d), scale=0.02, dtype=dt),
        "t_mlp/w1": P((256, d), dtype=dt),
        "t_mlp/b1": P((d,), "zeros", dtype=dt),
        "t_mlp/w2": P((d, d), dtype=dt),
        "t_mlp/b2": P((d,), "zeros", dtype=dt),
        # the reference's "embed" init draws a normal as "normal" does
        "y_embed": P((cfg.n_classes + 1, d), dtype=dt),
        "layers/adaln": P((L, d, 6 * d), "zeros", dtype=dt),
        "layers/adaln_b": P((L, 6 * d), "zeros", dtype=dt),
        "layers/wq": P((L, d, d), dtype=dt),
        "layers/wk": P((L, d, d), dtype=dt),
        "layers/wv": P((L, d, d), dtype=dt),
        "layers/wo": P((L, d, d), dtype=dt),
        "layers/w_in": P((L, d, f), dtype=dt),
        "layers/b_in": P((L, f), "zeros", dtype=dt),
        "layers/w_out": P((L, f, d), dtype=dt),
        "layers/b_out": P((L, d), "zeros", dtype=dt),
        "final/adaln": P((d, 2 * d), "zeros", dtype=dt),
        "final/adaln_b": P((2 * d,), "zeros", dtype=dt),
        "final/w": P((d, p * p * 2 * c), "zeros", dtype=dt),
        "final/b": P((p * p * 2 * c,), "zeros", dtype=dt),
    }


def param_specs(cfg: DiTConfig) -> PyTree:
    return common.param_specs(param_defs(cfg))


def param_logical(cfg: DiTConfig) -> Dict[str, Tuple]:
    """Logical sharding axes aligned with ``param_defs`` paths."""
    log = {}
    for path, d in param_defs(cfg).items():
        if path.startswith("layers/"):
            if path.endswith(("_b", "b_in", "b_out")):
                log[path] = (None, "tp") if path.endswith(
                    ("adaln_b", "b_in")) else (None, None)
            elif path in ("layers/wo", "layers/w_out"):
                log[path] = (None, "tp", "fsdp")
            else:
                log[path] = (None, "fsdp", "tp")
        elif len(d.shape) == 2:
            log[path] = ("fsdp", "tp") if d.shape[0] >= 256 else (None, None)
        else:
            log[path] = tuple(None for _ in d.shape)
    return log


def init_params(cfg: DiTConfig, generator: torch.Generator,
                device: DeviceLike = None) -> PyTree:
    """Random weights from a ``torch.Generator`` (not the reference's
    numbers: use :func:`numpy_params` to share weights with it)."""
    return common.init_params(param_defs(cfg), generator, device)


def numpy_params(cfg: DiTConfig, seed: int,
                 constant_std: Optional[float] = None) -> PyTree:
    """Seeded f32 numpy weights in the reference's layout; with
    ``constant_std`` every leaf random (``common.numpy_params``: adaLN-Zero
    leaves the output 0 for every input otherwise)."""
    return common.numpy_params(param_defs(cfg), seed, constant_std)


def params_from_numpy(tree: Mapping, cfg: DiTConfig,
                      device: DeviceLike = None) -> PyTree:
    """The reference's parameter tree (nested dict of numpy arrays, or of
    anything ``np.asarray`` reads, in the JAX layouts) as tensors of
    ``cfg.param_dtype`` on ``device`` (``None``: CUDA), each checked
    against :func:`param_defs`."""
    return common.params_from_numpy(param_defs(cfg), tree, cfg.name, device)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
              ) -> torch.Tensor:
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine, eps 1e-6, in f32 (population variance),
    cast back to ``x``'s dtype."""
    x32 = x.float()
    var, mu = torch.var_mean(x32, dim=-1, correction=0, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _unpatchify(out: torch.Tensor, gh: int, p: int) -> torch.Tensor:
    """(B, gh * gh, p * p * C2) tokens -> (B, gh * p, gh * p, C2): each
    token's p x p patch back in its place (the reference's reshape to
    (B, gh, gh, p, p, C2) and transpose of the middle axes)."""
    B, c2 = out.shape[0], out.shape[-1] // (p * p)
    out = out.reshape(B, gh, gh, p, p, c2).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, gh * p, gh * p, c2)


def _layer(x: torch.Tensor, lp: Dict[str, torch.Tensor],
           cvec: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """One DiT block (adaLN-Zero attention, then MLP) on x (B, S, d); the
    reference's scan body."""
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    mod = cvec @ lp["adaln"] + lp["adaln_b"]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    yx = _modulate(_ln(x), sh1, sc1)
    q = (yx @ lp["wq"]).reshape(B, S, nh, hd)
    k = (yx @ lp["wk"]).reshape(B, S, nh, hd)
    v = (yx @ lp["wv"]).reshape(B, S, nh, hd)
    o = attn.attention(q, k, v, causal=False, impl=cfg.attn_impl,
                       q_chunk=cfg.attn_chunk)
    x = x + g1[:, None, :] * (o.reshape(B, S, d) @ lp["wo"])
    yx2 = _modulate(_ln(x), sh2, sc2)
    z = common.gelu(yx2 @ lp["w_in"] + lp["b_in"])
    return shd.hint(x + g2[:, None, :] * (z @ lp["w_out"] + lp["b_out"]),
                    "dp", None, None)


def forward(params: PyTree, latents: torch.Tensor, t: torch.Tensor,
            y: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """latents (B, H, W, C), t (B,), y (B,) class labels (``n_classes``
    is the dropped label) -> epsilon and sigma (B, H, W, 2C) in
    ``cfg.param_dtype``, on the parameters' device."""
    B, Hh, Ww, C = latents.shape
    if Hh != Ww:
        raise ValueError(f"square latents only (the pos-embed grid is "
                         f"square), got {Hh}x{Ww}")
    p = cfg.patch
    gh = Hh // p
    dt = common.torch_dtype(cfg.param_dtype)

    pe = params["patch_embed"]
    x = vit._patch_embed(latents.to(dt), pe["w"], pe["b"], p)
    g0 = int(params["pos_embed"].shape[0] ** 0.5)
    x = shd.hint(x + vit._interp_pos_embed(params["pos_embed"], 0, g0,
                                           gh)[None], "dp", None, None)

    temb = common.timestep_embedding(t, 256).to(dt)
    tm = params["t_mlp"]
    cvec = F.silu(temb @ tm["w1"] + tm["b1"])
    cvec = cvec @ tm["w2"] + tm["b2"]
    cvec = F.silu(cvec + common.embedding(params["y_embed"], y))

    lay = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: w[i] for k, w in lay.items()}
        x = common.checkpointed(_layer, x, lp, cvec, cfg) if cfg.remat \
            else _layer(x, lp, cvec, cfg)

    fin = params["final"]
    sh, sc = (cvec @ fin["adaln"] + fin["adaln_b"]).chunk(2, dim=-1)
    x = _modulate(_ln(x), sh, sc)
    return _unpatchify(x @ fin["w"] + fin["b"], gh, p)


def serve_step(params: PyTree, latents: torch.Tensor, t: torch.Tensor,
               y: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """One DDIM/DDPM denoising step's network evaluation."""
    return forward(params, latents, t, y, cfg)


def loss_fn(params: PyTree, batch: Dict[str, Any], cfg: DiTConfig):
    """Epsilon-prediction MSE of a batch of ``latents`` (B, H, W, C) f32,
    ``labels`` (B,) and ``step`` (a host int): ``(loss, {"loss"})``, the
    prediction the first C output channels in f32."""
    t, eps, noised = diffusion.noised_latents(batch)
    out = forward(params, noised, t, batch["labels"], cfg)
    pred_eps = out[..., :cfg.latent_channels].float()
    loss = torch.mean(torch.square(pred_eps - eps))
    return loss, {"loss": loss}


def make_train_step(cfg: DiTConfig, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of :func:`loss_fn` and one AdamW update,
    applied in place (:func:`common.make_train_step`)."""
    return common.make_train_step(loss_fn, cfg, opt_cfg)
