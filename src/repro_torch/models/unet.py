"""SD 1.5 UNet (arXiv:2112.10752): the latent-space epsilon predictor — the
port of ``repro/models/unet.py``.

ch=320, mult (1,2,4,4), 2 ResBlocks a level, a transformer block (self-
and cross-attention to a 77 x 768 text-context stub) after each ResBlock
at levels 0-2, the timestep embedding, skip connections.  The reference's
layouts at the edges (latents (B, h, w, 4), HWIO kernels in numpy trees);
inside, activations are NHWC tensors and each convolution runs on their
NCHW view, which is ``channels_last`` memory, against kernels kept OIHW
``channels_last`` (``resnet.to_port_layout``, applied once by
:func:`params_from_numpy`), so no layer converts a layout.  SAME padding is
XLA's (``resnet.same_pads``: (0, 1) for the stride-2 downsample on an even
side); the 2x ``"nearest"`` upsample repeats each pixel (index ``i // 2``);
norms are f32 (``common.group_norm``, ``common.layer_norm``) with f32
scales and biases beside bf16 kernels, as the reference's ``param_defs``
types them.  Self-attention is the reference's hard-coded ``chunked``
(q_chunk 1024) and cross-attention its naive path: no kernel is on this
model's path.  ``shd.hint`` stands after each level, as the reference's
(a no-op without rules and on plain tensors), and ``cfg.remat`` is not read,
as the reference reads it nowhere.  ``loss_fn`` / ``make_train_step``
train it on the reference's noise (``diffusion.noised_latents``: JAX's
threefry ``t`` and ``eps``, bit for bit); the backward's f32 convolutions
stay f32 (``common.value_and_grad`` runs it under ``exact_f32``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import UNetConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import common, diffusion, resnet

PyTree = Any


def _levels(cfg: UNetConfig) -> List[int]:
    return [cfg.ch * m for m in cfg.ch_mult]


def param_defs(cfg: UNetConfig) -> Dict[str, common.ParamDef]:
    dt = cfg.param_dtype
    ch = cfg.ch
    temb_d = ch * 4
    P = common.ParamDef

    def conv(k, cin, cout, init="normal"):
        return P((k, k, cin, cout), init, dtype=dt)

    def norm(base, c):
        defs[f"{base}/scale"] = P((c,), "ones", dtype="float32")
        defs[f"{base}/bias"] = P((c,), "zeros", dtype="float32")

    defs: Dict[str, common.ParamDef] = {
        "t_mlp/w1": P((ch, temb_d), dtype=dt),
        "t_mlp/b1": P((temb_d,), "zeros", dtype=dt),
        "t_mlp/w2": P((temb_d, temb_d), dtype=dt),
        "t_mlp/b2": P((temb_d,), "zeros", dtype=dt),
        "conv_in": conv(3, cfg.latent_channels, ch),
        "conv_out": conv(3, ch, cfg.latent_channels, "zeros"),
    }
    norm("norm_out", ch)

    def res_block(base, cin, cout):
        norm(f"{base}/n1", cin)
        defs[f"{base}/c1"] = conv(3, cin, cout)
        defs[f"{base}/temb_w"] = P((temb_d, cout), dtype=dt)
        defs[f"{base}/temb_b"] = P((cout,), "zeros", dtype=dt)
        norm(f"{base}/n2", cout)
        defs[f"{base}/c2"] = conv(3, cout, cout, "zeros")
        if cin != cout:
            defs[f"{base}/skip"] = conv(1, cin, cout)

    def attn_block(base, c):
        norm(f"{base}/norm", c)
        for nm, shp in (("wq", (c, c)), ("wk", (c, c)), ("wv", (c, c)),
                        ("wo", (c, c)),
                        ("cq", (c, c)), ("ck", (cfg.ctx_dim, c)),
                        ("cv", (cfg.ctx_dim, c)), ("co", (c, c)),
                        ("ff1", (c, 4 * c)), ("ff2", (4 * c, c))):
            defs[f"{base}/{nm}"] = P(shp, dtype=dt)
        for ln in ("ln1", "ln2", "ln3"):
            norm(f"{base}/{ln}", c)

    chans = _levels(cfg)
    cin = cfg.ch
    for li, c in enumerate(chans):                      # encoder
        for bi in range(cfg.n_res_blocks):
            res_block(f"down{li}/res{bi}", cin, c)
            cin = c
            if li in cfg.attn_levels:
                attn_block(f"down{li}/attn{bi}", c)
        if li < len(chans) - 1:
            defs[f"down{li}/downsample"] = conv(3, c, c)
    res_block("mid/res0", chans[-1], chans[-1])         # middle
    attn_block("mid/attn", chans[-1])
    res_block("mid/res1", chans[-1], chans[-1])
    skip_c = _skip_channels(cfg)
    for li in reversed(range(len(chans))):              # decoder: skip concat
        c = chans[li]
        for bi in range(cfg.n_res_blocks + 1):
            res_block(f"up{li}/res{bi}", cin + skip_c[li][bi], c)
            cin = c
            if li in cfg.attn_levels:
                attn_block(f"up{li}/attn{bi}", c)
        if li > 0:
            defs[f"up{li}/upsample"] = conv(3, c, c)
    return defs


def param_specs(cfg: UNetConfig) -> PyTree:
    return common.param_specs(param_defs(cfg))


def param_logical(cfg: UNetConfig) -> Dict[str, Tuple]:
    """Logical sharding axes aligned with ``param_defs`` paths (the
    reference's HWIO kernels: a checkpoint's layout)."""
    log = {}
    for path, d in param_defs(cfg).items():
        if len(d.shape) == 4:       # conv: shard output channels
            log[path] = (None, None, None, "tp")
        elif len(d.shape) == 2:     # dense: shard columns
            log[path] = ("fsdp", "tp") if d.shape[0] >= 512 else (None, "tp")
        else:
            log[path] = tuple(None for _ in d.shape)
    return log


def _pop_skips(skips: list, n: int) -> list:
    """The decoder level's ``n`` skip tensors, in the order its ResBlocks
    consume them: popped from the end of the encoder's stack (the last
    pushed first)."""
    return [skips.pop() for _ in range(n)]


def _skip_channels(cfg: UNetConfig) -> Dict[int, List[int]]:
    """Channel count of each skip tensor consumed by the decoder."""
    chans = _levels(cfg)
    stack: List[int] = [cfg.ch]                      # conv_in output
    for li, c in enumerate(chans):
        stack += [c] * cfg.n_res_blocks
        if li < len(chans) - 1:
            stack.append(c)                          # downsample output
    return {li: _pop_skips(stack, cfg.n_res_blocks + 1)
            for li in reversed(range(len(chans)))}


def numpy_params(cfg: UNetConfig, seed: int,
                 constant_std: Optional[float] = None) -> PyTree:
    """Seeded f32 numpy weights in the reference's layout (HWIO); with
    ``constant_std`` every leaf random (``common.numpy_params``: the
    zero-initialised ``c2`` and ``conv_out`` leave the output 0 for every
    input otherwise)."""
    return common.numpy_params(param_defs(cfg), seed, constant_std)


def params_from_numpy(tree: Mapping, cfg: UNetConfig,
                      device: DeviceLike = None) -> PyTree:
    """The reference's parameter tree (nested dict of numpy arrays, or of
    anything ``np.asarray`` reads, HWIO kernels) as the port's parameters:
    each checked against :func:`param_defs` and cast to its def's dtype
    (norms f32, the rest ``cfg.param_dtype``), the kernels in the port's
    layout, on ``device`` (``None``: CUDA)."""
    return common.params_from_numpy(param_defs(cfg), tree, cfg.name, device,
                                    layout=resnet.to_port_layout)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of an NHWC tensor (through its channels_last NCHW
    view) with a kernel in the port's layout; NHWC out."""
    return resnet._conv(x.permute(0, 3, 1, 2), w, stride).permute(0, 2, 3, 1)


def _res_block(x: torch.Tensor, p: PyTree, temb: torch.Tensor
               ) -> torch.Tensor:
    h = common.group_norm(x, p["n1"]["scale"], p["n1"]["bias"])
    h = _conv(common.silu32(h), p["c1"])
    h = h + (common.silu32(temb) @ p["temb_w"]
             + p["temb_b"])[:, None, None, :]
    h = common.group_norm(h, p["n2"]["scale"], p["n2"]["bias"])
    h = _conv(common.silu32(h), p["c2"])
    skip = _conv(x, p["skip"]) if "skip" in p else x
    return h + skip


def _attn_block(x: torch.Tensor, p: PyTree, ctx: torch.Tensor,
                n_heads: int) -> torch.Tensor:
    B, H, W, C = x.shape
    hd = C // n_heads
    h = common.group_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    h = h.reshape(B, H * W, C)
    # self-attention
    y = common.layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
    q = (y @ p["wq"]).reshape(B, -1, n_heads, hd)
    k = (y @ p["wk"]).reshape(B, -1, n_heads, hd)
    v = (y @ p["wv"]).reshape(B, -1, n_heads, hd)
    o = attn.attention(q, k, v, causal=False, impl="chunked", q_chunk=1024)
    h = h + o.reshape(B, -1, C) @ p["wo"]
    # cross-attention to the text context
    y = common.layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
    q = (y @ p["cq"]).reshape(B, -1, n_heads, hd)
    k = (ctx @ p["ck"]).reshape(B, -1, n_heads, hd)
    v = (ctx @ p["cv"]).reshape(B, -1, n_heads, hd)
    o = attn.attention_naive(q, k, v, causal=False)
    h = h + o.reshape(B, -1, C) @ p["co"]
    # feed-forward
    y = common.layer_norm(h, p["ln3"]["scale"], p["ln3"]["bias"])
    h = h + common.gelu(y @ p["ff1"]) @ p["ff2"]
    return x + h.reshape(B, H, W, C)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """2x nearest (``jax.image.resize(..., "nearest")``: output pixel i
    reads input pixel i // 2), NHWC."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                         mode="nearest").permute(0, 2, 3, 1)


def forward(params: PyTree, latents: torch.Tensor, t: torch.Tensor,
            ctx: torch.Tensor, cfg: UNetConfig) -> torch.Tensor:
    """latents (B, h, w, 4), t (B,), ctx (B, ctx_len, ctx_dim) -> epsilon
    (B, h, w, 4) in ``cfg.param_dtype``, on the parameters' device."""
    dt = common.torch_dtype(cfg.param_dtype)
    with resnet._exact_f32(dt):
        x = latents.to(dt)
        ctx = ctx.to(dt)
        tm = params["t_mlp"]
        temb = common.timestep_embedding(t, cfg.ch).to(dt)
        temb = common.silu32(temb @ tm["w1"] + tm["b1"])
        temb = temb @ tm["w2"] + tm["b2"]

        chans = _levels(cfg)
        x = _conv(x, params["conv_in"])
        skips = [x]
        for li in range(len(chans)):
            lvl = params[f"down{li}"]
            for bi in range(cfg.n_res_blocks):
                x = _res_block(x, lvl[f"res{bi}"], temb)
                if li in cfg.attn_levels:
                    x = _attn_block(x, lvl[f"attn{bi}"], ctx, cfg.n_heads)
                skips.append(x)
            if li < len(chans) - 1:
                x = _conv(x, lvl["downsample"], stride=2)
                skips.append(x)
            x = shd.hint(x, "dp", "sp", None, "tp")

        mid = params["mid"]
        x = _res_block(x, mid["res0"], temb)
        x = _attn_block(x, mid["attn"], ctx, cfg.n_heads)
        x = _res_block(x, mid["res1"], temb)

        for li in reversed(range(len(chans))):
            lvl = params[f"up{li}"]
            level_skips = _pop_skips(skips, cfg.n_res_blocks + 1)
            for bi, skip in enumerate(level_skips):
                x = _res_block(torch.cat([x, skip], dim=-1),
                               lvl[f"res{bi}"], temb)
                if li in cfg.attn_levels:
                    x = _attn_block(x, lvl[f"attn{bi}"], ctx, cfg.n_heads)
            if li > 0:
                x = _conv(_upsample(x), lvl["upsample"])
            x = shd.hint(x, "dp", "sp", None, "tp")

        x = common.group_norm(x, params["norm_out"]["scale"],
                              params["norm_out"]["bias"])
        return _conv(common.silu32(x), params["conv_out"])


def serve_step(params: PyTree, latents: torch.Tensor, t: torch.Tensor,
               ctx: torch.Tensor, cfg: UNetConfig) -> torch.Tensor:
    """One denoising step's network evaluation."""
    return forward(params, latents, t, ctx, cfg)


def loss_fn(params: PyTree, batch: Dict[str, Any], cfg: UNetConfig):
    """Epsilon-prediction MSE of a batch of ``latents`` (B, h, w, 4) f32,
    ``ctx`` (B, ctx_len, ctx_dim) and ``step`` (a host int), on the
    reference's noise: ``(loss, {"loss"})``."""
    t, eps, noised = diffusion.noised_latents(batch)
    pred = forward(params, noised, t, batch["ctx"], cfg).float()
    loss = torch.mean(torch.square(pred - eps))
    return loss, {"loss": loss}


def make_train_step(cfg: UNetConfig, opt_cfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of :func:`loss_fn` and one AdamW update,
    applied in place (:func:`common.make_train_step`)."""
    return common.make_train_step(loss_fn, cfg, opt_cfg)
