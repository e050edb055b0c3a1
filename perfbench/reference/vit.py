"""Plain ViT / DeiT forward in float32: the reference the served labels are
judged by.

The encoder of the published ViT (arXiv:2010.11929) as the benchmark's
weights lay it out (:func:`perfbench.inputs.vit_layout`): the stride-p
patch projection, the class (and, for DeiT, distillation) tokens, learned
positions resized bilinearly to the frame's grid, pre-LN blocks
(LayerNorm eps 1e-6, non-causal softmax attention, a tanh-GELU MLP), a
final LayerNorm, and the head on the mean of the extra tokens.  Every
product is float32 with TF32 off.

``quant`` rounds both operands of every product (the control computes
the same forward with them in fp8).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def exact_f32() -> None:
    """Products in float32 proper: no TF32 for cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resize_matrix(n_from: int, n_to: int) -> torch.Tensor:
    """(n_to, n_from) weights of a bilinear resize with half-pixel centres:
    a triangle kernel, widened by the factor when shrinking, its weights
    renormalised where it falls off the edge."""
    scale = n_to / n_from
    width = max(1.0, 1.0 / scale)
    w = torch.zeros(n_to, n_from, dtype=torch.float64)
    for i in range(n_to):
        centre = (i + 0.5) / scale - 0.5
        for j in range(n_from):
            w[i, j] = max(0.0, 1.0 - abs(j - centre) / width)
        w[i] /= w[i].sum()
    return w


def positions(pos: torch.Tensor, n_extra: int, grid_from: int,
              grid_to: int) -> torch.Tensor:
    if grid_from == grid_to:
        return pos
    r = resize_matrix(grid_from, grid_to).to(pos)
    g = pos[n_extra:].reshape(grid_from, grid_from, -1)
    g = torch.einsum("ai,ijd,bj->abd", r, g, r).reshape(grid_to * grid_to, -1)
    return torch.cat([pos[:n_extra], g])


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * scale + bias


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def forward(w: Dict[str, torch.Tensor], images: torch.Tensor, m: dict,
            quant: Quant = None) -> torch.Tensor:
    """images (B, H, W, 3) f32 -> logits (B, n_classes) f32; ``w`` maps each
    leaf's path to a float32 tensor."""
    q = quant or (lambda t: t)

    def mm(a, b):
        return q(a) @ q(b)

    B, H, W, C = images.shape
    p, d, nh = m["patch"], m["d_model"], m["n_heads"]
    hd = d // nh
    n_extra = 1 + int(m["distill_token"])
    g = H // p
    x = images[:, :g * p, :g * p].reshape(B, g, p, g, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * C)
    x = mm(x, w["patch_embed/w"].reshape(p * p * C, d)) + w["patch_embed/b"]
    x = torch.cat([w["cls_token"].expand(B, n_extra, d), x], dim=1)
    x = x + positions(w["pos_embed"], n_extra, m["img_res"] // p, g)
    S = x.shape[1]
    for i in range(m["n_layers"]):
        def lw(name):
            return w[f"layers/{name}"][i]
        y = layer_norm(x, lw("ln1/scale"), lw("ln1/bias"))
        qh, kh, vh = ((mm(y, lw(f"w{c}")) + lw(f"b{c}")).reshape(B, S, nh, hd)
                      for c in "qkv")
        s = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh)) / math.sqrt(hd)
        a = torch.einsum("bhqk,bkhd->bqhd", q(torch.softmax(s, dim=-1)), q(vh))
        x = x + mm(a.reshape(B, S, d), lw("wo")) + lw("bo")
        y = layer_norm(x, lw("ln2/scale"), lw("ln2/bias"))
        x = x + mm(gelu_tanh(mm(y, lw("w_in")) + lw("b_in")), lw("w_out")) \
            + lw("b_out")
    x = layer_norm(x, w["final_ln/scale"], w["final_ln/bias"])
    return mm(x[:, :n_extra].mean(dim=1), w["head/w"]) + w["head/b"]


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude at e4m3's largest, 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def logits(leaves: Dict[str, torch.Tensor], images: torch.Tensor, m: dict,
           quant: Quant = None, block: int = 8) -> torch.Tensor:
    """The reference's logits of every frame, ``block`` frames at a time,
    from the shared weights taken to float32."""
    exact_f32()
    w = {k: v.float() for k, v in leaves.items()}
    with torch.no_grad():
        out = [forward(w, images[i:i + block].float(), m, quant)
               for i in range(0, images.shape[0], block)]
    return torch.cat(out)
