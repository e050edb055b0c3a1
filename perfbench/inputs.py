"""The inputs a cell hands to the program and to the reference alike:
weights and frames, drawn on the device from ``--seed``.

The weights are one flat buffer in the served dtype, filled by one normal
draw of a generator on the device, and cut into the leaves of the ViT
parameter tree (the layout of the published JAX ViT: HWIO patch kernel,
``(d_in, d_out)`` projections, per-layer leaves stacked on a leading
axis).  Every leaf is random, biases and norms too, so the reference
checks each of them: matrices have std ``1 / sqrt(fan_in)``, biases and
embeddings 0.02, norm scales ``1 + 0.1 N(0, 1)``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_MASK = 2 ** 63 - 1

Leaf = Tuple[str, Tuple[int, ...], str]


def vit_layout(m: dict) -> List[Leaf]:
    """(path, shape, kind) of each leaf; kind is ``matrix``, ``small`` or
    ``scale``."""
    L, d, f = m["n_layers"], m["d_model"], m["d_ff"]
    p, c = m["patch"], m["in_channels"]
    n_extra = 1 + int(m["distill_token"])
    n_tok = (m["img_res"] // p) ** 2 + n_extra
    out = [("patch_embed/w", (p, p, c, d), "matrix"),
           ("patch_embed/b", (d,), "small"),
           ("cls_token", (n_extra, d), "small"),
           ("pos_embed", (n_tok, d), "small"),
           ("final_ln/scale", (d,), "scale"),
           ("final_ln/bias", (d,), "small"),
           ("head/w", (d, m["n_classes"]), "matrix"),
           ("head/b", (m["n_classes"],), "small")]
    for ln in ("ln1", "ln2"):
        out += [(f"layers/{ln}/scale", (L, d), "scale"),
                (f"layers/{ln}/bias", (L, d), "small")]
    for w in ("wq", "wk", "wv", "wo"):
        out += [(f"layers/{w}", (L, d, d), "matrix"),
                (f"layers/b{w[1]}", (L, d), "small")]
    out += [("layers/w_in", (L, d, f), "matrix"), ("layers/b_in", (L, f), "small"),
            ("layers/w_out", (L, f, d), "matrix"), ("layers/b_out", (L, d), "small")]
    return out


def _fan_in(path: str, shape: Tuple[int, ...]) -> int:
    if path == "patch_embed/w":
        return math.prod(shape[:-1])
    return shape[-2]


def draw_weights(layout: List[Leaf], seed: int, dtype: torch.dtype,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The leaves, by path: views of one flat buffer."""
    flat = torch.empty(sum(math.prod(s) for _, s, _ in layout), dtype=dtype,
                       device=device)
    flat.normal_(generator=torch.Generator(device=device).manual_seed(
        seed & SEED_MASK))
    leaves, at = {}, 0
    for path, shape, kind in layout:
        size = math.prod(shape)
        leaf = leaves[path] = flat[at:at + size].view(shape)
        at += size
        if kind == "matrix":
            leaf.mul_(1.0 / math.sqrt(_fan_in(path, shape)))
        elif kind == "small":
            leaf.mul_(0.02)
        else:
            leaf.mul_(0.1).add_(1.0)
    return leaves


def tree(leaves: Dict[str, torch.Tensor]) -> dict:
    """The leaves as the nested dict the program's models take."""
    out: dict = {}
    for path, val in leaves.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = val
    return out


def draw_frames(n: int, res: int, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``n`` distinct f32 frames (n, res, res, 3) in [0, 1]: a colour of
    its own, a gradient of its own, and noise, so that frames differ as a
    whole and not only pixel by pixel."""
    shape = (n, 1, 1, 3)
    colour = torch.rand(shape, generator=gen, device=device)
    gx = torch.rand(shape, generator=gen, device=device) * 2 - 1
    gy = torch.rand(shape, generator=gen, device=device) * 2 - 1
    noise = torch.rand((n, res, res, 3), generator=gen, device=device)
    ramp = torch.linspace(-0.5, 0.5, res, device=device)
    x = ramp.view(1, 1, res, 1)
    y = ramp.view(1, res, 1, 1)
    img = colour + 0.5 * (gx * x + gy * y) + 0.25 * (noise - 0.5)
    return img.clamp_(0.0, 1.0).contiguous()


def frames_generator(seed: int, device: torch.device) -> torch.Generator:
    """The frames' generator: apart from the weights', from the same seed."""
    return torch.Generator(device=device).manual_seed(
        (seed ^ 0x5DEECE66D) & SEED_MASK)
