"""Operations and bytes of the work, counted from a configuration's widths
and the shapes served: the same count whatever implements the work.

A multiply-add is 2 FLOPs.  Only the matrix products count (the model
FLOPs of an MFU); norms, softmax and GELU do not.
"""
from __future__ import annotations

from perfbench import peaks


def vit_tokens(model: dict, res: int) -> int:
    """Tokens of a ``res``-pixel square frame: its whole patches and the
    class (and distillation) tokens."""
    return (res // model["patch"]) ** 2 + 1 + int(model["distill_token"])


def vit_flops(model: dict, res: int) -> int:
    """Model FLOPs of one frame through a ViT / DeiT encoder and head: the
    patch projection, per layer the q, k, v and output projections, the
    scores and their product with v, the two MLP products, and the head."""
    S = vit_tokens(model, res)
    n_extra = 1 + int(model["distill_token"])
    d, f, L = model["d_model"], model["d_ff"], model["n_layers"]
    patch = 2 * (S - n_extra) * model["patch"] ** 2 * model["in_channels"] * d
    layer = 8 * S * d * d + 4 * S * d * f + 4 * S * S * d
    return patch + L * layer + 2 * d * model["n_classes"]


def attention_flops(B: int, S: int, H: int, D: int) -> int:
    """Non-causal attention of B x H heads over S tokens: Q K^T and P V."""
    return 4 * B * H * S * S * D


def attention_bytes(B: int, S: int, H: int, D: int, elem_bytes: int) -> int:
    """q, k and v read once and the output written once."""
    return 4 * B * S * H * D * elem_bytes


def attention_min_s(B: int, S: int, H: int, D: int, elem_bytes: int) -> float:
    """The least time an H100 takes for one such launch: the larger of its
    operations at the bf16 peak and its bytes at the HBM peak."""
    return max(attention_flops(B, S, H, D) / peaks.BF16_FLOPS,
               attention_bytes(B, S, H, D, elem_bytes) / peaks.HBM_BYTES_PER_S)
