"""Gradient compression: int8 quantization with a per-tensor scale and
error feedback (the port of ``repro/training/compression.py``).

On a multi-node run the quantized tensors are what would cross the slow
link (quantize -> sum int32 -> dequantize); this module is the numerics.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.models.common import tree_map

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, 0-d f32 scale): ``max|x| / 127`` (at least 1e-12 /
    127), values rounded half to even and clipped to [-127, 127]."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads: PyTree) -> PyTree:
    return tree_map(quantize_int8, grads)


def decompress_tree(cgrads: PyTree, like: PyTree) -> PyTree:
    return tree_map(lambda qs, g: dequantize_int8(qs[0], qs[1], g.dtype),
                    cgrads, like)


def roundtrip_with_feedback(grads: PyTree, residual: Optional[PyTree]
                            ) -> Tuple[PyTree, PyTree]:
    """Quantize + dequantize with error feedback; returns (grads',
    residual'), the residual f32: what this round's quantization lost is
    added to the next round's gradient."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape,
                                                  dtype=torch.float32,
                                                  device=g.device), grads)

    def one(g, r):
        total = g.float() + r
        q, s = quantize_int8(total)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), total - deq

    outs = tree_map(one, grads, residual)
    return tree_map(lambda o: o[0], outs), tree_map(lambda o: o[1], outs)
