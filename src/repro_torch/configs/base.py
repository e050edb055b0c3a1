"""Architecture configurations of the vision families (the port's copies
of ``ViTConfig`` and ``ResNetConfig`` from ``repro/configs/base.py``: the
same fields, defaults and helpers).  The other families' configs wait
for their models (ROADMAP open item 8)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Vision transformer (ViT / DeiT) encoder."""
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    distill_token: bool = False     # DeiT
    in_channels: int = 3
    param_dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "chunked"
    attn_chunk: int = 512
    family: str = "vit"

    def n_tokens(self, img_res: Optional[int] = None) -> int:
        r = img_res or self.img_res
        return (r // self.patch) ** 2 + 1 + int(self.distill_token)

    def total_params(self) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 4 * d
        patch_embed = self.in_channels * self.patch ** 2 * d
        return self.n_layers * per_layer + patch_embed + d * self.n_classes


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """ResNet (bottleneck v1.5).  Unlike ``ViTConfig`` it has no
    ``n_tokens``: the network is convolutional at any image side."""
    name: str
    img_res: int
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    n_classes: int = 1000
    in_channels: int = 3
    param_dtype: str = "bfloat16"
    family: str = "resnet"

    def total_params(self) -> int:
        return 25_600_000   # nominal ResNet-50
