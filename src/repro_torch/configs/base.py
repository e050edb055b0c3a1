"""Architecture configurations of the vision and diffusion families (the
port's copies of ``ViTConfig``, ``ResNetConfig``, ``DiTConfig`` and
``UNetConfig`` from ``repro/configs/base.py``: the same fields, defaults
and helpers).  The language models' ``LMConfig`` waits for its models
(ROADMAP open item 8c)."""
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


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Diffusion transformer over an f8 VAE latent (patch tokens)."""
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    latent_factor: int = 8          # VAE downsample (f8)
    latent_channels: int = 4
    n_classes: int = 1000
    param_dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "chunked"
    attn_chunk: int = 512
    family: str = "dit"

    def latent_res(self, img_res: Optional[int] = None) -> int:
        return (img_res or self.img_res) // self.latent_factor

    def n_tokens(self, img_res: Optional[int] = None) -> int:
        return (self.latent_res(img_res) // self.patch) ** 2

    @property
    def d_ff(self) -> int:
        return 4 * self.d_model

    def total_params(self) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 2 * d * self.d_ff + 6 * d * d  # attn+mlp+adaLN
        return self.n_layers * per_layer


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Latent-diffusion UNet with self- and cross-attention levels."""
    name: str
    img_res: int
    latent_res: int
    ch: int = 320
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)   # levels with transformer blocks
    ctx_dim: int = 768                         # text-encoder context (stub)
    ctx_len: int = 77
    n_heads: int = 8
    latent_channels: int = 4
    param_dtype: str = "bfloat16"
    remat: bool = True
    family: str = "unet"

    def total_params(self) -> int:
        return 860_000_000  # nominal SD1.5 UNet
