"""Architecture configurations (the port's copies of ``LMConfig``,
``ViTConfig``, ``ResNetConfig``, ``DiTConfig`` and ``UNetConfig`` from
``repro/configs/base.py``: the same fields, defaults and helpers; dtypes
are named by strings, as the reference's configs name them)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (dense or MoE)."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # per-expert d_ff for MoE
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0      # DeepSeek/Kimi-style shared expert(s)
    # attention flavor
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # window size for local layers
    global_every: int = 0          # every Nth layer is global (gemma3: 6)
    # MLP flavor: swiglu (llama-family) | gelu (starcoder2)
    mlp: str = "swiglu"
    # MoE weight sharding: expert (E over tp) | ffn (per-expert d_ff over tp)
    moe_shard: str = "expert"
    # MoE dispatch: global (one dispatch over all tokens) | shard_map (local
    # dispatch + all-reduce combine under a device mesh:
    # models/moe.py::moe_ffn_sharded)
    moe_impl: str = "global"
    # pad the expert dimension to this count (0 = off): makes a non-divisible
    # expert count (granite's 40) expert-shardable over a 16-way model axis;
    # the mesh's dispatch masks the padded experts, and without a mesh they
    # are routed to as real ones, as in the reference (models/moe.py)
    n_experts_pad: int = 0

    @property
    def n_experts_eff(self) -> int:
        return max(self.n_experts, self.n_experts_pad)
    # ZeRO: additionally shard weights/opt-state over the pod axis
    zero_over_pods: bool = False
    # numerics
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: bool = True
    attn_impl: str = "chunked"     # naive | chunked | pallas
    attn_chunk: int = 1024
    family: str = "lm"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def mlp_gelu(self) -> bool:
        return self.mlp == "gelu"

    def moe_shard_mode(self) -> str:
        return self.moe_shard

    def active_params(self) -> int:
        """Approximate active parameter count (per-token) for MODEL_FLOPS."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        nmat = 2 if self.mlp == "gelu" else 3
        if self.moe:
            ffn = nmat * d * self.d_ff * (self.top_k + self.n_shared_experts)
            router = d * self.n_experts
        else:
            ffn = nmat * d * self.d_ff
            router = 0
        per_layer = attn + ffn + router + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d

    def total_params(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        nmat = 2 if self.mlp == "gelu" else 3
        if self.moe:
            ffn = nmat * d * self.d_ff * (self.n_experts + self.n_shared_experts)
            router = d * self.n_experts
        else:
            ffn = nmat * d * self.d_ff
            router = 0
        per_layer = attn + ffn + router + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d


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
