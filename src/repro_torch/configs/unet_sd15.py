"""Stable Diffusion 1.5 UNet [arXiv:2112.10752; paper].

img_res=512 latent=64 ch=320 mult 1-2-4-4, 2 ResBlocks, attention (self +
cross to 77x768 text context) at the three highest-resolution levels.
"""
from repro_torch.configs.base import UNetConfig

CONFIG = UNetConfig(
    name="unet-sd15",
    img_res=512, latent_res=64, ch=320, ch_mult=(1, 2, 4, 4),
    n_res_blocks=2, attn_levels=(0, 1, 2), ctx_dim=768, n_heads=8,
)

SMOKE_CONFIG = UNetConfig(
    name="unet-smoke",
    img_res=64, latent_res=8, ch=32, ch_mult=(1, 2),
    n_res_blocks=1, attn_levels=(1,), ctx_dim=32, ctx_len=7, n_heads=2,
    remat=False,
)
