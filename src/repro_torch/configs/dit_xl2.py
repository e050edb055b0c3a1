"""DiT-XL/2 [arXiv:2212.09748; paper].

img_res=256 (f8 latent 32), patch=2, 28L d_model=1152 16H.
"""
from repro_torch.configs.base import DiTConfig

CONFIG = DiTConfig(
    name="dit-xl2",
    img_res=256, patch=2, n_layers=28, d_model=1152, n_heads=16,
)

SMOKE_CONFIG = DiTConfig(
    name="dit-smoke",
    img_res=32, patch=2, n_layers=2, d_model=64, n_heads=4,
    remat=False, attn_impl="naive",
)
