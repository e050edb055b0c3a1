"""ViT-H/14 [arXiv:2010.11929; paper]: 32L d=1280 16H ff=5120, patch 14."""
from repro_torch.configs.base import ViTConfig

CONFIG = ViTConfig(
    name="vit-h14",
    img_res=224, patch=14, n_layers=32, d_model=1280, n_heads=16, d_ff=5120,
)

SMOKE_CONFIG = ViTConfig(
    name="vit-h14-smoke",
    img_res=28, patch=7, n_layers=2, d_model=64, n_heads=4, d_ff=128,
    n_classes=10, remat=False, attn_impl="naive",
)
