"""ViT-L/16 [arXiv:2010.11929; paper]: 24L d=1024 16H ff=4096, patch 16."""
from repro_torch.configs.base import ViTConfig

CONFIG = ViTConfig(
    name="vit-l16",
    img_res=224, patch=16, n_layers=24, d_model=1024, n_heads=16, d_ff=4096,
)

SMOKE_CONFIG = ViTConfig(
    name="vit-smoke",
    img_res=32, patch=8, n_layers=2, d_model=64, n_heads=4, d_ff=128,
    n_classes=10, remat=False, attn_impl="naive",
)
