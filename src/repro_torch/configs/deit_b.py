"""DeiT-B [arXiv:2012.12877; paper]: 12L d=768 12H ff=3072 + distill token."""
from repro_torch.configs.base import ViTConfig

CONFIG = ViTConfig(
    name="deit-b",
    img_res=224, patch=16, n_layers=12, d_model=768, n_heads=12, d_ff=3072,
    distill_token=True,
)

SMOKE_CONFIG = ViTConfig(
    name="deit-smoke",
    img_res=32, patch=8, n_layers=2, d_model=48, n_heads=4, d_ff=96,
    n_classes=10, distill_token=True, remat=False, attn_impl="naive",
)
