"""ResNet-50 [arXiv:1512.03385; paper]: depths 3-4-6-3, width 64, bottleneck."""
from repro_torch.configs.base import ResNetConfig

CONFIG = ResNetConfig(
    name="resnet-50",
    img_res=224, depths=(3, 4, 6, 3), width=64,
)

SMOKE_CONFIG = ResNetConfig(
    name="resnet-smoke",
    img_res=32, depths=(1, 1), width=16, n_classes=10,
)
