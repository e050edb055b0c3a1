"""Architecture registry: ``--arch <id>`` resolves here.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the published
configuration / the reduced same-family smoke configuration, as
``repro.configs`` does.  The port has the vision families (the vision
transformers and ResNet-50) and the diffusion family (DiT-XL/2, the SD 1.5
UNet); the language models of the reference raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Union

from repro_torch.configs.base import (DiTConfig, ResNetConfig, UNetConfig,
                                      ViTConfig)
from repro_torch.configs.shapes import (FAMILY_SHAPES, ShapeSpec,
                                        cell_is_applicable, shapes_for)

_MODULES: Dict[str, str] = {
    "vit-l16": "vit_l16",
    "vit-h14": "vit_h14",
    "deit-b": "deit_b",
    "resnet-50": "resnet50",
    "dit-xl2": "dit_xl2",
    "unet-sd15": "unet_sd15",
}

# the reference's other architectures, with the ROADMAP open item that
# ports each (the language models, item 8)
_WAITING: Dict[str, str] = {
    "kimi-k2-1t-a32b": "ROADMAP open item 8 (models/transformer.py, moe.py)",
    "granite-moe-3b-a800m": "ROADMAP open item 8 (models/transformer.py, moe.py)",
    "starcoder2-7b": "ROADMAP open item 8 (models/transformer.py)",
    "gemma3-27b": "ROADMAP open item 8 (models/transformer.py)",
}

ARCHS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch in _WAITING:
        raise NotImplementedError(
            f"{arch!r} is not ported to repro_torch yet: {_WAITING[arch]}")
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; options: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


VisionConfig = Union[ViTConfig, ResNetConfig]
ArchConfig = Union[ViTConfig, ResNetConfig, DiTConfig, UNetConfig]


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE_CONFIG


__all__ = ["ARCHS", "ArchConfig", "DiTConfig", "FAMILY_SHAPES",
           "ResNetConfig", "ShapeSpec", "UNetConfig", "ViTConfig",
           "VisionConfig", "cell_is_applicable", "get_config",
           "get_smoke_config", "shapes_for"]
