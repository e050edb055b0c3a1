"""Architecture registry: ``--arch <id>`` resolves here.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the published
configuration / the reduced same-family smoke configuration, as
``repro.configs`` does.  The port has the vision families (the vision
transformers and ResNet-50); the other architectures of the reference
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Union

from repro_torch.configs.base import ResNetConfig, ViTConfig

_MODULES: Dict[str, str] = {
    "vit-l16": "vit_l16",
    "vit-h14": "vit_h14",
    "deit-b": "deit_b",
    "resnet-50": "resnet50",
}

# the reference's other architectures, with the ROADMAP open item that
# ports each (the diffusion models and the language models, item 8)
_WAITING: Dict[str, str] = {
    "dit-xl2": "ROADMAP open item 8 (models/dit.py)",
    "unet-sd15": "ROADMAP open item 8 (models/unet.py)",
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


def get_config(arch: str) -> VisionConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> VisionConfig:
    return _module(arch).SMOKE_CONFIG


__all__ = ["ARCHS", "ResNetConfig", "ViTConfig", "VisionConfig",
           "get_config", "get_smoke_config"]
