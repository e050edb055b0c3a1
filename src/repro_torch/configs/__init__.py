"""Architecture registry: ``--arch <id>`` resolves here.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the published
configuration / the reduced same-family smoke configuration, as
``repro.configs`` does, for all ten of the reference's architectures: the
language models, the diffusion family, the vision transformers and
ResNet-50.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Union

from repro_torch.configs.base import (DiTConfig, LMConfig, ResNetConfig,
                                      UNetConfig, ViTConfig)
from repro_torch.configs.shapes import (FAMILY_SHAPES, ShapeSpec,
                                        cell_is_applicable, shapes_for)

_MODULES: Dict[str, str] = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "starcoder2-7b": "starcoder2_7b",
    "gemma3-27b": "gemma3_27b",
    "dit-xl2": "dit_xl2",
    "unet-sd15": "unet_sd15",
    "vit-l16": "vit_l16",
    "vit-h14": "vit_h14",
    "deit-b": "deit_b",
    "resnet-50": "resnet50",
}

ARCHS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; options: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


VisionConfig = Union[ViTConfig, ResNetConfig]
ArchConfig = Union[LMConfig, ViTConfig, ResNetConfig, DiTConfig, UNetConfig]


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE_CONFIG


def all_cells():
    """Every applicable (arch, shape) dry-run cell + skip notes."""
    cells, skips = [], []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in shapes_for(cfg).items():
            ok, why = cell_is_applicable(cfg, shape)
            if ok:
                cells.append((arch, sname))
            else:
                skips.append((arch, sname, why))
    return cells, skips


__all__ = ["ARCHS", "ArchConfig", "DiTConfig", "FAMILY_SHAPES", "LMConfig",
           "ResNetConfig", "ShapeSpec", "UNetConfig", "ViTConfig",
           "VisionConfig", "all_cells", "cell_is_applicable", "get_config",
           "get_smoke_config", "shapes_for"]
