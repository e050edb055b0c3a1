"""Input-shape sets per architecture family (the port's copy of
``repro/configs/shapes.py``; pure data).

Each shape names a *step kind*:
* ``train``   — lowers ``train_step`` (forward + backward + optimizer)
* ``prefill`` — lowers ``prefill_step`` (forward, builds KV cache)
* ``decode``  — lowers ``serve_step``  (one new token against a KV cache)
* ``serve``   — lowers ``serve_step``  (pure forward)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                        # train | prefill | decode | serve
    seq_len: int = 0
    global_batch: int = 0
    img_res: int = 0
    steps: int = 0                   # diffusion sampler steps


LM_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", "train", seq_len=4_096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32_768, global_batch=32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", seq_len=32_768, global_batch=128),
    "long_500k":   ShapeSpec("long_500k", "decode", seq_len=524_288, global_batch=1),
}

DIFFUSION_SHAPES: Dict[str, ShapeSpec] = {
    "train_256":  ShapeSpec("train_256", "train", img_res=256, global_batch=256, steps=1000),
    "gen_1024":   ShapeSpec("gen_1024", "serve", img_res=1024, global_batch=4, steps=50),
    "gen_fast":   ShapeSpec("gen_fast", "serve", img_res=512, global_batch=16, steps=4),
    "train_1024": ShapeSpec("train_1024", "train", img_res=1024, global_batch=32, steps=1000),
}

VISION_SHAPES: Dict[str, ShapeSpec] = {
    "cls_224":    ShapeSpec("cls_224", "train", img_res=224, global_batch=256),
    "cls_384":    ShapeSpec("cls_384", "train", img_res=384, global_batch=64),
    "serve_b1":   ShapeSpec("serve_b1", "serve", img_res=224, global_batch=1),
    "serve_b128": ShapeSpec("serve_b128", "serve", img_res=224, global_batch=128),
}

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
    "vit": VISION_SHAPES,
    "resnet": VISION_SHAPES,
    "dit": DIFFUSION_SHAPES,
    "unet": DIFFUSION_SHAPES,
}


def shapes_for(config) -> Dict[str, ShapeSpec]:
    return FAMILY_SHAPES[config.family]


def cell_is_applicable(config, shape: ShapeSpec) -> Tuple[bool, Optional[str]]:
    """Whether (arch, shape) is a valid dry-run cell.

    ``long_500k`` needs sub-quadratic attention: only architectures with
    sliding-window (local) attention run it (gemma3); pure full-attention
    archs skip it (noted in DESIGN.md §Arch-applicability).
    """
    if config.family == "lm" and shape.name == "long_500k":
        if getattr(config, "sliding_window", None) is None:
            return False, ("pure full-attention architecture; 512k decode "
                           "requires sub-quadratic attention (DESIGN.md)")
    return True, None
