"""Model lookup by family (the port of ``model_module`` from
``repro/launch/steps.py``; the dry-run cells and training steps come with
ROADMAP open items 9-10)."""
from __future__ import annotations

from repro_torch.models import dit, resnet, transformer, unet, vit

_MODULES = {"lm": transformer, "vit": vit, "resnet": resnet, "dit": dit,
            "unet": unet}


def model_module(cfg):
    """The module with ``param_defs`` and the steps for ``cfg.family``
    (``forward`` / ``serve_step`` for the vision and diffusion families;
    ``prefill`` / ``decode_step`` for the language models)."""
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    raise ValueError(f"unknown model family {cfg.family!r}")
