"""Model lookup by family (the port of ``model_module`` from
``repro/launch/steps.py``; the dry-run cells, training steps and the
language models come with ROADMAP open items 8c-9)."""
from __future__ import annotations

from repro_torch.models import dit, resnet, unet, vit

_MODULES = {"vit": vit, "resnet": resnet, "dit": dit, "unet": unet}
_WAITING = {
    "lm": "ROADMAP open item 8 (models/transformer.py)",
}


def model_module(cfg):
    """The module with ``param_defs`` / ``forward`` / ``serve_step`` for
    ``cfg.family``."""
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    if cfg.family in _WAITING:
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  f"to repro_torch yet: "
                                  f"{_WAITING[cfg.family]}")
    raise ValueError(f"unknown model family {cfg.family!r}")
