"""Cell builder: (architecture config x shape) -> step function, the
shapes of its arguments and a factory of real ones (the port of
``repro/launch/steps.py``).

One place defines, for every (arch, shape) cell: the step callable
(train / prefill / decode / serve), the argument specs (a ``Spec``, shape
and dtype, where the reference has ``ShapeDtypeStruct``s) and a
real-input factory for the drivers and the tests.  Used by
``launch/train.py`` and the train loop.  The reference's logical sharding
trees (``arg_logical``) and its dry-run wait for the distribution work
(ROADMAP open item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, shapes_for
from repro_torch.configs.base import DiTConfig, LMConfig, UNetConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common, dit, resnet, transformer, unet, vit
from repro_torch.training.data import Spec, SyntheticSource
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

PyTree = Any

_MODULES = {"lm": transformer, "vit": vit, "resnet": resnet, "dit": dit,
            "unet": unet}


def model_module(cfg):
    """The module with ``param_defs`` and the steps for ``cfg.family``
    (``forward`` / ``serve_step`` / ``loss_fn`` / ``make_train_step`` for
    the vision and diffusion families; ``prefill`` / ``decode_step`` and
    the train step for the language models)."""
    if cfg.family in _MODULES:
        return _MODULES[cfg.family]
    raise ValueError(f"unknown model family {cfg.family!r}")


def opt_cfg_for(cfg) -> AdamWConfig:
    return AdamWConfig(state_dtype=getattr(cfg, "opt_state_dtype",
                                           "float32"))


def _identity(tree: PyTree) -> PyTree:
    return tree


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: Any
    step_fn: Callable
    arg_specs: Tuple             # param_defs, then the other args' Specs
    make_args: Callable          # (seed, device) -> real args
    donate: Tuple[int, ...] = ()
    # a train cell's parameter tree as checkpoints hold it (the reference's
    # layouts) and back; the identity but for ResNet's kernels
    to_saved: Callable = _identity
    from_saved: Callable = _identity

    @property
    def label(self) -> str:
        return f"{self.arch}:{self.shape.name}"


# ---------------------------------------------------------------------------
# Family-specific batch builders
# ---------------------------------------------------------------------------
def _lm_batch_specs(cfg: LMConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": Spec((B, S), np.int32),
            "labels": Spec((B, S), np.int32)}


def _vision_batch_specs(cfg, shape: ShapeSpec) -> Dict[str, Spec]:
    B, r = shape.global_batch, shape.img_res
    return {"images": Spec((B, r, r, 3), np.float32),
            "labels": Spec((B,), np.int32)}


def _dit_batch_specs(cfg: DiTConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    B = shape.global_batch
    lr = cfg.latent_res(shape.img_res)
    return {"latents": Spec((B, lr, lr, cfg.latent_channels), np.float32),
            "labels": Spec((B,), np.int32),
            "step": Spec((), np.int32)}


def _unet_batch_specs(cfg: UNetConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    B = shape.global_batch
    lr = shape.img_res // 8 if shape.img_res else cfg.latent_res
    return {"latents": Spec((B, lr, lr, cfg.latent_channels), np.float32),
            "ctx": Spec((B, cfg.ctx_len, cfg.ctx_dim), np.float32),
            "step": Spec((), np.int32)}


_BATCH_SPECS = {"lm": _lm_batch_specs, "vit": _vision_batch_specs,
                "resnet": _vision_batch_specs, "dit": _dit_batch_specs,
                "unet": _unet_batch_specs}


def batch_to(batch: Dict[str, np.ndarray], device: DeviceLike = None
             ) -> Dict[str, Any]:
    """A numpy batch as tensors on ``device`` (``None``: CUDA); integer
    entries as int64 (index tensors), the rest as they are.  A scalar
    entry (the diffusion batches' ``step``) stays a host int: the noise
    keys are derived from it on the host, with no read from the card."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = int(v)
            continue
        t = torch.from_numpy(np.require(v, requirements="C"))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(dev, non_blocking=True)
    return out


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _init_params(mod, cfg, seed: int, dev: torch.device) -> PyTree:
    """Weights drawn from ``torch.Generator(seed)`` on ``dev`` (the UNet's
    kernels then laid out as its ``params_from_numpy`` lays them)."""
    if cfg.family == "unet":
        return common.tree_map(resnet.to_port_layout, common.init_params(
            mod.param_defs(cfg), _generator(seed, dev), dev))
    return mod.init_params(cfg, _generator(seed, dev), dev)


def _saved_layout(tree: PyTree, fn) -> PyTree:
    """A train tree ``{"params", "opt"}`` with ``fn`` applied to each leaf
    of the parameters and of both moments."""
    opt = tree["opt"]
    return {"params": common.tree_map(fn, tree["params"]),
            "opt": opt._replace(m=common.tree_map(fn, opt.m),
                                v=common.tree_map(fn, opt.v))}


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------
def build_cell(arch: str, shape_name: str, cfg=None) -> Cell:
    cfg = cfg or get_config(arch)
    shape = shapes_for(cfg)[shape_name]
    mod = model_module(cfg)
    p_defs = mod.param_defs(cfg)

    if shape.kind == "train":
        ocfg = opt_cfg_for(cfg)
        step = mod.make_train_step(cfg, ocfg)
        b_specs = _BATCH_SPECS[cfg.family](cfg, shape)

        def make_args(seed: int = 0, device: DeviceLike = None):
            dev = resolve_device(device)
            params = _init_params(mod, cfg, seed, dev)
            return (params, init_opt_state(params, ocfg),
                    batch_to(SyntheticSource(b_specs, seed).batch_at(0), dev))

        saved = {}
        if cfg.family in ("resnet", "unet"):
            saved = dict(
                to_saved=lambda t: _saved_layout(
                    t, resnet.to_reference_layout),
                from_saved=lambda t: _saved_layout(t, resnet.to_port_layout))
        return Cell(arch, shape, cfg, step, (p_defs, None, b_specs),
                    make_args, donate=(0, 1), **saved)

    if cfg.family == "lm":
        B, S = shape.global_batch, shape.seq_len
        t_spec = Spec((B, S) if shape.kind == "prefill" else (B,), np.int32)

        def tokens(seed, dev):
            g = _generator(seed + 1, dev)
            return torch.randint(0, cfg.vocab_size, t_spec.shape, generator=g,
                                 device=dev)

        if shape.kind == "prefill":
            def step(params, tokens):
                return transformer.prefill(params, tokens, cfg)

            def make_args(seed: int = 0, device: DeviceLike = None):
                dev = resolve_device(device)
                return (_init_params(mod, cfg, seed, dev),
                        tokens(seed, dev))

            return Cell(arch, shape, cfg, step, (p_defs, t_spec), make_args)

        # decode
        sliding = cfg.sliding_window is not None and cfg.global_every > 0
        init = transformer.init_sliding_cache if sliding \
            else transformer.init_cache
        decode = transformer.decode_step_sliding if sliding \
            else transformer.decode_step

        def step(params, cache, tokens):
            return decode(params, cache, tokens, cfg)

        def make_args(seed: int = 0, device: DeviceLike = None):
            dev = resolve_device(device)
            cache = init(cfg, B, S, dev)
            cache["length"] = S // 2
            return (_init_params(mod, cfg, seed, dev), cache,
                    tokens(seed, dev))

        return Cell(arch, shape, cfg, step, (p_defs, None, t_spec), make_args,
                    donate=(1,))

    B = shape.global_batch
    if cfg.family in ("vit", "resnet"):
        i_spec = Spec((B, shape.img_res, shape.img_res, 3), np.float32)

        def step(params, images):
            return mod.serve_step(params, images, cfg)

        def make_args(seed: int = 0, device: DeviceLike = None):
            dev = resolve_device(device)
            g = _generator(seed + 1, dev)
            return (_init_params(mod, cfg, seed, dev),
                    torch.randn(i_spec.shape, generator=g, device=dev))

        return Cell(arch, shape, cfg, step, (p_defs, i_spec), make_args)

    if cfg.family == "dit":
        lr = cfg.latent_res(shape.img_res)
        l_spec = Spec((B, lr, lr, cfg.latent_channels), np.float32)

        def step(params, latents, t, y):
            return dit.serve_step(params, latents, t, y, cfg)

        def make_args(seed: int = 0, device: DeviceLike = None):
            dev = resolve_device(device)
            g = _generator(seed + 1, dev)
            return (_init_params(mod, cfg, seed, dev),
                    torch.randn(l_spec.shape, generator=g, device=dev),
                    torch.full((B,), 500, dtype=torch.int32, device=dev),
                    torch.zeros((B,), dtype=torch.int32, device=dev))

        return Cell(arch, shape, cfg, step,
                    (p_defs, l_spec, Spec((B,), np.int32), Spec((B,), np.int32)),
                    make_args)

    # unet serve
    lr = shape.img_res // 8 if shape.img_res else cfg.latent_res
    l_spec = Spec((B, lr, lr, cfg.latent_channels), np.float32)
    c_spec = Spec((B, cfg.ctx_len, cfg.ctx_dim), np.float32)

    def step(params, latents, t, ctx):
        return unet.serve_step(params, latents, t, ctx, cfg)

    def make_args(seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        g = _generator(seed + 1, dev)
        return (_init_params(mod, cfg, seed, dev),
                torch.randn(l_spec.shape, generator=g, device=dev),
                torch.full((B,), 500, dtype=torch.int32, device=dev),
                torch.randn(c_spec.shape, generator=g, device=dev))

    return Cell(arch, shape, cfg, step,
                (p_defs, l_spec, Spec((B,), np.int32), c_spec), make_args)
