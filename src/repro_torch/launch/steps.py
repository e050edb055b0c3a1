"""Cell builder: (architecture config x shape) -> step function, the
shapes of its arguments, their logical sharding and a factory of real
ones (the port of ``repro/launch/steps.py``).

One place defines, for every (arch, shape) cell: the step callable
(train / prefill / decode / serve), the argument specs (a ``Spec``, shape
and dtype, where the reference has ``ShapeDtypeStruct``s: torch dtypes
for parameters, moments and caches, numpy dtypes for batches), the
logical sharding trees aligned with them (``arg_logical``, the
reference's trees: ``launch.dryrun._to_shardings`` places them on a mesh)
and a real-input factory for the drivers and the tests.  Used by
``launch/train.py`` and the train loop.  :func:`_materialize` draws an
argument tree from its specs as the reference's does, through JAX's
threefry (``models/prng.py``), bit for bit.
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
from repro_torch.fleetsim.rng import Key
from repro_torch.models import (common, dit, prng, resnet, transformer, unet,
                                vit)
from repro_torch.training.data import Spec, SyntheticSource
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            init_opt_state, opt_state_specs)

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


def _nest_logical(flat: Dict[str, Tuple]) -> PyTree:
    out: Dict[str, Any] = {}
    for path, spec in flat.items():
        common.assign(out, path, tuple(spec))
    return out


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
    arg_specs: Tuple             # abstract args (Specs)
    arg_logical: Tuple           # logical sharding trees aligned with args
    make_args: Callable          # (seed, device) -> real args
    donate: Tuple[int, ...] = ()
    # a train cell's parameter tree as checkpoints hold it (the reference's
    # layouts) and back; the identity but for ResNet's kernels
    to_saved: Callable = _identity
    from_saved: Callable = _identity

    @property
    def label(self) -> str:
        return f"{self.arch}:{self.shape.name}"


def _batch_tree_logical(tree: PyTree) -> PyTree:
    """Shard the leading dim of every array leaf over dp."""
    def leaf(x):
        nd = len(x.shape)
        return ("dp",) + (None,) * (nd - 1) if nd else ()
    return common.tree_map(leaf, tree)


def _opt_logical(param_logical_tree: PyTree) -> OptState:
    return OptState(step=(), m=param_logical_tree, v=param_logical_tree)


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


def _spec_leaves(tree: PyTree, prefix: Tuple = ()):
    """(path, Spec) pairs in ``jax.tree_util``'s order: a dict's keys
    sorted, a NamedTuple's fields in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, OptState):
        for f in tree._fields:
            yield from _spec_leaves(getattr(tree, f), prefix + (f,))
    else:
        yield prefix, tree


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex)
    return np.issubdtype(np.dtype(dtype), np.integer)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _materialize(specs: PyTree, key: Key, device: DeviceLike = None
                 ) -> PyTree:
    """Real arrays for a tree of ``Spec``s, as the reference's
    ``_materialize`` draws them (bit for bit): the leaves in
    ``jax.tree_util`` order, one key each from ``split(key, n)``; an
    integer leaf ``randint(k, shape, 0, 8)`` (0 if it is a scalar), a
    float one ``normal(k, shape)`` cast to its dtype and then times 0.1
    in that dtype (the reference's weakly typed 0.1 takes the array's
    dtype: bf16 0.1001 for a bf16 leaf)."""
    dev = resolve_device(device)
    pairs = list(_spec_leaves(specs))
    keys = prng.split(key, len(pairs))
    out: Dict[Tuple, Any] = {}
    for (path, s), k in zip(pairs, keys):
        dt = _torch_dtype(s.dtype)
        if _is_integer(s.dtype):
            val = torch.zeros(s.shape, dtype=dt, device=dev) if not s.shape \
                else prng.randint(k, s.shape, 0, 8, dev).to(dt)
        else:
            val = prng.normal(k, s.shape, dev).to(dt) \
                * torch.tensor(0.1, dtype=dt, device=dev)
        out[path] = val
    return _rebuild(specs, out)


def _rebuild(tree: PyTree, values: Dict[Tuple, Any], prefix: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(*(_rebuild(getattr(tree, f), values, prefix + (f,))
                          for f in tree._fields))
    return values[prefix]


def _cache_specs(specs: Dict[str, Any]) -> Dict[str, Spec]:
    """``transformer.cache_specs`` as ``Spec``s (``length`` an int32
    scalar, as the reference's)."""
    return {k: Spec(tuple(shape), torch.int32 if dt is int else dt)
            for k, (shape, dt) in specs.items()}


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
    p_specs = mod.param_specs(cfg)
    p_logical = _nest_logical(mod.param_logical(cfg))

    if shape.kind == "train":
        ocfg = opt_cfg_for(cfg)
        step = mod.make_train_step(cfg, ocfg)
        b_specs = _BATCH_SPECS[cfg.family](cfg, shape)
        arg_specs = (p_specs, opt_state_specs(p_specs, ocfg), b_specs)
        arg_logical = (p_logical, _opt_logical(p_logical),
                       _batch_tree_logical(b_specs))

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
        return Cell(arch, shape, cfg, step, arg_specs, arg_logical,
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

            return Cell(arch, shape, cfg, step, (p_specs, t_spec),
                        (p_logical, ("dp", None)), make_args)

        # decode
        sliding = cfg.sliding_window is not None and cfg.global_every > 0
        init = transformer.init_sliding_cache if sliding \
            else transformer.init_cache
        c_specs = _cache_specs((transformer.sliding_cache_specs if sliding
                                else transformer.cache_specs)(cfg, B, S))
        c_logical = transformer.sliding_cache_logical() if sliding \
            else transformer.cache_logical()
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

        return Cell(arch, shape, cfg, step, (p_specs, c_specs, t_spec),
                    (p_logical, c_logical, ("dp",)), make_args, donate=(1,))

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

        return Cell(arch, shape, cfg, step, (p_specs, i_spec),
                    (p_logical, ("dp", None, None, None)), make_args)

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
                    (p_specs, l_spec, Spec((B,), np.int32), Spec((B,), np.int32)),
                    (p_logical, ("dp", None, None, None), ("dp",), ("dp",)),
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
                (p_specs, l_spec, Spec((B,), np.int32), c_spec),
                (p_logical, ("dp", "sp", None, None), ("dp",),
                 ("dp", None, None)), make_args)
