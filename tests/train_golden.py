"""What ``tests/data/torch_train_golden.npz`` records of one train step,
and how a run is held to it: shared by the generator
(``tests/make_torch_train_golden.py``, which records the JAX reference's
step), the CPU test (``tests/test_torch_train_step.py``) and
``chip_smoke.py`` phase 6b.  Imports numpy and torch only.

A step's record, under a section prefix ``p`` (every array f64 or int64):

* ``p/metrics/<name>``: ``loss``, ``aux_loss`` (the LM's), ``grad_norm``,
  ``lr``;
* per parameter leaf ``<leaf>`` (its path, ``/``-joined):
  ``gnorm`` the gradient's norm (a leaf whose gradient is lost shows 0),
  ``idx`` flat sample indices (the ``TOP`` largest |g| of the reference,
  then ``RANDOM`` seeded ones), ``g`` the gradient there, ``upd`` the
  update there over the learning rate, ``(p_new - p_old) / lr``, ``p``
  the new parameter there, ``psum`` the new parameter's sum, ``msum`` /
  ``vsum`` the moments' sums.

Limits, by dtype (``LIMITS``), each relative to the record's own scale,
and never below ``NOISE`` times the step's gradient norm (absolute): a
gradient that is 0 in exact arithmetic (DeiT's key bias, whose shift the
softmax over keys cancels) is rounding noise on both sides, and an
update driven by it (AdamW moves a weight by ~``lr`` whatever the
gradient's size) is held only to the random samples' limit.

* f32: metrics within 2e-5 relative (the same arithmetic, sums in another
  order: ~1e-6 seen on the CPU); ``gnorm`` within 2e-4 relative; ``g``
  within 1e-4 of the leaf's largest |g|; ``upd`` within 1e-3 and one
  f32 unit of the new value over ``lr`` (at the top
  |g| samples the update is -(sign(g) + wd p) to within ~1e-6; AdamW's
  first step is ``lr sign(g)``, so an element whose gradient is at
  rounding noise may flip sign, and the random samples are held to 2.05,
  the most a flip moves them); ``p`` within 1e-6 of |p| plus 2.05 ``lr``;
  ``psum`` within ``lr`` times (2 sqrt(n) + 64) plus 1e-6 of the sum of
  |p| (flips, and the rounding of each new value); ``msum`` / ``vsum``
  within 1e-4 of the sum of the moment's |values|.
* bf16: 8 significant bits, and the MoE's routing flips at near-ties
  (PERF.md §6): metrics within 1e-2 relative, ``gnorm`` within 5e-2
  relative; ``g`` within 0.1 of the largest
  |g|; no ``upd`` (a new bf16 value moves by whole units of the value,
  most of them far above ``lr``); ``p`` and ``psum`` as f32 but with one
  bf16 unit (2^-8) of each |p| in place of 1e-6; ``msum`` / ``vsum``
  5e-2 of the sum of |values|.  The embedding's gradient is held as
  every leaf: the port sums each token id's rows in row order in bf16,
  as XLA's scatter-add does (``models.common.embedding``).

``compare`` returns, per check, the share of its limit used (a value
above 1 fails); ``fails`` lists those above 1.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

TOP, RANDOM = 8, 8
# a leaf's gradient at or below NOISE x the step's gradient norm is
# rounding noise (DeiT's key bias: softmax over keys cancels it exactly)
NOISE = 1e-6
LIMITS = {
    "float32": dict(metric=2e-5, gnorm=2e-4, g=1e-4, upd_top=1e-3,
                    upd_random=2.05, psum_unit=1e-6, mom=1e-4),
    "bfloat16": dict(metric=1e-2, gnorm=5e-2, g=0.1, psum_unit=2.0 ** -8,
                     mom=5e-2),
}


def flat_leaves(tree, prefix=()) -> Iterable[Tuple[str, object]]:
    """(path, leaf) of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def as_f64(x) -> torch.Tensor:
    """A leaf as an f64 tensor, on its own device (numpy arrays, f32-cast,
    on the CPU): the record's sums and norms are taken in f64 where the
    leaf lives, and only they and the samples leave the device."""
    if isinstance(x, torch.Tensor):
        return x.detach().double()
    return torch.from_numpy(np.asarray(x, np.float32)).double()


def sample_indices(g: torch.Tensor, seed: int) -> np.ndarray:
    """The ``TOP`` largest |g| (flat; the lower index first on a tie), then
    ``RANDOM`` seeded indices.  Only the largest few hundred leave the
    device."""
    vals, cand = torch.topk(g.reshape(-1).abs(), min(g.numel(), TOP * 64))
    cand = cand.cpu().numpy()
    top = cand[np.lexsort((cand, -vals.cpu().numpy()))][:TOP]
    rnd = np.random.default_rng(seed).integers(0, g.numel(), RANDOM)
    return np.concatenate([top, rnd]).astype(np.int64)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def record(prefix: str, metrics: Dict, before: Dict, grads: Dict,
           after: Dict, m: Dict, v: Dict, idx: Dict = None
           ) -> Dict[str, np.ndarray]:
    """A step's record: ``before`` / ``after`` the parameters (nested
    dicts of numpy arrays or tensors), ``grads`` and the moments ``m`` /
    ``v`` alike; ``idx`` the sample indices by leaf (made from ``grads``
    where ``None``)."""
    out = {f"{prefix}/metrics/{k}": np.float64(float(as_f64(val)))
           for k, val in metrics.items()}
    lr = float(as_f64(metrics["lr"]))
    flat = {name: dict(before=b) for name, b in flat_leaves(before)}
    for key, tree in (("g", grads), ("after", after), ("m", m), ("v", v)):
        for name, leaf in flat_leaves(tree):
            flat[name][key] = leaf
    for i, (name, f) in enumerate(flat.items()):
        g = as_f64(f["g"]).reshape(-1)
        pb = as_f64(f["before"]).reshape(-1)
        pa = as_f64(f["after"]).reshape(-1)
        ix = sample_indices(g, i) if idx is None else np.asarray(idx[name])
        at = torch.from_numpy(ix).to(g.device)
        p = f"{prefix}/{name}/"
        out[p + "gnorm"] = np.float64(float(g.square().sum().sqrt()))
        out[p + "idx"] = ix
        out[p + "g"] = _host(g[at])
        out[p + "upd"] = _host((pa[at] - pb[at]) / lr)
        out[p + "p"] = _host(pa[at])
        out[p + "psum"] = np.float64(float(pa.sum()))
        out[p + "pabs"] = np.float64(float(pa.abs().sum()))
        out[p + "n"] = np.int64(pa.numel())
        for mk in ("m", "v"):
            mm = as_f64(f[mk])
            out[p + mk + "sum"] = np.float64(float(mm.sum()))
            out[p + mk + "abs"] = np.float64(float(mm.abs().sum()))
        del g, pb, pa
    return out


def indices(golden, prefix: str) -> Dict[str, np.ndarray]:
    """The sample indices of a recorded step, by leaf."""
    tail = "/idx"
    return {k[len(prefix) + 1:-len(tail)]: np.asarray(golden[k])
            for k in golden.keys()
            if k.startswith(prefix + "/") and k.endswith(tail)}


def compare(got: Dict[str, np.ndarray], want, prefix: str, dtype: str
            ) -> Dict[str, float]:
    """Each check's share of its limit (see the module's docstring):
    ``got`` a record made with the golden's sample indices."""
    lim = LIMITS[dtype]
    shares = {}
    for k in want.keys():
        if not k.startswith(prefix + "/metrics/"):
            continue
        w, g = float(want[k]), float(got[k])
        shares[k] = abs(g - w) / (lim["metric"] * max(abs(w), 1e-30))
    lr = float(want[f"{prefix}/metrics/lr"])
    floor = NOISE * float(want[f"{prefix}/metrics/grad_norm"])
    for name in indices(want, prefix):
        p = f"{prefix}/{name}/"
        n = int(want[p + "n"])
        w_g, g_g = np.asarray(want[p + "g"]), np.asarray(got[p + "g"])
        wn = float(want[p + "gnorm"])
        shares[p + "gnorm"] = abs(float(got[p + "gnorm"]) - wn) / max(
            lim["gnorm"] * wn, floor)
        shares[p + "g"] = float(np.abs(g_g - w_g).max()) / max(
            lim["g"] * float(np.abs(w_g).max()), floor)
        w_p = np.asarray(want[p + "p"])
        if "upd_top" in lim:
            du = np.abs(np.asarray(got[p + "upd"])
                        - np.asarray(want[p + "upd"]))
            ulp = 2.0 ** -23 * np.abs(w_p) / lr    # one unit of p_new
            # samples of a gradient above the noise: the top ones
            live = (np.arange(len(du)) < TOP) & (
                np.abs(w_g) >= max(1e-3 * np.abs(w_g).max(), floor))
            lim_u = np.where(live, lim["upd_top"], lim["upd_random"])
            shares[p + "upd"] = float((du / (lim_u + ulp)).max())
        dp = np.abs(np.asarray(got[p + "p"]) - w_p)
        shares[p + "p"] = float((dp / (lim["psum_unit"] * np.abs(w_p)
                                       + 2.05 * lr + 1e-30)).max())
        ptol = lr * (2 * math.sqrt(n) + 64) \
            + lim["psum_unit"] * float(want[p + "pabs"])
        shares[p + "psum"] = abs(float(got[p + "psum"])
                                 - float(want[p + "psum"])) / ptol
        for mk, least in (("m", floor * math.sqrt(n)), ("v", floor ** 2)):
            tol = max(lim["mom"] * float(want[p + mk + "abs"]), least)
            shares[p + mk + "sum"] = abs(float(got[p + mk + "sum"])
                                         - float(want[p + mk + "sum"])) / tol
    return shares


def fails(shares: Dict[str, float]):
    """The checks above their limit (NaN counts as above)."""
    return {k: v for k, v in shares.items() if not v <= 1.0}


# ---------------------------------------------------------------------------
# The sections, and the port's side of them
# ---------------------------------------------------------------------------
WEIGHT_SEED, INPUT_SEED, CONSTANT_STD = 0, 1, 0.02
GRANITE_LAYERS, GRANITE_TOKENS = 2, 1100
DEIT_LAYERS, DEIT_BATCH = 2, 2
# DiT-XL/2 at full width, depth 28 -> 2, 256 px (latent 32, 256 tokens);
# the SD 1.5 UNet at full width, n_res_blocks 2 -> 1, latent 16
DIT_LAYERS, DIT_BATCH = 2, 2
UNET_RES_BLOCKS, UNET_LATENT, UNET_BATCH = 1, 16, 1
SMOKE_ARCHS = ("deit-b", "resnet-50", "granite-moe-3b-a800m", "dit-xl2",
               "unet-sd15")
SMOKE_BATCH, SMOKE_SEQ, SMOKE_STEPS = 2, 24, 3
# AdamW as opt_cfg_for gives it but with one warmup step: lr 3e-4 at step
# 0 (3e-6 under the default 100-step warmup moves no bf16 weight of
# Granite's size)
OPT = dict(warmup_steps=1)


def batch_specs(family: str, B: int, S: int = 0, res: int = 0, cfg=None):
    """The train cell's batch specs ((shape, numpy dtype) by name); the
    diffusion families' from ``cfg``, at ``res`` px (``S`` unused)."""
    if family == "lm":
        return {"tokens": ((B, S), np.int32), "labels": ((B, S), np.int32)}
    if family in ("dit", "unet"):
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.launch import steps
        specs = steps._BATCH_SPECS[family](
            cfg, ShapeSpec("golden", "train", img_res=res, global_batch=B))
        return {k: tuple(v) for k, v in specs.items()}
    return {"images": ((B, res, res, 3), np.float32),
            "labels": ((B,), np.int32)}


def port_configs():
    """The port's configs of the golden's sections, by section name."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    out = {}
    for group in ("granite", "granite_mesh"):
        for dt in ("float32", "bfloat16"):
            out[f"{group}/{dt}"] = dataclasses.replace(
                get_config("granite-moe-3b-a800m"), n_layers=GRANITE_LAYERS,
                param_dtype=dt)
    out["deit/float32"] = dataclasses.replace(
        get_config("deit-b"), n_layers=DEIT_LAYERS, param_dtype="float32")
    for dt in ("float32", "bfloat16"):
        out[f"dit/{dt}"] = dataclasses.replace(
            get_config("dit-xl2"), n_layers=DIT_LAYERS, param_dtype=dt)
        out[f"unet/{dt}"] = dataclasses.replace(
            get_config("unet-sd15"), n_res_blocks=UNET_RES_BLOCKS,
            latent_res=UNET_LATENT, img_res=8 * UNET_LATENT, param_dtype=dt)
    for arch in SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        out[f"smoke/{cfg.name}"] = dataclasses.replace(cfg,
                                                       param_dtype="float32")
    return out


def section_batches(name: str, cfg):
    """The numpy batches of a section: ``SyntheticSource(INPUT_SEED)`` at
    steps 0, 1, ...; one step, or ``SMOKE_STEPS`` for the smoke ones."""
    from repro_torch.training.data import Spec, SyntheticSource
    if name.startswith("smoke/"):
        specs = batch_specs(cfg.family, SMOKE_BATCH, SMOKE_SEQ,
                            getattr(cfg, "img_res", 0), cfg)
        n = SMOKE_STEPS
    elif name.startswith(("granite/", "granite_mesh/")):
        specs, n = batch_specs("lm", 1, GRANITE_TOKENS), 1
    elif name.startswith("dit/"):
        specs, n = batch_specs("dit", DIT_BATCH, res=cfg.img_res, cfg=cfg), 1
    elif name.startswith("unet/"):
        specs, n = batch_specs("unet", UNET_BATCH, res=cfg.img_res,
                               cfg=cfg), 1
    else:
        specs, n = batch_specs("vit", DEIT_BATCH, res=cfg.img_res), 1
    src = SyntheticSource({k: Spec(*v) for k, v in specs.items()},
                          seed=INPUT_SEED)
    return [src.batch_at(s) for s in range(n)]


def numpy_weights(cfg):
    """Every leaf random (``constant_std``), in the reference's layout."""
    from repro_torch.launch.steps import model_module
    from repro_torch.models import common
    return common.numpy_params(model_module(cfg).param_defs(cfg),
                               WEIGHT_SEED, CONSTANT_STD)


def reference_layout(cfg, tree):
    """A port tree of tensors in the reference's layouts (ResNet's and the
    UNet's kernels HWIO)."""
    from repro_torch.models import common, resnet
    if cfg.family not in ("resnet", "unet"):
        return tree
    return common.tree_map(resnet.to_reference_layout, tree)


MESHED = ("granite_mesh/",)


def reference_one_device_mesh():
    """The reference's (data, model) mesh of 1 x 1 over its first device
    (``jax.make_mesh``): one device even where the process has more, as
    when a module imported earlier asked XLA for 512 host devices."""
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])


@contextlib.contextmanager
def one_rank_mesh(cfg, batch: int, device):
    """A process group of one rank (gloo on the CPU, NCCL on the card;
    from an in-memory store, no network; the one already up is used where
    there is one), the 1 x 1 (data, model) mesh over it on ``device`` and
    ``install_rules(kind="train")`` for ``cfg`` at global batch
    ``batch``; the rules cleared and a group started here destroyed on
    the way out."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh
    dev = torch.device(device)
    started = not dist.is_initialized()
    if started:
        kw = dict(device_id=torch.device("cuda", torch.cuda.current_device())
                  ) if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                **kw)
    try:
        m = mesh.make_host_mesh(device=dev)
        mesh.install_rules(m, cfg, batch, kind="train")
        yield m
    finally:
        shd.clear_rules()
        if started:
            dist.destroy_process_group()


def section_mesh(name: str, cfg, device, meshed: bool = True):
    """The mesh a section's steps run under: :func:`one_rank_mesh` at the
    section's batch of one for a ``granite_mesh`` section (and
    ``meshed``), as the reference's generator installs its own; none
    otherwise."""
    if meshed and name.startswith(MESHED):
        return one_rank_mesh(cfg, 1, device)
    return contextlib.nullcontext()


def port_record(name: str, cfg, want, device="cpu", tree=None,
                loss_fn=None, meshed: bool = True):
    """The port's record of a section on ``device``, made with the
    golden's sample indices: the section's steps through
    ``make_train_step``, the last one as its body (the gradient of
    ``loss_fn``, default the model's, then ``adamw_update``), so that its
    gradient is seen; a ``granite_mesh`` section under its mesh
    (:func:`section_mesh`; without it where ``meshed`` is false).
    Returns (record, the losses of every step)."""
    with section_mesh(name, cfg, device, meshed):
        return _port_record(name, cfg, want, device, tree, loss_fn)


def _port_record(name, cfg, want, device, tree, loss_fn):
    from repro_torch.launch.steps import batch_to, model_module
    from repro_torch.models import common
    from repro_torch.training import optimizer as opt
    mod = model_module(cfg)
    ocfg = opt.AdamWConfig(state_dtype=getattr(cfg, "opt_state_dtype",
                                               "float32"), **OPT)
    tree = numpy_weights(cfg) if tree is None else tree
    params = mod.params_from_numpy(tree, cfg, device)
    state = opt.init_opt_state(params, ocfg)
    batches = [batch_to(b, device) for b in section_batches(name, cfg)]
    step = mod.make_train_step(cfg, ocfg)
    losses = []
    for b in batches[:-1]:
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
    loss_fn = loss_fn or mod.loss_fn
    before = common.tree_map(lambda p: p.detach().clone(), params)
    (_, metrics), grads = common.value_and_grad(
        lambda p: loss_fn(p, batches[-1], cfg), params)
    params, state, om = opt.adamw_update(params, grads, state, ocfg)
    metrics = dict(metrics, **om)
    metrics.pop("accuracy", None)
    losses.append(float(metrics["loss"]))
    lay = lambda t: reference_layout(cfg, t)   # noqa: E731
    rec = record(name, metrics, lay(before), lay(grads), lay(params),
                 lay(state.m), lay(state.v), indices(want, name))
    return rec, losses


# ---------------------------------------------------------------------------
# Planted faults: each must fail the golden
# ---------------------------------------------------------------------------
FAULTS = ("no_dscale", "no_autograd", "no_aux", "no_bias_correction",
          "remainder_misordered", "embed_overwrite")
# the diffusion losses' faults, by the family whose sections must reject
# each
DIFFUSION_FAULTS = {"noise_keys_swapped": "dit", "randn_noise": "dit",
                    "alphas_shifted": "dit", "sigma_half": "dit",
                    "ctx_ignored": "unet", "no_remat_changed_body": "dit"}


def _noise_keys_swapped(step, latents):
    """``t`` from ``fold_in(rng, 2)`` and ``eps`` from ``fold_in(rng,
    1)``."""
    from repro_torch.fleetsim import rng
    from repro_torch.models import prng
    key = rng.fold_in(rng.prng_key(0), int(step))
    dev = latents.device
    t = prng.randint(rng.fold_in(key, 2), (latents.shape[0],), 0, 1000, dev)
    return t, prng.normal(rng.fold_in(key, 1), latents.shape, dev)


def _randn_noise(step, latents):
    """The reference's ``t``, and ``eps`` from ``torch.randn`` seeded by
    the step."""
    t, _ = _REAL["diffusion_noise"](step, latents)
    g = torch.Generator(device=latents.device).manual_seed(int(step))
    return t, torch.randn(latents.shape, generator=g, device=latents.device)


def _alphas_shifted(batch):
    """The forward process at ``alphas[t + 1]``."""
    from repro_torch.models import diffusion
    lat = batch["latents"].float()
    t, eps = diffusion.diffusion_noise(batch["step"], lat)
    alphas = diffusion.ddpm_alphas().to(lat.device)
    a = alphas[(t + 1).clamp(max=alphas.numel() - 1)][:, None, None, None]
    return t, eps, torch.sqrt(a) * lat + torch.sqrt(1 - a) * eps


def _sigma_half_loss(params, batch, cfg):
    """The DiT loss on the output's sigma half, ``out[..., C:]``."""
    from repro_torch.models import diffusion, dit
    t, eps, noised = diffusion.noised_latents(batch)
    out = dit.forward(params, noised, t, batch["labels"], cfg)
    loss = torch.mean(torch.square(out[..., cfg.latent_channels:].float()
                                   - eps))
    return loss, {"loss": loss}


def _ctx_ignored(params, latents, t, ctx, cfg):
    """The UNet's forward with its text context zeroed."""
    return _REAL["unet_forward"](params, latents, t, torch.zeros_like(ctx),
                                 cfg)


def _plain_call(fn, *args):
    return fn(*args)


def _relu(x):
    return torch.relu(x)


_REAL = {}


class _EmbedOverwrite(torch.autograd.Function):
    """The embedding's gather with a backward that writes each token's
    gradient row over the last one instead of adding them."""

    @staticmethod
    def forward(ctx, w, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape = w.shape
        return w[tokens]

    @staticmethod
    def backward(ctx, dy):
        (tokens,) = ctx.saved_tensors
        g = dy.new_zeros(ctx.shape)
        g.index_put_((tokens.reshape(-1),), dy.reshape(-1, ctx.shape[-1]))
        return g, None


def _embed_overwrite(params, tokens, cfg):
    from repro_torch.models import common
    h = _EmbedOverwrite.apply(params["embed"], tokens).to(
        common.torch_dtype(cfg.param_dtype))
    return h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)


def _no_autograd_rmsnorm(x, scale):
    from repro_torch.kernels import ops
    shape = x.shape
    return ops._rmsnorm_rows(x.detach().reshape(-1, shape[-1]),
                             scale.detach()).reshape(shape)


def _remainder_misordered(h, head, labels, chunk=512):
    """``chunked_lm_loss`` with its remainder taken from the front of the
    sequence (the labels from the back)."""
    from repro_torch.models import transformer
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    tot = 0.0
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        tot = tot + transformer._chunk_xent(h[:, sl], head, labels[:, sl])
    rem = S - n * chunk
    if rem:
        tot = tot + transformer._chunk_xent(h[:, :rem], head,
                                            labels[:, n * chunk:])
    return tot / (B * S)


class planted:
    """``with planted(name):`` runs the port with fault ``name`` in place
    (restored after): ``no_dscale`` the rmsnorm backward returns a zero
    scale gradient; ``no_autograd`` ``ops.rmsnorm`` returns a result cut
    from autograd (what a wrapper around a ctypes kernel does without an
    ``autograd.Function``); ``no_aux`` the LM loss without its 0.01 aux
    term; ``no_bias_correction`` AdamW without ``1 - b^t``;
    ``remainder_misordered`` see :func:`_remainder_misordered`;
    ``embed_overwrite`` the embedding's backward writes each token's row
    over the last instead of adding (``_EmbedOverwrite``).  The diffusion
    losses' (``DIFFUSION_FAULTS``): ``noise_keys_swapped`` ``t`` and
    ``eps`` drawn from each other's keys; ``randn_noise`` ``eps`` from
    ``torch.randn``; ``alphas_shifted`` the forward process at ``alphas[t
    + 1]``; ``sigma_half`` the DiT loss on ``out[..., C:]``;
    ``ctx_ignored`` the UNet's context zeroed; ``no_remat_changed_body``
    DiT's layers called without remat, their MLP's GELU a ReLU."""

    def __init__(self, name: str):
        from repro_torch.kernels import ops
        from repro_torch.models import (common, diffusion, dit, transformer,
                                        unet)
        from repro_torch.training import optimizer
        _REAL.setdefault("diffusion_noise", diffusion.diffusion_noise)
        _REAL.setdefault("unet_forward", unet.forward)
        self.patches = []
        if name == "no_dscale":
            real = ops.RMSNormFn.backward

            def backward(ctx, dy):
                dx, ds = real(ctx, dy)
                return dx, torch.zeros_like(ds)
            self.patches.append((ops.RMSNormFn, "backward",
                                 staticmethod(backward)))
        elif name == "no_autograd":
            self.patches.append((ops, "rmsnorm", _no_autograd_rmsnorm))
        elif name == "no_aux":
            def loss_fn(params, batch, cfg):
                h, aux = transformer.hidden_states(params, batch["tokens"],
                                                   cfg)
                loss = transformer.chunked_lm_loss(h, params["lm_head"],
                                                   batch["labels"])
                return loss, {"loss": loss, "aux_loss": aux}
            self.patches.append((transformer, "loss_fn", loss_fn))
        elif name == "no_bias_correction":
            real_update = optimizer._update

            def update(p, g, m, v, cfg, lr, bc1, bc2, scale):
                return real_update(p, g, m, v, cfg, lr, 1.0, 1.0, scale)
            self.patches.append((optimizer, "_update", update))
        elif name == "remainder_misordered":
            self.patches.append((transformer, "chunked_lm_loss",
                                 _remainder_misordered))
        elif name == "embed_overwrite":
            self.patches.append((transformer, "_embed", _embed_overwrite))
        elif name == "noise_keys_swapped":
            self.patches.append((diffusion, "diffusion_noise",
                                 _noise_keys_swapped))
        elif name == "randn_noise":
            self.patches.append((diffusion, "diffusion_noise", _randn_noise))
        elif name == "alphas_shifted":
            self.patches.append((diffusion, "noised_latents", _alphas_shifted))
        elif name == "sigma_half":
            self.patches.append((dit, "loss_fn", _sigma_half_loss))
        elif name == "ctx_ignored":
            self.patches.append((unet, "forward", _ctx_ignored))
        elif name == "no_remat_changed_body":
            self.patches += [(common, "checkpointed", _plain_call),
                             (common, "gelu", _relu)]
        else:
            raise ValueError(f"unknown fault {name!r}")

    def __enter__(self):
        self.saved = [(obj, attr, obj.__dict__[attr])
                      for obj, attr, _ in self.patches]
        for obj, attr, new in self.patches:
            setattr(obj, attr, new)
        return self

    def __exit__(self, *exc):
        for obj, attr, old in self.saved:
            setattr(obj, attr, old)
        return False
