"""Write ``tests/data/torch_diffusion_golden.npz``: the JAX reference's
outputs of the diffusion family's serve step at full width and depth, for
``chip_smoke.py`` to hold the PyTorch port against on the GPU, where JAX is
not installed.

Not a test (it imports JAX).  Both packages get the same inputs, made with
numpy.  Weights: ``repro_torch.models.{dit,unet}.numpy_params(CONFIG,
WEIGHT_SEED, constant_std=CONSTANT_STD)``, in which every leaf is random:
the zero-initialised leaves (DiT's adaLN-Zero gates and final layer, the
UNet's ``c2`` and ``conv_out``, every bias) are normals of std
``CONSTANT_STD`` and the norm scales 1 plus such normals, since with them
at their init the output is 0 for any input.  Each leaf is cast to the
dtype its ``param_defs`` entry names (the UNet's norms stay f32).

* **dit** — ``repro.models.dit.forward``, jitted, of DiT-XL/2
  (``repro.configs.dit_xl2.CONFIG``: 28 layers, d 1152, 16 heads 72 wide,
  675,000,608 parameters) on a batch of 2: standard-normal latents
  (``default_rng(INPUT_SEED)``), timesteps ``DIT_T`` and labels
  ``DIT_Y`` (1000 is the class-dropout label), at 256 px (a 32 x 32
  latent, 256 tokens: the naive path) and at 512 px (64 x 64, 1,024
  tokens, the pos-embed resized from 16 x 16 to 32 x 32: the reference's
  flash-attention kernel in interpret mode, D padded to 128), with
  ``attn_impl="pallas"``, in float32 and bfloat16;
* **unet** — ``repro.models.unet.forward``, jitted, of the SD 1.5 UNet
  (``repro.configs.unet_sd15.CONFIG``, 784,957,760 parameters) at its
  latent 64 on a batch of 2 (timesteps ``UNET_T``, a standard-normal
  77 x 768 context stub), in float32 and bfloat16.  The second sample's
  latents are scaled by ``UNET_SMALL``: its first GroupNorm then sees a
  variance near 1e-3, where the norm's eps (1e-5) moves the output by
  more than rounding does, so the check can tell a wrong eps.

Each output is stored whole, as f32, under ``<section>/<side>/<dtype>``
(``dit/256/float32``, ``unet/64/bfloat16``, ...), with its inputs
(``<section>/<side>/latents``, ``.../t``, ``.../y`` or ``.../ctx``) and
a JSON ``meta`` entry (seeds, the constants' std, the path each output
took, the shapes).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_diffusion_golden.py \\
        [--only dit unet]

``--only`` recomputes the named sections and keeps the rest of the file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import dit_xl2, unet_sd15
from repro.models import dit, unet
from repro_torch.configs import dit_xl2 as torch_dit_xl2
from repro_torch.configs import unet_sd15 as torch_unet_sd15
from repro_torch.models import common as torch_common
from repro_torch.models import dit as torch_dit
from repro_torch.models import unet as torch_unet

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_diffusion_golden.npz")
WEIGHT_SEED, INPUT_SEED, CONSTANT_STD = 0, 1, 0.02
BATCH = 2
DIT_SIDES = (256, 512)                  # image px; the latent is px / 8
DIT_T, DIT_Y = (999, 37), (207, 1000)
UNET_T = (999, 37)
UNET_SMALL = 0.01
DTYPES = ("float32", "bfloat16")


def dit_inputs(px):
    """Latents (2, px/8, px/8, 4) f32, t, y of the DiT section at ``px``."""
    rng = np.random.default_rng(INPUT_SEED + px)
    lat = rng.standard_normal((BATCH, px // 8, px // 8, 4), dtype=np.float32)
    return dict(latents=lat, t=np.array(DIT_T, np.int32),
                y=np.array(DIT_Y, np.int32))


def unet_inputs(latent, ctx_len, ctx_dim):
    """Latents (2, latent, latent, 4) f32 (the second scaled by
    ``UNET_SMALL``), t, and the context stub of the UNet section."""
    rng = np.random.default_rng(INPUT_SEED)
    lat = rng.standard_normal((BATCH, latent, latent, 4), dtype=np.float32)
    lat[1] *= np.float32(UNET_SMALL)
    ctx = rng.standard_normal((BATCH, ctx_len, ctx_dim), dtype=np.float32)
    return dict(latents=lat, t=np.array(UNET_T, np.int32), ctx=ctx)


def reference_params(tree, defs):
    """The numpy tree as the reference's parameters: each leaf cast to the
    dtype its ``param_defs`` entry names."""
    out = {}
    for path, d in defs.items():
        torch_common.assign(out, path, jnp.asarray(
            torch_common.nested(tree, path)).astype(d.dtype))
    return out


def _run(name, fwd, params, args):
    t0 = time.time()
    out = np.asarray(jax.block_until_ready(fwd(params, *map(jnp.asarray,
                                                            args))),
                     np.float32)
    assert np.isfinite(out).all(), name
    print(f"{name}: {time.time() - t0:.1f} s, shape {out.shape}, max |out| "
          f"{np.abs(out).max():.4f}, rms {np.sqrt((out ** 2).mean()):.4f}",
          flush=True)
    return out


def dit_golden():
    tree = torch_dit.numpy_params(torch_dit_xl2.CONFIG, WEIGHT_SEED,
                                  CONSTANT_STD)
    arrays, paths = {}, {}
    for px in DIT_SIDES:
        inp = dit_inputs(px)
        for k, v in inp.items():
            arrays[f"dit/{px}/{k}"] = v
    for dt in DTYPES:
        tcfg = dataclasses.replace(torch_dit_xl2.CONFIG, param_dtype=dt)
        params = reference_params(tree, torch_dit.param_defs(tcfg))
        cfg = dataclasses.replace(dit_xl2.CONFIG, param_dtype=dt,
                                  attn_impl="pallas")
        for px in DIT_SIDES:
            S = cfg.n_tokens(px)
            paths[str(px)] = (
                f"{S} tokens, attn_impl 'pallas': " +
                ("naive (S <= attn_chunk 512)" if S <= cfg.attn_chunk else
                 "flash_attention in interpret mode (S > attn_chunk 512)"))
            fwd = jax.jit(lambda p, x, t, y, c=cfg: dit.forward(p, x, t, y, c))
            inp = dit_inputs(px)
            arrays[f"dit/{px}/{dt}"] = _run(
                f"dit-xl2 {px} px {dt}", fwd, params,
                (inp["latents"], inp["t"], inp["y"]))
            del fwd
        del params
    meta = dict(arch="dit-xl2", batch=BATCH, sides=list(DIT_SIDES),
                t=list(DIT_T), y=list(DIT_Y), paths=paths,
                n_params=sum(int(np.prod(d.shape)) for d in
                             torch_dit.param_defs(torch_dit_xl2.CONFIG)
                             .values()))
    return arrays, meta


def unet_golden():
    cfg0 = torch_unet_sd15.CONFIG
    tree = torch_unet.numpy_params(cfg0, WEIGHT_SEED, CONSTANT_STD)
    inp = unet_inputs(cfg0.latent_res, cfg0.ctx_len, cfg0.ctx_dim)
    side = cfg0.latent_res
    arrays = {f"unet/{side}/{k}": v for k, v in inp.items()}
    for dt in DTYPES:
        tcfg = dataclasses.replace(cfg0, param_dtype=dt)
        params = reference_params(tree, torch_unet.param_defs(tcfg))
        cfg = dataclasses.replace(unet_sd15.CONFIG, param_dtype=dt)
        fwd = jax.jit(lambda p, x, t, c: unet.forward(p, x, t, c, cfg))
        arrays[f"unet/{side}/{dt}"] = _run(
            f"unet-sd15 latent {side} {dt}", fwd, params,
            (inp["latents"], inp["t"], inp["ctx"]))
        del params, fwd
    meta = dict(arch="unet-sd15", batch=BATCH, sides=[side], t=list(UNET_T),
                small_scale=UNET_SMALL,
                paths={str(side): "self-attention chunked (q_chunk 1024) "
                       "past 1,024 tokens, else naive; cross-attention "
                       "naive (the reference's choices)"},
                n_params=sum(int(np.prod(d.shape)) for d in
                             torch_unet.param_defs(cfg0).values()))
    return arrays, meta


SECTIONS = {"dit": dit_golden, "unet": unet_golden}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", metavar="NAME", default=(),
                    choices=sorted(SECTIONS),
                    help="recompute these sections, keep the rest")
    only = ap.parse_args().only
    arrays, meta = {}, dict(weight_seed=WEIGHT_SEED, input_seed=INPUT_SEED,
                            constant_std=CONSTANT_STD, sections={})
    if only:
        with np.load(GOLDEN) as f:
            kept = {k: f[k] for k in f.files}
        old = json.loads(str(kept.pop("meta")))
        for name in SECTIONS:
            if name not in only:
                meta["sections"][name] = old["sections"][name]
                arrays.update({k: v for k, v in kept.items()
                               if k.startswith(name + "/")})
    for name, make in SECTIONS.items():
        if not only or name in only:
            arrays_, meta["sections"][name] = make()
            arrays.update(arrays_)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, meta=np.array(json.dumps(meta)), **arrays)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
