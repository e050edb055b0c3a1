"""Write ``tests/data/torch_train_golden.npz``: the JAX reference's train
steps, which ``chip_smoke.py`` (phase 6b) holds the port's to on the
card, where JAX is not installed, and ``tests/test_torch_train_step.py``
on the CPU.

Not a test (it imports JAX).  Both packages get the same inputs, made with
numpy (``tests/train_golden.py``): weights from
``common.numpy_params(param_defs, WEIGHT_SEED, constant_std=0.02)``
(every leaf random), each cast to its def's dtype; batches from
``SyntheticSource(seed=INPUT_SEED)`` (the same bytes in both packages);
AdamW as ``opt_cfg_for`` gives it but with one warmup step (lr 3e-4).
The reference's step is ``make_train_step``'s body under ``jax.jit``
(``value_and_grad`` of ``loss_fn``, then ``adamw_update``), returning its
gradient too.  Sections:

* ``granite/float32``, ``granite/bfloat16`` — Granite-3.0 MoE at full
  width with its depth cut 32 -> 2 (390,233,088 parameters), B = 1,
  1,100 tokens (past ``attn_chunk`` 1,024: the chunked attention runs,
  and ``chunked_lm_loss`` takes two 512-token chunks and a remainder of
  76), ``remat`` on as published;
* ``granite_mesh/float32``, ``granite_mesh/bfloat16`` — the same cut,
  weights and batch, the step jitted under the reference's one-device
  mesh with ``install_rules(kind="train")``: its MoE through
  ``moe_ffn_sharded``'s ``shard_map`` (the padded experts 40-47 masked,
  the capacity from the 40 real ones), differentiated by ``jax.grad``;
* ``deit/float32`` — DeiT-B at full width with its depth cut 12 -> 2, B =
  2, 224 px;
* ``dit/float32``, ``dit/bfloat16`` — DiT-XL/2 at full width (d 1,152,
  16 heads of 72, patch 2) with its depth cut 28 -> 2 (53,586,464
  parameters), B = 2 at 256 px (latent 32, 256 tokens: the ``chunked``
  attention's naive path), ``remat`` on as published; the loss's ``t``
  and ``eps`` drawn at the batch's ``step`` 0;
* ``unet/float32``, ``unet/bfloat16`` — the SD 1.5 UNet at full width
  (320 channels, mult 1-2-4-4, ctx 768, 8 heads) with ``n_res_blocks``
  cut 2 -> 1 (530,702,400 parameters), B = 1 at latent 16 (128 px);
* ``smoke/deit-smoke``, ``smoke/resnet-smoke``, ``smoke/granite-moe-smoke``,
  ``smoke/dit-smoke``, ``smoke/unet-smoke`` — the smoke configs in f32
  over 3 steps (B = 2; 24 tokens), the last one recorded,
  ``<section>/losses`` every step's loss.

What a step's record holds and the limits a run is held to:
``tests/train_golden.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_train_golden.py \\
        [--only granite granite_mesh deit dit unet smoke smoke/dit-smoke ...]

``--only`` takes groups (the name before the ``/``) or whole section
names, and keeps the other sections of the file.  About 6 minutes and
12 GB of host memory on an 8-core CPU, most of it the f32 granite and
unet sections.
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import train_golden as tg  # noqa: E402
from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.steps import model_module  # noqa: E402
from repro.training.optimizer import (AdamWConfig, adamw_update,  # noqa: E402
                                      init_opt_state)
from repro_torch.models import common as torch_common  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_train_golden.npz")
SECTIONS = ("granite", "granite_mesh", "deit", "dit", "unet", "smoke")


def reference_config(name, tcfg):
    """The reference's config of a section (the port's ``tcfg``'s
    fields)."""
    if name.startswith("smoke/"):
        arch = {"deit-smoke": "deit-b", "resnet-smoke": "resnet-50",
                "granite-moe-smoke": "granite-moe-3b-a800m",
                "dit-smoke": "dit-xl2", "unet-smoke": "unet-sd15"}[tcfg.name]
        cfg = get_smoke_config(arch)
    elif name.startswith("unet/"):
        cfg = dataclasses.replace(
            get_config("unet-sd15"), n_res_blocks=tcfg.n_res_blocks,
            latent_res=tcfg.latent_res, img_res=tcfg.img_res)
    else:
        arch = {"granite": "granite-moe-3b-a800m",
                "granite_mesh": "granite-moe-3b-a800m", "deit": "deit-b",
                "dit": "dit-xl2"}[name.split("/")[0]]
        cfg = dataclasses.replace(get_config(arch), n_layers=tcfg.n_layers)
    return dataclasses.replace(cfg, param_dtype=tcfg.param_dtype)


def reference_params(tree, defs):
    out = {}
    for path, d in defs.items():
        torch_common.assign(out, path, jnp.asarray(
            torch_common.nested(tree, path)).astype(d.dtype))
    return out


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def reference_record(name, tcfg):
    cfg = reference_config(name, tcfg)
    mod = model_module(cfg)
    tree = tg.numpy_weights(tcfg)
    from repro_torch.launch.steps import model_module as torch_module
    params = reference_params(tree, torch_module(tcfg).param_defs(tcfg))
    del tree
    ocfg = AdamWConfig(state_dtype=jnp.dtype(getattr(cfg, "opt_state_dtype",
                                                     "float32")), **tg.OPT)
    state = init_opt_state(params, ocfg)

    def step(params, state, batch):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: mod.loss_fn(p, batch, cfg), has_aux=True)(params)
        new_p, new_s, om = adamw_update(params, grads, state, ocfg)
        return grads, new_p, new_s, dict(metrics, **om)

    step = jax.jit(step)
    losses = []
    batches = tg.section_batches(name, tcfg)
    meshed = name.startswith(tg.MESHED)
    if meshed:
        # the reference's own one-device mesh and train rules: its MoE
        # through moe_ffn_sharded's shard_map
        jmesh.install_rules(jmesh.make_host_mesh(), cfg, 1, kind="train")
    try:
        for b in batches:
            before = to_numpy(params)
            grads, params, state, metrics = step(
                params, state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(metrics["loss"]))
    finally:
        if meshed:
            jshd.clear_rules()
    metrics = {k: v for k, v in metrics.items() if k != "accuracy"}
    rec = tg.record(name, metrics, before, to_numpy(grads), to_numpy(params),
                    to_numpy(state.m), to_numpy(state.v))
    rec[name + "/losses"] = np.asarray(losses, np.float64)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*",
                    help=f"groups {SECTIONS} or section names")
    args = ap.parse_args()
    only = set(args.only or SECTIONS)
    names = list(tg.port_configs())

    def chosen(name):
        return name in only or name.split("/")[0] in only

    unknown = only - set(SECTIONS) - set(names)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    arrays = {}
    if os.path.exists(GOLDEN) and args.only:
        with np.load(GOLDEN) as old:
            arrays = {k: old[k] for k in old.files if k != "meta" and
                      not chosen("/".join(k.split("/")[:2]))}
    for name, tcfg in tg.port_configs().items():
        if not chosen(name):
            continue
        t0 = time.time()
        rec = reference_record(name, tcfg)
        assert all(np.isfinite(a).all() for a in rec.values()), name
        arrays.update(rec)
        print(f"{name}: {time.time() - t0:.1f} s, loss "
              f"{float(rec[name + '/metrics/loss']):.6f}", flush=True)
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        meta = dict(weight_seed=tg.WEIGHT_SEED, input_seed=tg.INPUT_SEED,
                    constant_std=tg.CONSTANT_STD, opt=tg.OPT,
                    granite=dict(n_layers=tg.GRANITE_LAYERS,
                                 tokens=tg.GRANITE_TOKENS, batch=1,
                                 cut="depth 32 -> 2 layers; full width"),
                    granite_mesh=dict(
                        n_layers=tg.GRANITE_LAYERS, tokens=tg.GRANITE_TOKENS,
                        batch=1, cut="depth 32 -> 2 layers; full width",
                        mesh="one CPU device, (data, model) = (1, 1), "
                             "install_rules(kind='train')",
                        moe="moe_ffn_sharded: padded experts masked, "
                            "capacity from n_experts"),
                    deit=dict(n_layers=tg.DEIT_LAYERS, batch=tg.DEIT_BATCH,
                              cut="depth 12 -> 2 layers; full width"),
                    dit=dict(n_layers=tg.DIT_LAYERS, batch=tg.DIT_BATCH,
                             img_res=256,
                             cut="depth 28 -> 2 layers; full width"),
                    unet=dict(n_res_blocks=tg.UNET_RES_BLOCKS,
                              latent=tg.UNET_LATENT, batch=tg.UNET_BATCH,
                              cut="n_res_blocks 2 -> 1, latent 64 -> 16; "
                                  "full width"),
                    smoke=dict(archs=list(tg.SMOKE_ARCHS),
                               batch=tg.SMOKE_BATCH, seq=tg.SMOKE_SEQ,
                               steps=tg.SMOKE_STEPS))
        np.savez_compressed(GOLDEN, meta=np.asarray(json.dumps(meta)),
                            **arrays)


if __name__ == "__main__":
    main()
