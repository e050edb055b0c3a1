"""Write ``tests/data/torch_vit_golden.json``: the JAX reference's results
on the PyTorch port's vision serving path.

Not a test (it imports JAX): it produces the file that ``chip_smoke.py``
holds the port against on the GPU, where JAX is not installed.  Both
packages get the same inputs, made with numpy:

* **logits** of DeiT-B at full width (``repro.configs.deit_b.CONFIG``
  with ``attn_impl="pallas"``: the flash-attention kernel, in interpret
  mode on the CPU, for sequences longer than 512) with the seeded weights
  ``repro_torch.models.vit.numpy_params(CONFIG, 0)``, on two seeded
  images (uniform [0, 1), ``default_rng(1)``) at 224 px (198 tokens, the
  naive path) and then at 384 px (578 tokens, the kernel), in float32
  and in bfloat16;
* **engine decisions** of ``repro.serving.engine.DeadlineAwareEngine``
  with a constant runner (its decisions do not depend on the model's
  output) on the serving run ``chip_smoke.py`` drives,
  ``repro_torch.launch.serve.SURVEILLANCE``: the stream of
  ``examples/serve_surveillance.py --requests 64`` (its 4K / FHD / HD
  classes, mix, seeds, three replicas and ``max_batch`` 8, the
  ``random`` forwarding policy), with the preferential queue and with
  FIFO: per request its completion time, forwards and serving replica,
  every batch (replica, class, size) in execution order, and the
  engine's stats;
* **ResNet-50 logits** (section ``resnet``): the reference's
  ``repro.models.resnet.forward``, jitted, at full width
  (``repro.configs.resnet50.CONFIG``) with the seeded weights
  ``repro_torch.models.resnet.numpy_params(CONFIG, 0)`` (kernels and head
  cast to the run's dtype, BatchNorm scales and biases kept in f32, as
  the reference's ``param_defs`` types them), on the same two images at
  224 and 384 px in float32 and bfloat16; and, in bfloat16, the logits of
  each ``SURVEILLANCE`` class's frame (the first image at the class's
  ``model_res``) as a batch of one, the batch the serving run's argmax
  is held to (BatchNorm uses batch statistics, and a batch of copies of
  one frame has that frame's statistics);
* **ViT-H/14 logits** (section ``vit_h14``): the reference's
  ``repro.models.vit.forward``, jitted, at full width
  (``repro.configs.vit_h14.CONFIG``: 32 layers, d 1280, 16 heads of
  width 80) with ``attn_impl="pallas"`` (the flash-attention kernel in
  interpret mode, D padded to 128, for sequences longer than 512) and the
  seeded weights ``repro_torch.models.vit.numpy_params(CONFIG, 0)``, on
  the same two images at 224 px (257 tokens, the naive path) and 384 px
  (730 tokens, the kernel) in float32 and bfloat16; and, in bfloat16,
  each ``SURVEILLANCE`` class's frame as a batch of one.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_vit_golden.py \\
        [--only logits serving resnet vit_h14]

``--only`` recomputes the named sections and keeps the rest of the file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import deit_b, resnet50, vit_h14
from repro.core.queues import FIFOQueue
from repro.models import resnet, vit
from repro.serving import engine
from repro_torch.configs import deit_b as torch_deit_b
from repro_torch.configs import resnet50 as torch_resnet50
from repro_torch.configs import vit_h14 as torch_vit_h14
from repro_torch.launch.serve import SURVEILLANCE, record_run
from repro_torch.models import common as torch_common
from repro_torch.models import resnet as torch_resnet
from repro_torch.models import vit as torch_vit

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_vit_golden.json")
RESOLUTIONS = (224, 384)
N_IMAGES, IMAGE_SEED, WEIGHT_SEED = 2, 1, 0


def images(res_list=RESOLUTIONS):
    """The golden images: per resolution, (N_IMAGES, res, res, 3) f32."""
    rng = np.random.default_rng(IMAGE_SEED)
    return {r: rng.random((N_IMAGES, r, r, 3), dtype=np.float32)
            for r in res_list}


def vit_logits(jcfg, tcfg, classes=False):
    """The reference's jitted ViT forward with ``tcfg``'s seeded numpy
    weights: logits of the golden images per resolution and dtype, and
    with ``classes`` each ``SURVEILLANCE`` class's frame alone in bf16."""
    tree = torch_vit.numpy_params(tcfg, WEIGHT_SEED)
    imgs = images()
    out, frames = {}, {}
    for dt in ("float32", "bfloat16"):
        c = dataclasses.replace(jcfg, param_dtype=dt)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dt),
                                        tree)
        fwd = jax.jit(lambda p, x: vit.forward(p, x, c))
        for res, img in imgs.items():
            t0 = time.time()
            lg = np.asarray(fwd(params, jnp.asarray(img)), np.float32)
            print(f"{jcfg.name} logits {res} {dt}: {time.time() - t0:.1f} "
                  f"s, max |logit| {np.abs(lg).max():.3f}", flush=True)
            out.setdefault(str(res), {})[dt] = _rows(lg)
        if classes and dt == "bfloat16":
            for cl in SURVEILLANCE["classes"]:
                frame = imgs[cl["model_res"]][:1]
                frames[cl["name"]] = dict(
                    model_res=cl["model_res"], dtype=dt,
                    logits=_rows(fwd(params, jnp.asarray(frame)))[0])
        del params, fwd
    return out, frames


def logits_golden():
    return vit_logits(
        dataclasses.replace(deit_b.CONFIG, attn_impl="pallas"),
        dataclasses.replace(torch_deit_b.CONFIG, attn_impl="pallas"))[0]


def vit_h14_golden():
    jcfg = dataclasses.replace(vit_h14.CONFIG, attn_impl="pallas")
    tcfg = dataclasses.replace(torch_vit_h14.CONFIG, attn_impl="pallas")
    logits, classes = vit_logits(jcfg, tcfg, classes=True)
    return dict(arch="vit-h14", attn_impl="pallas",
                attention_path="flash_attention in interpret mode "
                               "(S > attn_chunk 512), else naive",
                weight_seed=WEIGHT_SEED, image_seed=IMAGE_SEED,
                n_images=N_IMAGES, resolutions=list(RESOLUTIONS),
                n_tokens={str(r): tcfg.n_tokens(r) for r in RESOLUTIONS},
                logits=logits, classes=classes)


def _rows(logits):
    """Finite logits as JSON rows, 8 significant digits."""
    lg = np.asarray(logits, np.float32)
    assert np.isfinite(lg).all()
    return [[float(f"{x:.8g}") for x in row] for row in lg]


def resnet_reference_params(tree, tcfg):
    """The numpy tree as the reference's parameters: each leaf cast to the
    dtype its ``param_defs`` entry names."""
    out = {}
    for path, d in torch_resnet.param_defs(tcfg).items():
        torch_common.assign(out, path, jnp.asarray(
            torch_common.nested(tree, path)).astype(d.dtype))
    return out


def resnet_golden():
    tree = torch_resnet.numpy_params(torch_resnet50.CONFIG, WEIGHT_SEED)
    imgs = images()
    logits, classes = {}, {}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(resnet50.CONFIG, param_dtype=dt)
        params = resnet_reference_params(
            tree, dataclasses.replace(torch_resnet50.CONFIG, param_dtype=dt))
        fwd = jax.jit(lambda p, x: resnet.forward(p, x, cfg))
        for res, img in imgs.items():
            t0 = time.time()
            logits.setdefault(str(res), {})[dt] = _rows(
                fwd(params, jnp.asarray(img)))
            print(f"resnet logits {res} {dt}: {time.time() - t0:.1f} s",
                  flush=True)
        if dt == "bfloat16":
            for c in SURVEILLANCE["classes"]:
                frame = imgs[c["model_res"]][:1]
                classes[c["name"]] = dict(
                    model_res=c["model_res"], dtype=dt,
                    logits=_rows(fwd(params, jnp.asarray(frame)))[0])
    return dict(arch="resnet-50", weight_seed=WEIGHT_SEED,
                image_seed=IMAGE_SEED, n_images=N_IMAGES,
                resolutions=list(RESOLUTIONS), logits=logits,
                classes=classes)


def decisions(queue):
    """The JAX engine's decisions on the serving run."""
    ref_engine = SimpleNamespace(
        DeadlineAwareEngine=engine.DeadlineAwareEngine,
        ServingReplica=engine.ServingReplica,
        ServiceClass=engine.ServiceClass, FIFOQueue=FIFOQueue)
    run = record_run(SURVEILLANCE, queue,
                     lambda cls_name, frames: [0] * len(frames),
                     [None] * len(SURVEILLANCE["classes"]),
                     engine=ref_engine)
    del run["results"]
    return run


def serving_golden():
    serving = dict(SURVEILLANCE, runs={q: decisions(q)
                                       for q in ("preferential", "fifo")})
    for q, run in serving["runs"].items():
        print(f"serving {q}: {run['stats']}", flush=True)
    return serving


SECTIONS = {"logits": logits_golden, "serving": serving_golden,
            "resnet": resnet_golden, "vit_h14": vit_h14_golden}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", metavar="NAME", default=(),
                    choices=sorted(SECTIONS),
                    help="recompute these sections, keep the rest")
    only = ap.parse_args().only
    golden = dict(
        arch="deit-b", attn_impl="pallas", weight_seed=WEIGHT_SEED,
        image_seed=IMAGE_SEED, n_images=N_IMAGES,
        resolutions=list(RESOLUTIONS))
    kept = {}
    if only:
        with open(GOLDEN) as f:
            kept = json.load(f)
    for name, make in SECTIONS.items():
        golden[name] = make() if not only or name in only else kept[name]
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
