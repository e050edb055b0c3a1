"""Write ``tests/data/torch_dryrun_golden.json``: the JAX reference's dry
run (``repro.launch.dryrun.run_cell``), which ``tests/test_torch_dryrun.py``
and ``chip_smoke.py`` (phase 6d) hold the port's to.

Not a test (it imports JAX, with 512 host devices).  Sections:

* **pairs** — every (cell, mesh) pair of ``all_cells()`` on the 16x16 and
  2x16x16 meshes, keyed ``arch:shape:single`` / ``arch:shape:multi``:
  ``rules``, ``memory``, ``flops_per_chip``, ``hbm_bytes_per_chip``,
  ``collective_bytes_per_chip``, ``collective_breakdown`` and
  ``model_flops`` of the reference's result.
* **skips** — the cells ``all_cells()`` skips, with the reason.
* **smoke** — ``launch.hlo_cost``'s counts (``flops``, ``bytes``,
  ``coll_bytes``, ``coll_by_kind``) of the cells of :data:`SMOKE_CELLS`
  (each family's SMOKE config at a small shape) compiled on one device
  (``one``) and on a 2x4 (data, model) mesh of eight (``mesh``), the
  arguments placed as ``run_cell`` places them.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_dryrun_golden.py \\
        [--only pairs smoke]

``--only`` recomputes the named sections and keeps the rest of the file.
The pairs take about 13 minutes on a 6-core CPU (the UNet and some
ResNet-50 cells compile for 10-96 s each), the smoke section about one.
"""
from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

PATH = pathlib.Path(__file__).parent / "data" / "torch_dryrun_golden.json"
KEYS = ("rules", "memory", "flops_per_chip", "hbm_bytes_per_chip",
        "collective_bytes_per_chip", "collective_breakdown", "model_flops")

# (name, arch, kind, seq_len, global_batch, img_res): each family's SMOKE
# config at a shape small enough for a test; the same table drives the
# port's side in tests/test_torch_dryrun.py
SMOKE_CELLS = (
    ("lm_train", "starcoder2-7b", "train", 48, 8, 0),
    ("lm_prefill", "starcoder2-7b", "prefill", 48, 8, 0),
    ("lm_decode", "starcoder2-7b", "decode", 48, 8, 0),
    ("moe_prefill", "granite-moe-3b-a800m", "prefill", 48, 8, 0),
    ("vit_serve", "deit-b", "serve", 0, 8, 32),
    ("vit_train", "deit-b", "train", 0, 8, 32),
    ("resnet_serve", "resnet-50", "serve", 0, 8, 32),
    ("dit_serve", "dit-xl2", "serve", 0, 8, 64),
    ("unet_serve", "unet-sd15", "serve", 0, 8, 64),
    ("unet_train", "unet-sd15", "train", 0, 8, 64),
)


def smoke_shape(name, kind, seq_len, batch, img_res):
    """The ``ShapeSpec`` of a smoke cell (the reference's class)."""
    from repro.configs.shapes import ShapeSpec
    return ShapeSpec(f"smoke_{name}", kind, seq_len=seq_len,
                     global_batch=batch, img_res=img_res)


def _pairs(out: dict) -> None:
    from repro.configs import all_cells
    from repro.launch.dryrun import run_cell
    cells, skips = all_cells()
    out["skips"] = [{"arch": a, "shape": s, "reason": why}
                    for a, s, why in skips]
    pairs = {}
    for arch, shape in cells:
        for multi in (False, True):
            key = f"{arch}:{shape}:{'multi' if multi else 'single'}"
            t0 = time.time()
            res = run_cell(arch, shape, multi)
            pairs[key] = {k: res[k] for k in KEYS}
            print(f"{key}: {time.time() - t0:.1f} s", flush=True)
    out["pairs"] = pairs


def _smoke_costs(arch, shape, mesh):
    import jax
    from repro.configs import get_smoke_config
    from repro.configs import shapes as shapes_mod
    from repro.distributed import sharding as shd
    from repro.launch.dryrun import _to_shardings
    from repro.launch.hlo_cost import HloCostModel
    from repro.launch.mesh import install_rules
    from repro.launch.steps import build_cell
    cfg = get_smoke_config(arch)
    table = shapes_mod.shapes_for(cfg)
    table[shape.name] = shape
    try:
        cell = build_cell(arch, shape.name, cfg=cfg)
    finally:
        del table[shape.name]
    if mesh is None:
        compiled = jax.jit(cell.step_fn).lower(*cell.arg_specs).compile()
    else:
        install_rules(mesh, cell.cfg, shape.global_batch, kind=shape.kind)
        try:
            shardings = _to_shardings(mesh, cell.arg_logical, cell.arg_specs)
            with mesh:
                compiled = jax.jit(cell.step_fn, in_shardings=shardings
                                   ).lower(*cell.arg_specs).compile()
        finally:
            shd.clear_rules()
    model = HloCostModel(compiled.as_text())
    c = model.entry_costs()
    return {"flops": c.flops, "bytes": c.bytes, "coll_bytes": c.coll_bytes,
            "coll_by_kind": dict(c.coll_by_kind), "dots": _dots(model)}


def _dots(model) -> list:
    """Each product's and convolution's per-chip FLOPs and result type,
    with how many times the program runs it (loop bodies times their trip
    counts, as ``HloCostModel`` counts them): ``[flops, type, count]``."""
    import collections
    import re
    from repro.launch.hlo_cost import _TRIP_RE
    seen = collections.Counter()

    def walk(name, times):
        for op in model.computations.get(name, []):
            if op.opcode == "dot":
                seen[(model._dot_flops(op), op.result_type.split("{")[0])] \
                    += times
            elif op.opcode == "convolution":
                seen[(model._conv_flops(op),
                      op.result_type.split("{")[0])] += times
            elif op.opcode == "while":
                trip = _TRIP_RE.search(op.line)
                body = re.search(r"body=%?([\w.\-]+)", op.line)
                walk(body.group(1), times * (int(trip.group(1)) if trip
                                             else 1))
            elif op.opcode in ("fusion", "call"):
                sub = re.search(r"(?:calls|to_apply)=%?([\w.\-]+)", op.line)
                if sub:
                    walk(sub.group(1), times)

    for root in [r for r in model.computations if "main" in r]:
        walk(root, 1)
    return [[f, t, n] for (f, t), n in sorted(seen.items())]


def _smoke(out: dict) -> None:
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    smoke = {}
    for name, arch, kind, seq, batch, res in SMOKE_CELLS:
        shape = smoke_shape(name, kind, seq, batch, res)
        smoke[name] = {"one": _smoke_costs(arch, shape, None),
                       "mesh": _smoke_costs(arch, shape, mesh)}
        print(f"smoke {name}: {smoke[name]['one']['flops']:.6g} / "
              f"{smoke[name]['mesh']['flops']:.6g} flops", flush=True)
    out["smoke"] = smoke


SECTIONS = {"pairs": _pairs, "smoke": _smoke}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", choices=sorted(SECTIONS))
    args = ap.parse_args()
    out = json.loads(PATH.read_text()) if PATH.exists() else {}
    for name in args.only or sorted(SECTIONS):
        t0 = time.time()
        SECTIONS[name](out)
        PATH.parent.mkdir(parents=True, exist_ok=True)
        PATH.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
        print(f"section {name}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
