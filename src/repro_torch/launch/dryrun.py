"""Multi-pod dry run: every (architecture x shape x mesh) cell counted
against the production mesh with no allocation, recording memory, cost
and roofline terms (the port of ``repro/launch/dryrun.py``).

Where the reference lowers and compiles each cell against 512 faked XLA
devices, here the mesh is a ``DeviceMesh`` over a ``fake`` process group
of 512 ranks (this process is rank 0) and the arguments are fake tensors
(``FakeTensorMode``: shapes and dtypes, no data) placed by
:func:`_to_shardings`.  The cell's step runs once under
:mod:`repro_torch.launch.op_cost`, which counts what rank 0 runs (FLOPs,
bytes moved, collective bytes by kind); :mod:`repro_torch.launch.roofline`
turns the counts into per-chip times on an H100.  On CUDA (the default)
the fake tensors are CUDA tensors, so the steps reach the hand-written
kernels' operators, each counted by its own FLOP formula with no launch;
with ``--device cpu`` they take the kernels' plain versions.

Usage:
    python -m repro_torch.launch.dryrun --arch vit-l16 --shape serve_b1
    python -m repro_torch.launch.dryrun --all --mesh single --out results/
    python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import op_cost, roofline
from repro_torch.training.data import Spec

_axis_prod = shd.axis_prod
WORLD = 512


def _to_shardings(mesh, logical_tree, spec_tree):
    """Logical tuples -> ``NamedSharding``s, dropping (replicating) any
    axis whose size does not divide the corresponding dim; a leaf that is
    not a tuple of names is replicated."""
    def leaf(names, s):
        if not (isinstance(names, tuple)
                and all(a is None or isinstance(a, str) for a in names)):
            return shd.named(mesh, ())
        return shd.named(mesh, shd.fit(mesh, shd.logical(*names), s.shape))

    return shd.map_specs(leaf, logical_tree, spec_tree)


def _parse_override(val: str):
    if val in ("true", "True"):
        return True
    if val in ("false", "False"):
        return False
    if val in ("none", "None"):
        return None
    try:
        return int(val)
    except ValueError:
        pass
    try:
        return float(val)
    except ValueError:
        return val


@contextlib.contextmanager
def fake_group(world: int = WORLD):
    """A ``fake`` default process group of ``world`` ranks (this process
    rank 0) for the block: started here if none is up (and destroyed
    after), reused if a ``fake`` group of at least ``world`` ranks is;
    any other group raises rather than being torn down."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(
                f"the dry run needs a fake process group of {world} ranks; "
                f"a {dist.get_backend()} group of {dist.get_world_size()} "
                f"is up")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _is_leaf(x) -> bool:
    return isinstance(x, Spec)


def _map2(fn, specs, shardings):
    """``fn(spec, sharding)`` over a tree of ``Spec``s (dicts, NamedTuples,
    tuples) and the sharding tree aligned with it."""
    if _is_leaf(specs):
        return fn(specs, shardings)
    if isinstance(specs, dict):
        return {k: _map2(fn, v, shardings[k]) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_map2(fn, getattr(specs, f),
                                   getattr(shardings, f))
                             for f in specs._fields))
    return tuple(_map2(fn, v, shardings[i]) for i, v in enumerate(specs))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def shard_bytes(mesh, spec: Spec, sharding) -> int:
    """Rank 0's bytes of a leaf placed by ``sharding`` (its local block,
    from DTensor's placements)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, _ = compute_local_shape_and_global_offset(
        spec.shape, mesh, sharding.placements)
    return int(np.prod(shape, dtype=np.int64)) * \
        _torch_dtype(spec.dtype).itemsize


def fake_args(cell, shardings, mode, device, fake_mode):
    """The cell's arguments as fake tensors of their whole shapes on
    ``device``, each carrying its sharding's spec for the cost model: an
    integer leaf int64 (as ``steps.batch_to`` gives them); a cache's
    ``length`` and a diffusion batch's ``step`` Python ints (half the
    cache, step 0), as the train and serve entry points pass them."""
    def leaf(s, sharding):
        dt = _torch_dtype(s.dtype)
        if not (dt.is_floating_point or dt.is_complex):
            dt = torch.int64
        with fake_mode:
            t = torch.empty(s.shape, dtype=dt, device=device)
        if sharding is not None:
            mode.set_spec(t, op_cost.spec_of_entries(
                (tuple(sharding.spec) + (None,) * len(s.shape))
                [:len(s.shape)]))
        return t

    args = list(_map2(leaf, cell.arg_specs, shardings))
    if cell.shape.kind == "decode":
        args[1] = dict(args[1], length=cell.shape.seq_len // 2)
    if cell.shape.kind == "train" and "step" in args[2]:
        args[2] = dict(args[2], step=0)
    return args


def _port_layout(cell, args):
    """The arguments in the port's layouts: ResNet's and the UNet's
    kernels OIHW (``resnet.to_port_layout``), where the cell's specs hold
    the reference's HWIO (a train cell's moments too)."""
    if cell.cfg.family not in ("resnet", "unet"):
        return args
    from repro_torch.models import common, resnet
    args = list(args)
    if cell.shape.kind == "train":
        args[0] = common.tree_map(resnet.to_port_layout, args[0])
        args[1] = args[1]._replace(
            m=common.tree_map(resnet.to_port_layout, args[1].m),
            v=common.tree_map(resnet.to_port_layout, args[1].v))
    else:
        args[0] = common.tree_map(resnet.to_port_layout, args[0])
    return args


def _out_bytes(mode, out) -> int:
    total = 0.0
    for x in _leaves(out):
        if isinstance(x, torch.Tensor):
            total += mode.local_bytes(x)
        elif isinstance(x, (int, float)):
            total += 4
    return int(total)


def count_step(cell, device: DeviceLike = None, mesh=None, shardings=None):
    """One step of ``cell`` counted on fake tensors of ``device`` (``None``:
    CUDA; fake tensors need no card): ``(costs, mode, outputs)``;
    unmeshed (one chip) without ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device("cuda" if device is None else device)
    sizes = shd.mesh_shape(mesh) if mesh is not None else None
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    mode = op_cost.CostMode(sizes)
    args = fake_args(cell, shardings if mesh is not None
                     else _map2(lambda s, _: None, cell.arg_specs,
                                cell.arg_specs), mode, dev, fake_mode)
    costs, out = op_cost.count(cell.step_fn, args, mode, fake_mode,
                               prepare=lambda a: _port_layout(cell, a))
    return costs, mode, out


@dataclasses.dataclass
class StepCount:
    """A step's per-chip counts: costs, output bytes, the peak bytes of the
    storages it allocates, and the depths it was counted at."""
    costs: op_cost.Costs
    output_bytes: float
    temp_bytes: float
    depths: Tuple[int, ...]


def layer_period(cfg) -> Optional[Tuple[int, int]]:
    """``(layers, period)`` of a model built of ``n_layers`` repeated
    blocks (the language models, ViT, DiT; Gemma-3's repeat every
    ``global_every``: five local layers, then a global one); ``None`` for
    ResNet and the UNet."""
    n = getattr(cfg, "n_layers", None)
    if not n:
        return None
    every = getattr(cfg, "global_every", 0)
    period = every if getattr(cfg, "sliding_window", None) and every > 0 \
        else 1
    return n, period


def _count_at(cell, depth, device, mesh) -> StepCount:
    from repro_torch.launch.steps import build_cell
    if depth is not None:
        cell = build_cell(cell.arch, cell.shape.name, shape=cell.shape,
                          cfg=dataclasses.replace(cell.cfg, n_layers=depth))
    sh = _to_shardings(mesh, cell.arg_logical, cell.arg_specs) \
        if mesh is not None else None
    costs, mode, out = count_step(cell, device, mesh, sh)
    return StepCount(costs, _out_bytes(mode, out), mode.peak_bytes,
                     (depth or 0,))


def count_cell(cell, device: DeviceLike = None, mesh=None) -> StepCount:
    """The per-chip counts of one step of ``cell`` (on ``mesh``, whose
    rules the caller has installed; unmeshed without it).

    A stack of ``L`` identical blocks of period ``P`` is counted with no
    block, with one period, and with the ``r = L % P`` blocks left over
    (where there are any), and extended to ``L``: ``c(0) + (L // P)
    (c(P) - c(0)) + (c(r) - c(0))``, exact where the blocks of a period
    cost alike, as ``hlo_cost`` multiplies a scanned body by its trip
    count.  A stack of one period or less, ResNet and the UNet are
    counted whole."""
    lp = layer_period(cell.cfg)
    if lp is None or lp[0] // lp[1] <= 1:
        c = _count_at(cell, None, device, mesh)
        return dataclasses.replace(c, depths=(lp[0] if lp else 0,))
    n, p = lp
    r = n % p
    depths = (0, p) + ((r,) if r else ())
    at = {d: _count_at(cell, d, device, mesh) for d in depths}

    def extend(get):
        none = get(at[0])
        out = none + (get(at[p]) - none) * (n // p)
        return out + (get(at[r]) - none) if r else out

    costs = op_cost.Costs(
        extend(lambda c: c.costs.flops), extend(lambda c: c.costs.bytes),
        extend(lambda c: c.costs.coll_bytes),
        {k: extend(lambda c: c.costs.coll_by_kind.get(k, 0.0))
         for k in set().union(*(c.costs.coll_by_kind for c in at.values()))})
    return StepCount(costs, extend(lambda c: c.output_bytes),
                     extend(lambda c: c.temp_bytes), depths)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             donate: bool = True, overrides: dict = None,
             rule_overrides: dict = None, device: DeviceLike = None) -> dict:
    """Count one cell on the 16x16 (``multi_pod=False``) or 2x16x16 mesh;
    the reference's result keys (``code_bytes`` ``None``, no
    ``xla_cost_analysis``).  ``donate`` is the reference's flag and has no
    effect: the port's steps write their state in place."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import install_rules, make_production_mesh
    from repro_torch.launch.steps import build_cell
    dev = resolve_device(device)
    with fake_group():
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        chips = mesh.size()
        cfg = get_config(arch)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        cell = build_cell(arch, shape_name, cfg=cfg)
        rules = install_rules(mesh, cell.cfg, cell.shape.global_batch,
                              kind=cell.shape.kind)
        try:
            if rule_overrides:
                rules.update(rule_overrides)
                shd.set_rules(mesh=mesh, **rules)
            t0 = time.time()
            shardings = _to_shardings(mesh, cell.arg_logical, cell.arg_specs)
            arg_bytes = sum(_leaves(_map2(
                lambda s, sh: shard_bytes(mesh, s, sh), cell.arg_specs,
                shardings)))
            t_lower = time.time() - t0
            counted = count_cell(cell, dev, mesh)
            t_compile = time.time() - t0 - t_lower
            terms = roofline.analyze(counted.costs, cell.cfg, cell.shape,
                                     chips)
        finally:
            shd.clear_rules()
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "device": dev.type,
        "overrides": overrides or {},
        "rule_overrides": {k: list(v) if isinstance(v, tuple) else v
                           for k, v in (rule_overrides or {}).items()},
        "rules": {k: list(v) if isinstance(v, tuple) else v
                  for k, v in rules.items()},
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": int(counted.output_bytes),
            "temp_bytes": int(counted.temp_bytes),
            "code_bytes": None,
        },
        "depths_counted": list(counted.depths),
        "flops_per_chip": terms.flops,
        "hbm_bytes_per_chip": terms.hbm_bytes,
        "collective_bytes_per_chip": terms.coll_bytes,
        "collective_breakdown": terms.coll_breakdown,
        "model_flops": terms.model_flops,
        "roofline": terms.summary(),
        "status": "ok",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (hillclimb iterations)")
    ap.add_argument("--rule", action="append", default=[],
                    help="logical rule override key=value, e.g. dp=data,model")
    ap.add_argument("--tag", default="",
                    help="suffix for the result file name")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: cuda; 'cpu' "
                         "counts the kernels' plain versions)")
    args = ap.parse_args(argv)
    from repro_torch.configs import all_cells
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = _parse_override(v)
    rule_overrides = {}
    for kv in args.rule:
        k, v = kv.split("=", 1)
        parts = tuple(p for p in v.split(",") if p)
        rule_overrides[k] = (parts[0] if len(parts) == 1 else parts) \
            if parts else None

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells, skips = all_cells()
        for arch, shape, why in skips:
            print(f"SKIP {arch}:{shape} — {why}")
            (outdir / f"{arch}__{shape}__skip.json").write_text(
                json.dumps({"arch": arch, "shape": shape,
                            "status": "skipped", "reason": why}, indent=1))
    else:
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    with fake_group():
        for arch, shape in cells:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = outdir / f"{tag}.json"
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") == "ok":
                        print(f"SKIP (cached) {tag}")
                        continue
                print(f"=== {tag} ===", flush=True)
                try:
                    res: Any = run_cell(arch, shape, multi,
                                        overrides=overrides,
                                        rule_overrides=rule_overrides,
                                        device=args.device)
                    rf = res["roofline"]
                    print(f"  ok: compile={res['compile_s']}s "
                          f"bottleneck={rf['bottleneck']} "
                          f"t=(c {rf['t_compute_s']:.4f}, "
                          f"m {rf['t_memory_s']:.4f}, "
                          f"x {rf['t_collective_s']:.4f})s "
                          f"useful={rf['useful_flops_ratio']:.2f}",
                          flush=True)
                except Exception as e:
                    n_fail += 1
                    res = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi else "16x16",
                           "status": "failed",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-3000:]}
                    print(f"  FAILED: {type(e).__name__}: {str(e)[:300]}",
                          flush=True)
                path.write_text(json.dumps(res, indent=1, default=str))
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
