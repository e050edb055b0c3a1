"""Multi-process jobs of the distribution tests, one subprocess each.

Not a test.  ``python tests/torch_dist_jobs.py JOB OUT_DIR`` starts the
job's gloo ranks (``torch.multiprocessing`` spawn, a ``FileStore`` in
OUT_DIR, no network), runs the JAX reference's side in this process with
8 host devices where the job has one, and writes its results as ``.npz``
files in OUT_DIR:

* ``moe``: ``moe_ffn_sharded`` on a 2 x 4 (data, model) mesh of 8 gloo
  ranks, expert-sharded and d_ff-sharded with ``n_real < E``, f32 and
  bf16, from plain tensors and from DTensors; beside it the reference's
  ``shard_map``
  ``moe_ffn_sharded`` on a 2 x 4 mesh of 8 host devices, on the same
  numpy inputs (:func:`moe_inputs`): ``ranks.npz`` (rank 0's) and
  ``reference.npz``.
* ``elastic``: on 4 gloo ranks a tree placed on a (4, 1) mesh, gathered
  and checkpointed by rank 0, restored by every rank and re-placed on the
  surviving (2, 1) mesh of ranks 0-1; each rank's local blocks, and the
  whole tensors gathered on the new mesh: ``rank<r>.npz``.

JAX is imported only in the parent, after ``XLA_FLAGS`` asks for 8
devices; the ranks import torch and the port alone.
"""
from __future__ import annotations

import itertools
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# moe: T tokens of width d, E experts of which N_REAL are real, top-K,
# d_ff F; a capacity factor that drops copies
MOE_T, MOE_D, MOE_E, MOE_F, MOE_K, MOE_N_REAL, MOE_CF = 32, 16, 8, 24, 2, 6, 1.25
MOE_MESH = (2, 4)
MOE_MODES = {"expert": True, "ffn": False}
# the inputs' dtype (the router stays f32, as Granite's)
MOE_DTYPES = ("float32", "bfloat16")
ELASTIC_RANKS = 4


def moe_inputs(seed: int = 0):
    """x (T, d), router (d, E), gate / up (E, d, f), down (E, f, d), f32."""
    rng = np.random.default_rng(seed)
    n = lambda *s, scale=0.1: (rng.standard_normal(s) * scale  # noqa: E731
                               ).astype(np.float32)
    return (n(MOE_T, MOE_D, scale=1.0), n(MOE_D, MOE_E), n(MOE_E, MOE_D, MOE_F),
            n(MOE_E, MOE_D, MOE_F), n(MOE_E, MOE_F, MOE_D))


def elastic_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32)}


def _init(rank: int, world: int, out: str) -> None:
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)


def _moe_rank(rank: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    _init(rank, 8, out)
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    mesh = make_host_mesh(model_parallel=MOE_MESH[1], device="cpu")
    res = {}
    for (mode, es), dt in itertools.product(MOE_MODES.items(), MOE_DTYPES):
        args = [torch.from_numpy(a) for a in moe_inputs()]
        args = [a if i == 1 else a.to(getattr(torch, dt))
                for i, a in enumerate(args)]
        mode = f"{mode}/{dt}"
        kw = dict(top_k=MOE_K, capacity_factor=MOE_CF, mesh=mesh,
                  dp_axes=("data",), model_axis="model", fsdp_axes="data",
                  expert_sharded=es, n_real=MOE_N_REAL)
        out_, aux = moe.moe_ffn_sharded(*args, **kw)
        res[f"{mode}/plain/out"] = out_.float()
        res[f"{mode}/plain/aux"] = aux
        w = ("model", "data", None) if es else (None, "data", "model")
        wd = ("model", None, "data") if es else (None, "model", "data")
        specs = (("data", None), (None, None), w, w, wd)
        dts = [shd.distribute(a, mesh, s) for a, s in zip(args, specs)]
        out_, aux = moe.moe_ffn_sharded(*dts, **kw)
        res[f"{mode}/dtensor/out"] = out_.full_tensor().float()
        res[f"{mode}/dtensor/aux"] = aux.full_tensor()
        res[f"{mode}/dtensor/sharded"] = torch.tensor(
            [p.is_shard(0) for p in out_.placements])
    if rank == 0:
        np.savez(os.path.join(out, "ranks.npz"),
                 **{k: v.numpy() for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _moe_reference(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, SRC)
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.models import moe
    mesh = jax.make_mesh(MOE_MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    res = {}
    for (mode, es), dt in itertools.product(MOE_MODES.items(), MOE_DTYPES):
        args = [jnp.asarray(a) if i == 1 else jnp.asarray(a).astype(dt)
                for i, a in enumerate(moe_inputs())]
        mode = f"{mode}/{dt}"
        with mesh:
            got, aux = jax.jit(lambda *a: moe.moe_ffn_sharded(
                *a, top_k=MOE_K, capacity_factor=MOE_CF, mesh=mesh,
                dp_axes=("data",), model_axis="model", fsdp_axes="data",
                expert_sharded=es, n_real=MOE_N_REAL))(*args)
        res[f"{mode}/reference/out"] = np.asarray(got.astype(jnp.float32))
        res[f"{mode}/reference/aux"] = np.asarray(aux)
    np.savez(os.path.join(out, "reference.npz"), **res)


def _elastic_rank(rank: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    _init(rank, ELASTIC_RANKS, out)
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.elastic import (replace_mesh, shrink_batch,
                                              surviving_mesh)
    tree = {k: torch.from_numpy(v) for k, v in elastic_tree().items()}
    specs = {"w": ("data", None), "b": ("data",)}
    mesh_a = surviving_mesh(ELASTIC_RANKS, 1, device="cpu")
    placed = replace_mesh(tree, specs, mesh_a)
    res = {"a/w_local": placed["w"].to_local(),
           "a/b_local": placed["b"].to_local(),
           "a/shape": torch.tensor(mesh_a.shape)}
    whole = {k: v.full_tensor() for k, v in placed.items()}
    if rank == 0:
        ckpt.save_checkpoint(os.path.join(out, "ckpt"), 10, whole)
    dist.barrier()
    restored, _ = ckpt.restore_latest(os.path.join(out, "ckpt"),
                                      {k: torch.zeros_like(v)
                                       for k, v in tree.items()})
    # two ranks lost: the surviving mesh holds ranks 0 and 1
    mesh_b = surviving_mesh(ELASTIC_RANKS // 2, 1, device="cpu")
    res["b/shape"] = torch.tensor(mesh_b.shape)
    res["batch"] = torch.tensor(shrink_batch(256, ELASTIC_RANKS,
                                             ELASTIC_RANKS // 2))
    if mesh_b.get_coordinate() is not None:
        placed_b = replace_mesh(restored, specs, mesh_b)
        res["b/w_local"] = placed_b["w"].to_local()
        res["b/b_local"] = placed_b["b"].to_local()
        res["b/w"] = placed_b["w"].full_tensor()
        res["b/b"] = placed_b["b"].full_tensor()
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


JOBS = {"moe": (8, _moe_rank, _moe_reference),
        "elastic": (ELASTIC_RANKS, _elastic_rank, None)}


def _rank(rank: int, job: str, out: str) -> None:
    JOBS[job][1](rank, out)


def main() -> int:
    job, out = sys.argv[1], sys.argv[2]
    import torch.multiprocessing as mp
    n, _, reference = JOBS[job]
    ctx = mp.start_processes(_rank, args=(job, out), nprocs=n, join=False,
                             start_method="spawn")
    if reference is not None:
        reference(out)
    while not ctx.join():
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
