"""Multi-process jobs of the distribution tests, one subprocess each.

Not a test.  ``python tests/torch_dist_jobs.py JOB OUT_DIR`` starts the
job's gloo ranks (``torch.multiprocessing`` spawn, a ``FileStore`` in
OUT_DIR, no network), runs the JAX reference's side in this process with
8 host devices where the job has one, and writes its results as ``.npz``
files in OUT_DIR:

* ``moe``: ``moe_ffn_sharded`` on a 2 x 4 (data, model) mesh of 8 gloo
  ranks, expert-sharded and d_ff-sharded with ``n_real < E``, f32 and
  bf16, from plain tensors and from DTensors: its outputs, and the
  gradients of x, the router, gate, up and down for the output loss
  ``sum(out * r)`` and the aux loss separately (each rank's, whole),
  also under four planted faults (``MOE_FAULTS``, two of them in bf16
  too: ``MOE_BF16_FAULTS``); beside it the
  reference's ``shard_map`` ``moe_ffn_sharded`` and its ``jax.grad`` on
  a 2 x 4 mesh of 8 host devices, on the same numpy inputs
  (:func:`moe_inputs`, :func:`moe_loss_weights`): ``rank<r>.npz`` and
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
    import torch
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    # one host thread a rank: the ranks share the machine's cores
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)


def moe_loss_weights(seed: int = 1):
    """``r`` (T, d): the output loss is ``sum(out * r)`` in f32."""
    return np.random.default_rng(seed).standard_normal(
        (MOE_T, MOE_D)).astype(np.float32)


def moe_specs(es: bool):
    """The reference's in-specs of (x, router, gate, up, down) on the
    (data, model) mesh, FSDP over ``data``."""
    w = ("model", "data", None) if es else (None, "data", "model")
    wd = ("model", None, "data") if es else (None, "model", "data")
    return (("data", None), (None, None), w, w, wd)


def _sum_backward_sum():
    """The planted fault ``sum_backward_sum``: the sum over ``model``
    with a backward that all-reduces the gradient too (made in a rank,
    where torch is imported)."""
    import torch
    import torch.distributed._functional_collectives as funcol
    from repro_torch.models import moe

    class SumBackwardSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, group):
            ctx.group = group
            return moe._waited(funcol.all_reduce(t, "sum", group))

        @staticmethod
        def backward(ctx, g):
            return moe._waited(funcol.all_reduce(
                g.contiguous(), "sum", ctx.group)), None
    return SumBackwardSum


class _NoScale:
    """The planted fault ``router_one_partial``: the aux loss's part of
    the x and router gradients not scaled by 1 / |model|, so the one
    ``Partial(model)`` sum counts it |model| times."""

    @staticmethod
    def apply(t, scale):
        return t


def _distribute_tensor(x, mesh, spec_):
    """The planted fault ``distribute_tensor``: ``shd.distribute`` as it
    was, a leaf cut from x's graph."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as shd
    return distribute_tensor(x, mesh, shd.placements(mesh, spec_),
                             src_data_rank=None)


def _padded_routed(real):
    """The planted fault ``padded_routed``: the local dispatch without
    ``n_real``, the padded experts routed to and given a gradient."""
    def fn(*args, **kw):
        kw["n_real"] = None
        return real(*args, **kw)
    return fn


# the planted faults of the sharded MoE's gradient, all run expert-sharded
# in f32; those that count a part |model| times in bf16 as well
MOE_FAULTS = ("sum_backward_sum", "router_one_partial", "distribute_tensor",
              "padded_routed")
MOE_BF16_FAULTS = ("sum_backward_sum", "router_one_partial")


def _moe_fault(name):
    """(module, attribute, the stand-in made from the real one) of a
    planted fault."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe
    return {"sum_backward_sum": (moe, "_SumOverModel",
                                 lambda _: _sum_backward_sum()),
            "router_one_partial": (moe, "_ScaleGrad", lambda _: _NoScale),
            "distribute_tensor": (shd, "distribute",
                                  lambda _: _distribute_tensor),
            "padded_routed": (moe, "_local_dispatch_ffn",
                              _padded_routed)}[name]


def _moe_grads(moe, shd, mesh, args, kw, specs, form, loss):
    """The gradients of x, the router, gate, up and down of ``loss``
    (``out``: ``sum(out * r)`` in f32; ``aux``: the aux loss alone), each
    whole as this rank gets it: from plain tensors its leaves' (a missing
    gradient as zeros), from DTensors ``full_tensor`` of theirs."""
    import torch
    r = torch.from_numpy(moe_loss_weights())
    if form == "plain":
        leaves = [a.clone().requires_grad_() for a in args]
    else:
        leaves = [shd.distribute(a, mesh, s).detach().requires_grad_()
                  for a, s in zip(args, specs)]
    out, aux = moe.moe_ffn_sharded(*leaves, **kw)
    if form == "dtensor":
        out, aux = out.full_tensor(), aux.full_tensor()
    value = (out.float() * r).sum() if loss == "out" else aux
    value.backward()
    grads = []
    for a, leaf in zip(args, leaves):
        g = leaf.grad
        if g is None:
            g = torch.zeros_like(a)
        elif form == "dtensor":
            g = g.full_tensor()
        grads.append(g)
    return grads


GRAD_NAMES = ("x", "router", "gate", "up", "down")


def _moe_rank(rank: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    _init(rank, 8, out)
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    mesh = make_host_mesh(model_parallel=MOE_MESH[1], device="cpu")
    res = {}

    def inputs(dt):
        args = [torch.from_numpy(a) for a in moe_inputs()]
        return [a if i == 1 else a.to(getattr(torch, dt))
                for i, a in enumerate(args)]

    def kwargs(es):
        return dict(top_k=MOE_K, capacity_factor=MOE_CF, mesh=mesh,
                    dp_axes=("data",), model_axis="model", fsdp_axes="data",
                    expert_sharded=es, n_real=MOE_N_REAL)

    def record(prefix, grads, dtype):
        for name, g in zip(GRAD_NAMES, grads):
            assert g.dtype == (torch.float32 if name == "router"
                               else getattr(torch, dtype)), (prefix, name)
            res[f"{prefix}/{name}"] = g.float()

    for (mode, es), dt in itertools.product(MOE_MODES.items(), MOE_DTYPES):
        args = inputs(dt)
        key = f"{mode}/{dt}"
        kw, specs = kwargs(es), moe_specs(es)
        with torch.no_grad():
            out_, aux = moe.moe_ffn_sharded(*args, **kw)
            res[f"{key}/plain/out"] = out_.float()
            res[f"{key}/plain/aux"] = aux
            dts = [shd.distribute(a, mesh, s) for a, s in zip(args, specs)]
            out_, aux = moe.moe_ffn_sharded(*dts, **kw)
            res[f"{key}/dtensor/out"] = out_.full_tensor().float()
            res[f"{key}/dtensor/aux"] = aux.full_tensor()
            res[f"{key}/dtensor/sharded"] = torch.tensor(
                [p.is_shard(0) for p in out_.placements])
        for form, loss in itertools.product(("plain", "dtensor"),
                                            ("out", "aux")):
            record(f"{key}/{form}/grad/{loss}",
                   _moe_grads(moe, shd, mesh, args, kw, specs, form, loss),
                   dt)
    # the planted faults, on the expert-sharded case
    kw, specs = kwargs(True), moe_specs(True)
    for dt, faults in (("float32", MOE_FAULTS),
                       ("bfloat16", MOE_BF16_FAULTS)):
        args = inputs(dt)
        for fault in faults:
            obj, attr, make = _moe_fault(fault)
            real = getattr(obj, attr)
            setattr(obj, attr, make(real))
            try:
                for form, loss in itertools.product(("plain", "dtensor"),
                                                    ("out", "aux")):
                    record(f"fault/{fault}/{dt}/{form}/grad/{loss}",
                           _moe_grads(moe, shd, mesh, args, kw, specs, form,
                                      loss), dt)
            finally:
                setattr(obj, attr, real)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()})
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
    r = jnp.asarray(moe_loss_weights())
    res = {}
    for (mode, es), dt in itertools.product(MOE_MODES.items(), MOE_DTYPES):
        args = [jnp.asarray(a) if i == 1 else jnp.asarray(a).astype(dt)
                for i, a in enumerate(moe_inputs())]
        mode = f"{mode}/{dt}"

        def fn(*a, es=es):
            return moe.moe_ffn_sharded(
                *a, top_k=MOE_K, capacity_factor=MOE_CF, mesh=mesh,
                dp_axes=("data",), model_axis="model", fsdp_axes="data",
                expert_sharded=es, n_real=MOE_N_REAL)

        losses = {"out": lambda *a, fn=fn: jnp.sum(
                      fn(*a)[0].astype(jnp.float32) * r),
                  "aux": lambda *a, fn=fn: fn(*a)[1]}
        with mesh:
            got, aux = jax.jit(fn)(*args)
            for loss, f in losses.items():
                grads = jax.jit(jax.grad(f, argnums=tuple(range(5))))(*args)
                for name, g in zip(GRAD_NAMES, grads):
                    assert g.dtype == args[GRAD_NAMES.index(name)].dtype
                    res[f"{mode}/reference/grad/{loss}/{name}"] = \
                        np.asarray(g.astype(jnp.float32))
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
