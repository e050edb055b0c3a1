"""Production mesh construction + logical-rule installation (the port of
``repro/launch/mesh.py``).

A mesh is a ``DeviceMesh`` over the ranks of the initialised default
process group; building one never starts a group.  The production meshes
need a world of 256 or 512 ranks: on one machine that is the ``fake``
backend (``init_process_group("fake", store=FakeStore(), rank=0,
world_size=512)``), which places no data and moves none.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd


def mesh_over(shape, axes, device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 ..
    prod(shape) - 1 of the default group, on ``device``'s type (``None``:
    CUDA, raising without it)."""
    dev = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs an initialised "
                           f"process group of at least {n} ranks")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                           f"process group has {world}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """16x16 single pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_over(shape, axes, device)


def make_host_mesh(model_parallel: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over the initialised world (tests, local
    drivers): ``model_parallel`` clipped to the world, the rest data."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group")
    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    return mesh_over((n // mp, mp), ("data", "model"), device)


def install_rules(mesh, cfg, global_batch: int, kind: str = "train") -> dict:
    """Install logical -> physical axis rules for one (mesh, config, shape).

    * dp   — batch dims: widest divisible data-parallel combination
    * fsdp — ZeRO weight sharding: 'data' (+ 'pod' for configs flagged
             zero_over_pods)
    * tp   — tensor / expert parallel dims: 'model'
    * seq  — decode KV-cache sequence dim: 'model' (+ 'data' when the batch
             cannot use it, e.g. batch-1 long-context decode)
    """
    axes = set(shd.axis_names(mesh))
    dp_spec = shd.batch_spec(mesh, global_batch)
    dp = dp_spec[0] if len(dp_spec) else None

    fsdp = "data"
    if getattr(cfg, "zero_over_pods", False) and "pod" in axes:
        fsdp = ("data", "pod")

    seq = "model"
    if dp is None and "data" in axes:
        seq = ("model", "data")

    tp_kv = None
    kv = getattr(cfg, "n_kv_heads", 0)
    if kv and kv % shd.axis_size(mesh, "model") == 0:
        tp_kv = "model"

    tp = "model"
    if kind == "decode" and not getattr(cfg, "moe", False):
        # decode reads every weight once per token: weights sharded over
        # both axes, no per-step ZeRO regathers; MoE expert dims do not
        # divide model x data, so MoE archs keep the train layout
        fsdp = None
        tp = tuple(a for a in ("model", "data") if a in axes)

    # decode-cache layout: KV-head sharding keeps the per-token cache
    # update local; sequence sharding when KV heads do not divide 'model'
    cache_kv, cache_seq = (tp_kv, None) if tp_kv else (None, seq)

    # spatial parallelism: when the batch cannot use the data axis, shard
    # the image / latent height instead
    sp = "data" if dp is None else None

    rules = dict(dp=dp, fsdp=fsdp, tp=tp, seq=seq, tp_kv=tp_kv,
                 cache_kv=cache_kv, cache_seq=cache_seq, sp=sp)
    shd.set_rules(mesh=mesh, **rules)
    return rules
