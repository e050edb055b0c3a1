"""Elastic scaling / failure recovery: remesh parameters across device
counts (the port of ``repro/training/elastic.py``).

On a cluster the control plane detects a lost host, restarts the job with
the surviving N' ranks, and this module rebuilds the mesh and re-places
the checkpointed state under the new sharding: data parallelism shrinks,
tensor parallelism is kept while the model axis still fits.  The mesh is
a ``DeviceMesh`` over the first dp x mp ranks of the default group; the
state is placed as DTensors, each rank keeping its block of the copy it
restored (no communication).
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.device import DeviceLike
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import mesh_over

PyTree = Any


def surviving_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """(data, model) of the largest mesh that fits ``n_devices``: the
    model axis halved until it divides them."""
    mp = model_parallel
    while mp > 1 and (n_devices % mp != 0 or mp > n_devices):
        mp //= 2
    return n_devices // mp, mp


def surviving_mesh(n_devices: int, model_parallel: int,
                   device: DeviceLike = None):
    """Largest (data, model) mesh that fits ``n_devices`` ranks, over the
    first of them, on ``device``'s type (``None``: CUDA)."""
    return mesh_over(surviving_shape(n_devices, model_parallel),
                     ("data", "model"), device)


def replace_mesh(tree: PyTree, spec_tree: PyTree, mesh) -> PyTree:
    """Re-place a host-resident tree (every rank holding all of it) onto a
    (new) mesh as DTensors, each leaf copied to the mesh's device type.

    ``spec_tree`` holds specs aligned with ``tree`` (tuples of mesh-axis
    names); an axis whose size does not divide its dim is replicated.
    """
    def leaf(spec_, x):
        spec_ = tuple(spec_) if isinstance(spec_, tuple) else ()
        return shd.distribute(x.to(mesh.device_type), mesh,
                              shd.fit(mesh, spec_, x.shape))

    return shd.map_specs(leaf, spec_tree, tree)


def shrink_batch(global_batch: int, old_dp: int, new_dp: int) -> int:
    """Keep the per-device batch constant when data parallelism shrinks."""
    per_dev = max(1, global_batch // old_dp)
    return per_dev * new_dp
