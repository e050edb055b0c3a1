"""Sharding rules: map parameter / activation names onto the production
mesh (the port of ``repro/distributed/sharding.py``).

Mesh axes (``launch/mesh.py``): ``data`` (FSDP + batch), ``model``
(TP / EP), and optionally ``pod`` (multi-pod data parallelism).  A mesh is
a ``torch.distributed.DeviceMesh`` whose ``mesh_dim_names`` are those
axes; the helpers read it only through its dim names and sizes, so a mesh
under a real group (NCCL, gloo) or under the ``fake`` backend (no
devices, for the production shapes) serves alike.

A *spec* is the content of the reference's ``PartitionSpec``: a tuple
with one entry a tensor dim, each ``None`` (replicated), a mesh-axis name
or a tuple of them (sharded over their product, the first the major one).
A one-axis tuple is written as the name and an empty one as ``None``, as
``PartitionSpec`` normalises them, so ``tuple(P(...))`` of the reference
equals the port's spec.  :func:`placements` turns a spec into DTensor
placements.

With no rules installed (one device, no mesh) every hint returns its
tensor unchanged; a ``DTensor`` is redistributed to the hinted spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

PyTree = Any
Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# Logical axis rules.  Model code names tensor dims with *logical* axes
# ("dp", "fsdp", "tp", "seq", ...); the launcher installs a mapping to
# physical mesh axes per (mesh, shape cell).
# ---------------------------------------------------------------------------
_RULES: dict = {}
_MESH = None


def set_rules(mesh=None, **mapping) -> None:
    """Install logical -> physical axis rules (None values clear an axis)."""
    global _RULES, _MESH
    _RULES = {k: v for k, v in mapping.items() if v is not None}
    if mesh is not None:
        _MESH = mesh


def clear_rules() -> None:
    global _RULES, _MESH
    _RULES = {}
    _MESH = None


def get_rules() -> dict:
    return dict(_RULES)


def active_mesh():
    return _MESH


def entry(axes) -> Any:
    """One spec entry as ``PartitionSpec`` normalises it: a one-axis tuple
    is its name, an empty tuple ``None``."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    return axes


def spec(*entries) -> Spec:
    """A spec from its entries (``PartitionSpec(*entries)``)."""
    return tuple(entry(e) for e in entries)


def logical(*names: Optional[str]) -> Spec:
    """A spec from logical axis names via the installed rules."""
    return spec(*[_RULES.get(n) if n else None for n in names])


def hint(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Logical sharding constraint; the tensor itself without rules."""
    if not _RULES:
        return x
    return shard_hint(x, logical(*names))


def shard_hint(x: torch.Tensor, spec_: Spec) -> torch.Tensor:
    """A ``DTensor`` redistributed to ``spec_`` on its own mesh; a plain
    tensor (one device, or each rank's whole copy) unchanged."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec_))


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------
def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size (the reference's ``mesh.shape``)."""
    return dict(zip(axis_names(mesh), mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """All mesh axes used for data parallelism (pod-major)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def data_parallel_size(mesh) -> int:
    size = 1
    for a in data_axes(mesh):
        size *= axis_size(mesh, a)
    return size


def batch_spec(mesh, global_batch: int) -> Spec:
    """Widest divisible data-parallel sharding for a batch dimension.

    Prefers pod x data; falls back to data alone; replicates batch-1
    latency shapes.
    """
    axes = data_axes(mesh)
    if axes and global_batch % data_parallel_size(mesh) == 0:
        return spec(axes)
    if "data" in axis_names(mesh) and \
            global_batch % axis_size(mesh, "data") == 0:
        return spec("data")
    return ()


def divisible(n: int, mesh, axis: str) -> bool:
    return axis in axis_names(mesh) and n % axis_size(mesh, axis) == 0


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_prod(mesh, axes) -> int:
    """Devices a spec entry shards over: the product of its axes' sizes."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return axis_size(mesh, axes)
    return math.prod(axis_size(mesh, a) for a in axes)


def fit(mesh, spec_: Spec, shape) -> Spec:
    """``spec_`` for a tensor of ``shape``: an entry whose devices do not
    divide its dim, or past the tensor's dims, replicated (``None``)."""
    return spec(*(None if axes is None or i >= len(shape)
                  or shape[i] % axis_prod(mesh, axes) else axes
                  for i, axes in enumerate(spec_)))


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------
def placements(mesh, spec_: Spec) -> Tuple[Any, ...]:
    """DTensor placements for ``spec_`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` is sharded over, ``Replicate()`` on the
    others.

    A dim sharded over several axes is major-first in the reference: over
    ``("model", "data")`` block ``i_model * |data| + i_data``.  DTensor
    splits a dim over its mesh dims in mesh-dim order instead, so both
    give every rank the same block only when the axes of more than one
    device come in mesh-dim order; otherwise this raises
    ``NotImplementedError`` naming the spec, and never places another
    layout.  An axis of one device moves no block and may stand anywhere.
    """
    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    out: List[Any] = [Replicate() for _ in names]
    seen = set()
    for d, axes in enumerate(spec_):
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        dims = []
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec_}: no mesh axis {a!r} in "
                                 f"{names}")
            if a in seen:
                raise ValueError(f"spec {spec_}: mesh axis {a!r} used twice")
            seen.add(a)
            dims.append(names.index(a))
        live = [m for m in dims if sizes[names[m]] > 1]
        if live != sorted(live):
            raise NotImplementedError(
                f"spec {spec_}: tensor dim {d} is sharded over {axes} "
                f"major-first, which DTensor's Shard placements (split in "
                f"mesh-dim order {names}) do not express")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``); the DTensor
    placements are computed when asked for."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.mesh, self.spec)


def named(mesh, spec_: Spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec_))


def is_spec(x) -> bool:
    """A spec leaf: a plain tuple (not a NamedTuple) of ``None``, axis
    names, and tuples of axis names."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) or (
            isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def map_specs(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the spec leaves of ``tree`` (dicts, NamedTuples and
    other tuples around :func:`is_spec` leaves) and the nodes of ``rest``
    at the same places; any other leaf of ``tree`` is passed as it is."""
    if is_spec(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, getattr(tree, f),
                                      *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, tuple):
        return tuple(map_specs(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_shardings(mesh, spec_tree: PyTree) -> PyTree:
    return map_specs(lambda s: named(mesh, s), spec_tree)


def distribute(x: torch.Tensor, mesh, spec_: Spec) -> DTensor:
    """``x``, which every rank holds whole, as a DTensor of ``spec_``:
    each rank keeps its own block of its own copy (no communication).
    ``x`` lies on the mesh's device type already: nothing is moved here."""
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor for a "
                         f"{mesh.device_type} mesh")
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(mesh, spec_),
                             src_data_rank=None)


def gathered(x: DTensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank: its local tensor where
    every mesh dim it is sharded over holds one device, else gathered."""
    mesh = x.device_mesh
    if all(not isinstance(p, Shard) or mesh.size(i) == 1
           for i, p in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()
