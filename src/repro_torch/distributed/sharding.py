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
import functools
import itertools
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

PyTree = Any
Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# Logical axis rules.  Model code names tensor dims with *logical* axes
# ("dp", "fsdp", "tp", "seq", ...); the launcher installs a mapping to
# physical mesh axes per (mesh, shape cell).
# ---------------------------------------------------------------------------
_RULES: dict = {}
_MESH = None
# the dry run's cost model (``launch.op_cost.CostMode``) while it counts a
# meshed step on whole fake tensors: hints become its constraints
_COST = None


def set_cost_tracker(mode):
    """Install ``mode`` (a ``launch.op_cost.CostMode`` or ``None``) as the
    one that sees the hints, ``distribute`` and ``gathered``; returns the
    one it replaces."""
    global _COST
    prev, _COST = _COST, mode
    return prev


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
        if _COST is not None:
            from repro_torch.launch.op_cost import spec_of_entries
            return _COST.constrain(x, spec_of_entries(spec_))
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
    """DTensor placements for ``spec_`` on ``mesh``: on each mesh dim that
    tensor dim ``d`` is sharded over ``Shard(d)``, or ``_StridedShard(d,
    split_factor=k)`` where the dim is split over axes against mesh order;
    ``Replicate()`` on the others.

    A dim sharded over several axes is major-first in the reference: over
    ``("model", "data")`` block ``i_model * |data| + i_data``.  DTensor
    splits a dim over its mesh dims in mesh-dim order, so an axis that
    comes later in mesh order but earlier in the spec is expressed by a
    ``_StridedShard`` on each earlier mesh dim, its ``split_factor`` the
    product of the sizes of those axes (``("model", "data")`` on a
    ``(data, model)`` mesh: ``_StridedShard(d, split_factor=|model|)`` on
    ``data``, ``Shard(d)`` on ``model``).  Such placements are checked
    against the reference's blocks for every mesh coordinate; a spec they
    do not give exactly raises ``NotImplementedError`` naming it, and no
    other layout is ever placed.
    """
    names = axis_names(mesh)
    return _placements(names, tuple(mesh.shape), tuple(spec_))


@functools.lru_cache(maxsize=None)
def _placements(names: Tuple[str, ...], shape: Tuple[int, ...], spec_: Spec
                ) -> Tuple[Any, ...]:
    sizes = dict(zip(names, shape))
    out: List[Any] = [Replicate() for _ in names]
    seen = set()
    strided = False
    for d, axes in enumerate(spec_):
        axes = _axes(axes)
        for j, a in enumerate(axes):
            if a not in sizes:
                raise ValueError(f"spec {spec_}: no mesh axis {a!r} in "
                                 f"{names}")
            if a in seen:
                raise ValueError(f"spec {spec_}: mesh axis {a!r} used twice")
            seen.add(a)
            m = names.index(a)
            # the axes before this one in the spec (more major) that DTensor
            # splits later (a later mesh dim)
            sf = math.prod(sizes[b] for b in axes[:j]
                           if names.index(b) > m)
            if sf == 1:
                out[m] = Shard(d)
            else:
                out[m] = _StridedShard(d, split_factor=sf)
                strided = True
    out = tuple(out)
    if strided and not _gives_reference_blocks(names, shape, spec_, out):
        raise NotImplementedError(
            f"spec {spec_}: DTensor placements {out} do not give every rank "
            f"the block the reference's (major-first) spec gives it on the "
            f"mesh {dict(sizes)}")
    return out


def _axes(axes) -> Tuple[str, ...]:
    return () if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))


def _gives_reference_blocks(names, shape, spec_, pls) -> bool:
    """Whether ``pls`` give each mesh coordinate the reference's block of
    a tensor whose every dim is a multiple of its shard count: along dim
    ``d`` over axes ``(a1, .., ak)`` block ``sum_j c(a_j) prod_{i>j}
    |a_i|``."""
    try:
        from torch.distributed.tensor._utils import \
            _compute_local_shape_and_global_offset as local_block
    except ImportError:
        return False
    # integer arithmetic on real tensors, outside any fake or counting mode
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return _blocks_match(local_block, names, shape, spec_, pls)


def _blocks_match(local_block, names, shape, spec_, pls) -> bool:
    sizes = dict(zip(names, shape))
    counts = [math.prod(sizes[a] for a in _axes(ax)) for ax in spec_]
    gshape = [2 * c for c in counts]
    for coord in itertools.product(*(range(n) for n in shape)):
        c = dict(zip(names, coord))
        lshape, off = local_block(gshape, shape, list(coord), pls)
        for d, ax in enumerate(spec_):
            idx = 0
            for a in _axes(ax):
                idx = idx * sizes[a] + c[a]
            blk = gshape[d] // counts[d]
            if (lshape[d], off[d]) != (blk, idx * blk):
                return False
    return True


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
    ``x`` lies on the mesh's device type already: nothing is moved here.

    ``x`` is wrapped as replicated (``DTensor.from_local``) and
    redistributed to ``spec_``, which only slices in the forward; so the
    result stays on ``x``'s autograd graph, and its backward gathers:
    ``x`` gets the whole gradient of the tensor every rank holds.
    (``distribute_tensor`` would return a leaf, and ``x`` would get no
    gradient.)"""
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor for a "
                         f"{mesh.device_type} mesh")
    pls = placements(mesh, spec_)
    if _COST is not None:
        return _COST.local_dtensor(x, mesh, pls)
    whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, pls)


def gathered(x: DTensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank: its local tensor where
    every mesh dim it is sharded over holds one device, else gathered."""
    if _COST is not None:
        return _COST.whole(x)
    mesh = x.device_mesh
    if all(not isinstance(p, Shard) or mesh.size(i) == 1
           for i, p in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()
