"""Per-chip cost of one step from the operators it dispatches (the
counterpart of ``repro/launch/hlo_cost.py``, which parses the compiled
per-device HLO: there is no HLO here).

A step runs once under ``FakeTensorMode`` (shapes and dtypes, no data,
no launch) inside :class:`CostMode`, a ``TorchDispatchMode`` that sees
every ATen and ``repro_torch`` operator and counts what one chip runs:

* **flops** — matrix products and convolutions (2 per multiply-add, from
  ``torch.utils.flop_counter``'s formulas) and the kernels' own formulas
  (:mod:`repro_torch.kernels.library`); like the reference's, no other
  operator counts.
* **bytes** — each operator that moves data reads its tensor inputs and
  writes its outputs once (a tensor that is both, as in an in-place
  write, once).  Views, metadata and ``wait_tensor`` are free, as
  ``hlo_cost``'s ``_FREE_OPS`` makes tuples and bitcasts free.
* **coll_bytes** — per-chip result bytes of each collective, by the
  reference's five kinds.

**Unmeshed** (``mesh=None``) every tensor is whole: the counts are one
chip's.  **On a mesh** the step runs on whole-size (global) fake tensors
and each carries a spec — the mesh axes that split each of its dims, set
on the arguments from their shardings and by the models' sharding hints
(``distributed.sharding.shard_hint``), and propagated operator by
operator as SPMD partitioning would: elementwise results follow their
largest operand; a view maps its operand's split dims; a product splits
its result by its operands' row and column axes, gathers a weight split
along the contraction (``all-gather``) and sums partial products split
along it on both sides (``all-reduce``); a reduction over a split dim
sums across it (``all-reduce``); a hint that unsplits a dim gathers it.
Each operator is then charged 1 / (the devices its result is split over)
of its work and each tensor 1 / (its shard count) of its bytes: rank 0's
share, the same on every rank of an even split.  Where the model itself
runs per-rank code (the sharded MoE's ``local_map`` body on each rank's
blocks), its operators are counted as they run, on local shapes, and its
functional collectives (``_c10d_functional``) by their result bytes.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed.tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
_DTENSOR = torch.distributed.tensor.DTensor
Axes = Tuple[str, ...]
DimSpec = Tuple[Axes, ...]

# no data moved: metadata, allocation without a fill, waits
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.detach.default, aten.alias.default,
         aten.lift_fresh.default, aten._local_scalar_dense.default,
         aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
         aten.sym_storage_offset.default, aten.is_same_size.default,
         aten.resize_.default, aten.set_.source_Storage,
         aten.set_.source_Storage_storage_offset}
_COLL_KINDS = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
# reads of selected rows (the table, args[0], touched only there)
_GATHERS = {aten.embedding.default, aten.index_select.default,
            aten.gather.default, aten.index.Tensor}
# in-place writes of selected rows: the position of the source
_SCATTERS = {aten.index_add_.default: 3, aten.index_put_.default: 2,
             aten.index_copy_.default: 3, aten.scatter_.src: 3,
             aten.scatter_add_.default: 3, aten.scatter_reduce_.two: 3}
_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}
_REDUCTIONS = {aten.sum.dim_IntList, aten.mean.dim, aten.amax.default,
               aten.amin.default, aten.max.dim, aten.min.dim,
               aten.logsumexp.default, aten.var.correction,
               aten.std.correction, aten.var_mean.correction,
               aten.prod.dim_int, aten.any.dim, aten.all.dim,
               aten.argmax.default, aten.argmin.default, aten.cumsum.default,
               aten._softmax.default, aten._log_softmax.default,
               aten.sort.default, aten.sort.stable, aten.topk.default,
               aten.cummax.default, aten.argsort.default,
               aten.argsort.stable}


@dataclasses.dataclass
class Costs:
    """Per-chip FLOPs, bytes moved and collective bytes (by kind), as
    ``hlo_cost.Costs``."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Costs"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.coll_bytes += o.coll_bytes
        for k, v in o.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v
        return self

    def scaled(self, m: float) -> "Costs":
        return Costs(self.flops * m, self.bytes * m, self.coll_bytes * m,
                     {k: v * m for k, v in self.coll_by_kind.items()})

    def collective(self, kind: str, nbytes: float) -> None:
        self.coll_bytes += nbytes
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + nbytes


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an operator's arguments or results: (nested) tuples,
    lists and dicts of them (a faster ``tree_flatten``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _is_dtensor(t) -> bool:
    return isinstance(t, _DTENSOR)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s data: a broadcast dim (stride 0, from
    ``expand``) is read once, not once a position."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts one step's per-chip :class:`Costs` (see the module's text);
    ``mesh_sizes`` maps mesh axes to their sizes (``None``: one chip).
    Also tracks the bytes of the storages the step allocates that are
    alive at once (``peak_bytes``, per chip)."""

    def __init__(self, mesh_sizes: Optional[Dict[str, int]] = None):
        super().__init__()
        self.sizes = dict(mesh_sizes or {})
        self.costs = Costs()
        self.live = 0
        self.peak_bytes = 0
        self._gen = 0           # reset() starts a new generation of storages
        # (operator, its operands' whole shapes, its result's shape on one
        # chip, FLOPs a chip) of each product and convolution
        self.products: List[Tuple[str, tuple, tuple, float]] = []

    def reset(self) -> None:
        """Forget what was counted so far (the set-up before a step)."""
        self.costs = Costs()
        self.products = []
        self.peak_bytes = self.live = 0
        self._gen += 1

    # -- specs ---------------------------------------------------------------
    def spec(self, t: torch.Tensor) -> DimSpec:
        s = getattr(t, "_cost_spec", None)
        if s is None or len(s) != t.dim():
            return ((),) * t.dim()
        return s

    def set_spec(self, t: torch.Tensor, spec: Sequence[Axes]) -> None:
        if self.sizes and isinstance(t, torch.Tensor):
            spec = tuple(tuple(a) for a in spec)
            t._cost_spec = spec if any(spec) else None

    def shards(self, spec: DimSpec) -> int:
        return math.prod(self.sizes[a] for axes in spec for a in axes)

    def local_shape(self, t: torch.Tensor) -> Tuple[int, ...]:
        """``t``'s block on one chip."""
        return tuple(n // math.prod(self.sizes[a] for a in axes)
                     for n, axes in zip(t.shape, self.spec(t)))

    def local_bytes(self, t: torch.Tensor) -> float:
        return _nbytes(t) / self.shards(self.spec(t))

    def _fits(self, size: int, axes: Axes) -> bool:
        return bool(axes) and size % math.prod(self.sizes[a] for a in axes) \
            == 0

    # -- the dispatch hook -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(_is_dtensor(t) for t in ins):
            return out      # its local operators come through here too
        outs = _tensors(out)
        # a per-rank region (a local_map body): its tensors are blocks,
        # counted as they are, and what they make is a block too
        local = any(getattr(t, "_cost_local", False) for t in ins)
        if local:
            for t in outs:
                t._cost_local = True
        c = Costs()
        name = func.__name__
        if func.namespace == "_c10d_functional":
            self._collective(c, func, outs)
        elif func in _FREE or func.is_view or func.namespace == "prim" or \
                name.startswith("wait_tensor"):
            if self.sizes and not local:
                self._view_specs(func, args, kwargs, ins, outs)
        else:
            self._compute(c, func, args, kwargs, ins, outs, out, local)
        self._track(func, ins, outs)
        self.costs += c
        return out

    def _track(self, func, ins, outs) -> None:
        """Bytes of live storages: each output that aliases no input is a
        new allocation until its tensor object dies."""
        if func.is_view:
            return
        ids = {id(t) for t in ins}
        for t in outs:
            if id(t) in ids or _is_dtensor(t):
                continue
            n = self.local_bytes(t)
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(t, self._free, n, self._gen)

    def _free(self, n: float, gen: int) -> None:
        if gen == self._gen:
            self.live -= n

    def _collective(self, c: Costs, func, outs) -> None:
        name = func.overloadpacket.__name__
        if name in _COLL_KINDS:
            c.collective(_COLL_KINDS[name],
                         float(sum(self.local_bytes(t) for t in outs)))

    # -- operators that compute --------------------------------------------------
    def _compute(self, c: Costs, func, args, kwargs, ins, outs, out,
                 local: bool = False) -> None:
        work = 1
        if self.sizes and not local:
            work = self._propagate(c, func, args, kwargs, ins, outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            c.flops = flop_registry[packet](*args, **kwargs,
                                            out_val=out) / work
        if c.flops:
            self.products.append((
                func.overloadpacket.__name__,
                tuple(tuple(t.shape) for t in ins),
                self.local_shape(outs[0]), c.flops))
        seen, total = set(), 0.0
        skip = self._rows_only(func, args)
        for t in ins + outs:
            if id(t) not in seen:
                seen.add(id(t))
                if t is skip:
                    # only the rows read or written: a gather reads as many
                    # as it returns, a scatter reads and writes its source's
                    total += self.local_bytes(outs[0]) if func in _GATHERS \
                        else 2 * self.local_bytes(args[_SCATTERS[func]])
                else:
                    total += self.local_bytes(t)
        c.bytes = total

    @staticmethod
    def _rows_only(func, args):
        """The table an indexed read or write touches only in part: a
        gather's source (not its whole size), an in-place scatter's
        target."""
        if func in _GATHERS:
            return args[0]
        if func in _SCATTERS and isinstance(args[_SCATTERS[func]],
                                            torch.Tensor):
            return args[0]
        return None

    def _propagate(self, c: Costs, func, args, kwargs, ins, outs) -> int:
        """Set the outputs' specs, charge the collectives the operator
        needs, and return the number of devices its work is split over."""
        if func in _MATMULS:
            return self._matmul(c, func, args, outs[0])
        if func == aten.convolution.default:
            return self._conv(c, args, outs[0])
        if func == aten.convolution_backward.default:
            return self._conv_bwd(c, args, outs)
        if func in (aten.embedding.default,):
            w, ids = args[0], args[1]
            ws, is_ = self.spec(w), self.spec(ids)
            spec = is_ + (ws[1],)
            self.set_spec(outs[0], self._dedup(spec))
            if ws[0]:       # rows split: a masked local gather, then a sum
                c.collective("all-reduce", self.local_bytes(outs[0]))
            return self.shards(self.spec(outs[0]))
        if func in _REDUCTIONS:
            return self._reduction(c, func, args, ins, outs)
        if func in (aten._unsafe_view.default, aten.reshape.default,
                    aten.view.default) and ins:
            self.set_spec(outs[0], self._reshape(
                ins[0].shape, self.spec(ins[0]), outs[0].shape))
            return self.shards(self.spec(outs[0]))
        if func in (aten.cat.default, aten.stack.default):
            return self._cat(func, args, outs)
        # in place: the written tensor keeps its spec
        if outs and ins and outs[0] is ins[0]:
            return self.shards(self.spec(outs[0]))
        for t in outs:
            self.set_spec(t, self._follow(t, ins))
        return max([self.shards(self.spec(t)) for t in outs] or [1])

    def _dedup(self, spec) -> DimSpec:
        """``spec`` with each device split kept on its first dim only."""
        seen: List[str] = []
        out = []
        for axes in spec:
            keep = []
            for a in axes:
                if not self._clash(a, seen):
                    keep.append(a)
                    seen.append(a)
            out.append(tuple(keep))
        return tuple(out)

    def _follow(self, t: torch.Tensor, ins) -> DimSpec:
        """An elementwise result's spec: dim by dim from the right, the
        axes of the first operand (largest first) whose dim has the
        result's size there and is split."""
        ranked = sorted((x for x in ins if x.dim()), key=lambda x: -x.numel())
        spec: List[Axes] = []
        for i in range(1, t.dim() + 1):
            axes: Axes = ()
            for x in ranked:
                if x.dim() >= i and x.shape[-i] == t.shape[-i]:
                    a = self.spec(x)[-i]
                    if a and self._fits(t.shape[-i], a):
                        axes = a
                        break
            spec.append(axes)
        return self._dedup(tuple(reversed(spec)))

    def _gather(self, c: Costs, t: torch.Tensor, spec: DimSpec,
                keep: DimSpec) -> None:
        """Charge an all-gather of ``t`` from ``spec`` to ``keep``."""
        if spec != keep:
            c.collective("all-gather", _nbytes(t) / self.shards(keep))

    def _matmul(self, c: Costs, func, args, out) -> int:
        if func in (aten.addmm.default, aten.baddbmm.default):
            a, b = args[1], args[2]
        else:
            a, b = args[0], args[1]
        sa, sb = self.spec(a), self.spec(b)
        batch: Tuple[Axes, ...] = ()
        if a.dim() == 3:
            batch = (sa[0] or sb[0],)
        m_ax, ka, kb, n_ax = sa[-2], sa[-1], sb[-2], sb[-1]
        used: List[str] = [x for ax in batch for x in ax]
        m_ax = self._free_of(m_ax, used)
        used += m_ax
        partial: Axes = ()
        if ka and ka == kb and self._free_of(ka, used) == ka:
            partial = ka
        else:
            # a side split along the contraction is gathered (a weight's
            # FSDP rows); both sides split alike stay partial
            if ka:
                self._gather(c, a, sa, sa[:-1] + ((),))
            if kb:
                self._gather(c, b, sb, sb[:-2] + ((),) + sb[-1:])
        used += partial
        n_keep = self._free_of(n_ax, used)
        if n_keep != n_ax:
            self._gather(c, b, sb, sb[:-1] + (n_keep,))
        spec = self._fill(out.shape, batch + (m_ax, n_keep), partial)
        self.set_spec(out, spec)
        if partial:
            c.collective("all-reduce", _nbytes(out) / self.shards(spec))
        return self.shards(spec) * math.prod(self.sizes[x] for x in partial)

    def _halves(self, a: str, b: str) -> bool:
        """Whether ``a`` and ``b`` are the major and the minor part of one
        split of an axis (or of a part)."""
        stem = a.rsplit("|", 1)[0]
        return "|" in a and "|" in b and stem == b.rsplit("|", 1)[0] and \
            {a[-1], b[-1]} == {"<", ">"} and \
            self.sizes[a] * self.sizes[b] == self.sizes[stem]

    def _clash(self, token: str, seen: Sequence[str]) -> bool:
        """Whether ``token`` splits over devices one of ``seen`` splits
        over already: the same axis or a part of it, unless the two are
        the complementary parts of one split."""
        base = token.split("|")[0]
        return any(t.split("|")[0] == base and not self._halves(t, token)
                   for t in seen)

    def _free_of(self, axes: Axes, used: Sequence[str]) -> Axes:
        return tuple(x for x in axes if not self._clash(x, used))

    def _fill(self, shape, spec: DimSpec, partial: Axes = ()) -> DimSpec:
        """A product's result split further over the mesh axes none of its
        dims uses yet, on the first dim (batch, then rows, then columns)
        that each divides: SPMD partitioning leaves no device idle where a
        dim can be cut, so a product of weights the rules replicate (a KV
        projection whose heads do not divide the model axis) still splits
        its rows."""
        out = list(spec)
        cands: List[str] = []
        for a in [a for axes in spec for a in axes] + list(partial):
            if a[-1] in "<>" and self._other_half(a) not in cands:
                cands.append(self._other_half(a))
        cands += [a for a in self.sizes if "|" not in a and self.sizes[a] > 1]
        for axis in cands:
            cur = [a for axes in out for a in axes] + list(partial)
            if self._clash(axis, cur):
                continue
            for d in range(len(out)):
                n = math.prod(self.sizes[a] for a in out[d]) * \
                    self.sizes[axis]
                if shape[d] % n == 0:
                    out[d] = self._canon(out[d] + (axis,))
                    break
        return tuple(out)

    def _conv(self, c: Costs, args, out) -> int:
        x, w = args[0], args[1]
        sx, sw = self.spec(x), self.spec(w)
        batch = sx[0]
        o_ax = tuple(a for a in sw[0] if a not in batch)
        spatial = tuple(a if self._fits(out.shape[2 + i], a) else ()
                        for i, a in enumerate(sx[2:]))
        if sw[1:] != ((),) * (w.dim() - 1) or o_ax != sw[0]:
            self._gather(c, w, sw, (o_ax,) + ((),) * (w.dim() - 1))
        partial = sx[1] if sx[1] and sx[1] == sw[1] else ()
        spec = self._fill(out.shape, self._dedup((batch, o_ax) + spatial),
                          partial)
        self.set_spec(out, spec)
        if partial:
            c.collective("all-reduce", _nbytes(out) / self.shards(spec))
        return self.shards(spec) * math.prod(self.sizes[a] for a in partial)

    def _conv_bwd(self, c: Costs, args, outs) -> int:
        gy, x, w = args[0], args[1], args[2]
        sgy = self.spec(gy)
        # split as a product's result is (``_fill``): the forward's work
        work = self.shards(self._fill(gy.shape, sgy))
        gx, gw = (outs + [None, None])[:2]
        if gx is not None:
            self.set_spec(gx, self.spec(x))
        if gw is not None:
            self.set_spec(gw, self.spec(w))
            if sgy[0]:      # the weight's gradient summed over the batch
                c.collective("all-reduce", self.local_bytes(gw))
        return work

    def _reduction(self, c: Costs, func, args, ins, outs) -> int:
        x = args[0]
        sx = self.spec(x)
        nd = x.dim()
        dims = args[1] if len(args) > 1 else None
        if func in (aten.sum.dim_IntList, aten.mean.dim, aten.amax.default,
                    aten.amin.default, aten.logsumexp.default,
                    aten.var.correction, aten.std.correction,
                    aten.var_mean.correction, aten.any.dim, aten.all.dim):
            dims = list(range(nd)) if dims is None or dims == [] else (
                [dims] if isinstance(dims, int) else list(dims))
        elif func in (aten.argmax.default, aten.argmin.default) and \
                dims is None:
            dims = list(range(nd))
        else:
            dims = [dims if isinstance(dims, int) else -1]
        dims = [d % nd for d in dims] if nd else []
        reduced_axes = tuple(a for d in dims for a in sx[d])
        for t in outs:
            if t.dim() == nd:
                spec = tuple(() if i in dims else sx[i] for i in range(nd))
                if func in (aten._softmax.default, aten._log_softmax.default,
                            aten.cumsum.default, aten.sort.default,
                            aten.sort.stable, aten.argsort.default,
                            aten.argsort.stable, aten.cummax.default) and \
                        not reduced_axes:
                    spec = sx
            else:
                spec = tuple(sx[i] for i in range(nd) if i not in dims)
            self.set_spec(t, spec if len(spec) == t.dim() else
                          ((),) * t.dim())
        if reduced_axes:
            c.collective("all-reduce", sum(self.local_bytes(t) for t in outs))
        return self.shards(sx)

    def _cat(self, func, args, outs) -> int:
        xs = args[0]
        dim = args[1] if len(args) > 1 else 0
        src = max(xs, key=lambda x: self.shards(self.spec(x)))
        sx = self.spec(src)
        if func == aten.stack.default:
            dim = dim % (src.dim() + 1)
            spec = sx[:dim] + ((),) + sx[dim:]
        else:
            dim = dim % src.dim()
            spec = sx[:dim] + ((),) + sx[dim + 1:]
        self.set_spec(outs[0], spec)
        return self.shards(spec)

    # -- views -----------------------------------------------------------------
    def _view_specs(self, func, args, kwargs, ins, outs) -> None:
        if not ins or not outs:
            return
        x = ins[0]
        sx = self.spec(x)
        if not any(sx):
            return
        packet = func.overloadpacket
        for t in outs:
            if packet in (aten.permute,):
                spec = tuple(sx[d % x.dim()] for d in args[1])
            elif packet in (aten.transpose,):
                d0, d1 = args[1] % x.dim(), args[2] % x.dim()
                s = list(sx)
                s[d0], s[d1] = s[d1], s[d0]
                spec = tuple(s)
            elif packet in (aten.t,):
                spec = tuple(reversed(sx))
            elif packet in (aten.select,):
                d = args[1] % x.dim()
                spec = sx[:d] + sx[d + 1:]
            elif packet in (aten.unbind,):
                d = (args[1] if len(args) > 1 else 0) % x.dim()
                spec = sx[:d] + sx[d + 1:]
            elif t.dim() == x.dim() and packet not in (
                    aten.view, aten._unsafe_view, aten.reshape):
                # slice, split, expand, narrow, alias, as_strided of one rank
                spec = tuple(a if t.shape[i] == x.shape[i] or
                             self._fits(t.shape[i], a) else ()
                             for i, a in enumerate(sx))
            else:
                spec = self._reshape(x.shape, sx, t.shape)
            self.set_spec(t, spec)

    def _reshape(self, src, sx: DimSpec, dst) -> DimSpec:
        """A reshape's spec.  The dims are grouped where the running
        products meet; within a group the split axes, major first, are
        dealt to the output dims major first, each taking the axes whose
        sizes divide what is left of it, and an axis that divides only in
        part is split in two (a 4-way axis over the (2, 2) of a GQA head
        split: its major half on the first dim, its minor half on the
        second), as SPMD partitioning splits a tile assignment."""
        out: List[Axes] = [() for _ in dst]
        i = j = 0
        while i < len(src) and j < len(dst):
            i0, j0 = i, j
            ps, pd = src[i], dst[j]
            i += 1
            j += 1
            while ps != pd:
                if ps < pd and i < len(src):
                    ps *= src[i]
                    i += 1
                elif j < len(dst):
                    pd *= dst[j]
                    j += 1
                else:
                    break
            tokens = [a for k in range(i0, i) for a in sx[k]]
            for k in range(j0, j):
                left, take = dst[k], []
                while tokens:
                    n = self.sizes[tokens[0]]
                    if left % n == 0:
                        take.append(tokens.pop(0))
                        left //= n
                        continue
                    g = math.gcd(left, n)
                    if g > 1:
                        major, minor = self._split(tokens.pop(0), g)
                        take.append(major)
                        tokens.insert(0, minor)
                        left //= g
                    break
                out[k] = self._canon(tuple(take))
        return tuple(out)

    def _other_half(self, token: str) -> str:
        """The complementary part of a split axis's part."""
        stem = token.rsplit("|", 1)[0]
        n = self.sizes[stem] // self.sizes[token]
        other = f"{stem}|{n}{'>' if token.endswith('<') else '<'}"
        self.sizes.setdefault(other, n)
        return other

    def _split(self, token: str, g: int) -> Tuple[str, str]:
        """``token`` (an axis or a part of one) as its major part of ``g``
        devices and the minor rest."""
        n = self.sizes[token]
        major, minor = f"{token}|{g}<", f"{token}|{n // g}>"
        self.sizes[major], self.sizes[minor] = g, n // g
        return major, minor

    def _canon(self, axes: Axes) -> Axes:
        """Axes with a split axis's two parts, where both are there,
        joined again."""
        out = list(axes)
        for a in axes:
            if a[-1] != "<" or a not in out:
                continue
            other = next((b for b in out if self._halves(a, b)), None)
            if other is not None:
                out[out.index(a)] = a.rsplit("|", 1)[0]
                out.remove(other)
        return tuple(out)

    # -- hints -----------------------------------------------------------------
    def constrain(self, x: torch.Tensor, spec: DimSpec) -> torch.Tensor:
        """A sharding constraint: ``x`` as an alias with ``spec``; a dim
        that was split and is no longer (or split otherwise) is gathered
        first."""
        old = self.spec(x)
        spec = tuple(tuple(a) if a else () for a in spec)
        spec = (spec + ((),) * x.dim())[:x.dim()]
        spec = tuple(a if self._fits(x.shape[i], a) else ()
                     for i, a in enumerate(spec))
        y = x.view(x.shape)
        if old != spec:
            kept = tuple(o if o == n else () for o, n in zip(old, spec))
            if kept != old:
                c = Costs()
                lost = {a for o, n in zip(old, spec) if o != n for a in o}
                moved = {a for n in spec for a in n} & lost
                c.collective("all-to-all" if moved else "all-gather",
                             _nbytes(x) / self.shards(kept if not moved
                                                      else spec))
                self.costs += c
        self.set_spec(y, spec)
        return y


    # -- the per-rank regions (the sharded MoE's local_map) --------------------
    def local_dtensor(self, x: torch.Tensor, mesh, placements):
        """``x`` (whole, fake) as a DTensor over ``mesh`` whose local
        tensor is rank 0's block, marked as one: nothing is read or moved
        (the arguments of a ``local_map`` body are already in place), and
        the gradient flows back to ``x`` as a whole tensor of its spec."""
        return _ToLocal.apply(x, self, mesh, tuple(placements))

    def whole(self, x) -> torch.Tensor:
        """A DTensor as the whole (fake) tensor it stands for, with its
        placements as the spec: the SPMD value, not a gather (its
        gradient flows back as rank 0's block)."""
        return _ToWhole.apply(x, self)

    def block(self, shape, dtype, device, mesh, placements):
        """An empty DTensor whose local tensor is rank 0's block of a
        tensor of ``shape``, marked as one."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():      # integer arithmetic, no data
            local_shape, _ = compute_local_shape_and_global_offset(
                shape, mesh, placements)
        local = torch.empty(local_shape, dtype=dtype, device=device)
        local._cost_local = True
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


class _ToLocal(torch.autograd.Function):
    """A whole tensor as rank 0's block inside a DTensor, and back for the
    gradient (``CostMode.local_dtensor``)."""

    @staticmethod
    def forward(ctx, x, mode, mesh, placements):
        ctx.mode, ctx.meta = mode, (x.shape, x.dtype, x.device, mode.spec(x))
        return mode.block(x.shape, x.dtype, x.device, mesh, placements)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device, spec = ctx.meta
        y = torch.empty(shape, dtype=dtype, device=device)
        ctx.mode.set_spec(y, spec)
        return y, None, None, None


class _ToWhole(torch.autograd.Function):
    """A DTensor's SPMD value as a whole tensor with its placements' spec,
    and rank 0's block for the gradient (``CostMode.whole``)."""

    @staticmethod
    def forward(ctx, x, mode):
        from torch.distributed.tensor import Shard
        names = x.device_mesh.mesh_dim_names
        spec: List[Axes] = [() for _ in range(x.dim())]
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) or hasattr(p, "split_factor"):
                spec[p.dim] = spec[p.dim] + (names[m],)
        ctx.mode = mode
        ctx.meta = (x.shape, x.dtype, x.device, x.device_mesh,
                    tuple(x.placements))
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        mode.set_spec(y, spec)
        return y

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device, mesh, placements = ctx.meta
        return ctx.mode.block(shape, dtype, device, mesh, placements), None


def spec_of_entries(spec_: Sequence[Any]) -> DimSpec:
    """A sharding spec's entries (``None``, an axis, a tuple of axes) as
    per-dim axis tuples."""
    return tuple(() if a is None else ((a,) if isinstance(a, str)
                                       else tuple(a)) for a in spec_)


def count(step_fn, args: Sequence[Any], mode: CostMode, fake_mode,
          prepare=None) -> Tuple[Costs, Any]:
    """One call ``step_fn(*args)`` counted by ``mode`` (``hlo_cost
    .analyze_hlo``'s role): ``args`` are ``fake_mode``'s tensors, each
    carrying its spec on a mesh; ``prepare(args)`` runs first, uncounted.
    On a mesh the models' hints, ``distribute`` and ``gathered`` reach
    ``mode`` (``distributed.sharding.set_cost_tracker``).  Returns the
    per-chip costs and the step's outputs."""
    from repro_torch.distributed import sharding as shd
    prev = shd.set_cost_tracker(mode if mode.sizes else None)
    try:
        with fake_mode, mode:
            if prepare is not None:
                args = prepare(args)
                mode.reset()
            out = step_fn(*args)
    finally:
        shd.set_cost_tracker(prev)
    return mode.costs, out
