"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch
(the port of ``repro/models/moe.py``).

Tokens are sorted by expert id and gathered into a dense (E, C, d) buffer,
so the expert FFN is three grouped products over the expert axis; tokens
over capacity are dropped (GShard-style) and the residual stream carries
them unchanged.  The products go through
:func:`repro_torch.kernels.ops.moe_gemm`, the hand-written Hopper kernel on
the card (its plain version on the CPU): a port choice, since the
reference writes them as einsums (``moe.py:208-211``) that compute the
same function, bf16 x bf16 summed in f32 and rounded to bf16.

Without a device mesh the reference's ``moe_ffn`` drops its ``n_real``
argument: padded experts (``LMConfig.n_experts_pad``) are routed to as
real ones and count in the capacity and the aux loss.  This port
reproduces that.  Under a mesh (``transformer._ffn`` with ``moe_impl ==
"shard_map"`` and rules installed) :func:`moe_ffn_sharded` runs the
reference's SPMD body under ``local_map``, torch's ``shard_map``: each
(data, model) rank dispatches its own token shard to the experts it owns
(:func:`_local_dispatch_ffn`), with the padded experts masked out of the
routing, the capacity and the aux loss, and one all-reduce over
``model`` combines the experts' contributions.  It is differentiable as
the reference's ``jax.grad`` through ``shard_map`` is: the FSDP gathers
transpose to reduce-scatters, the all-reduce to the identity, and the
gradients of x and the router count the aux loss's part once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.models.common import swiglu


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float, min_capacity: int = 4) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    c = max(min_capacity, c)
    return min(c, n_tokens)


def route_topk(router_logits: torch.Tensor, top_k: int,
               n_real: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) logits -> (gates (T, K) f32 normalized, experts (T, K) int32).

    ``n_real``: number of real experts — columns beyond it are padding
    (masked out of routing).  Ties keep the lower expert index, as
    ``jax.lax.top_k`` does: a stable descending sort.
    """
    if n_real is not None and n_real < router_logits.shape[-1]:
        col = torch.arange(router_logits.shape[-1],
                           device=router_logits.device)
        router_logits = torch.where(col[None, :] < n_real, router_logits,
                                    -1e30)
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :top_k], experts[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, experts.to(torch.int32)


def load_balancing_loss(router_logits: torch.Tensor, experts: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * <fraction routed> . <mean router prob>."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    me = probs.mean(0)
    col = torch.arange(n_experts, device=experts.device)
    ce = (experts[:, :1] == col[None, :]).float().mean(0)
    return n_experts * (me * ce).sum()


def dispatch_indices(experts: torch.Tensor, n_experts: int, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch plan.

    experts: (T, K) int32.  Returns (expert_id (T*K,), slot (T*K,),
    keep (T*K,) bool) — token-copy i goes to buffer[expert_id[i], slot[i]]
    iff keep[i]: its rank among the copies routed to its expert, in token
    order (a stable sort), under the capacity.
    """
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order].contiguous()
    ranks = torch.arange(flat.shape[0], device=flat.device) \
        - torch.searchsorted(sorted_e, sorted_e, side="left")
    slot = torch.empty_like(ranks)
    slot[order] = ranks
    keep = slot < cap
    return flat, slot.to(torch.int32), keep


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float, n_real: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d); expert weights (E, d, f) / (E, f, d).  Returns (out (T, d)
    in x's dtype, aux loss 0-d f32).

    As the reference's ``moe_ffn``, ``n_real`` is taken and not used: all
    E columns of ``router_w`` route, and E sizes the capacity and the aux
    loss.  The router's logits are f32 (x upcast against the f32 router);
    the dispatch scatters each kept copy into its (expert, slot) of a
    zeroed (E, C, d) buffer (a dropped copy adds 0 at (0, 0), as in the
    reference); the combine sums each token's K gated copies in f32, in
    k order (the reference's scatter-add into zeros; the same association
    on the CPU), and rounds to x's dtype once.
    """
    T, d = x.shape
    E = router_w.shape[-1]
    logits = x.float() @ router_w.float()
    gates, experts = route_topk(logits, top_k)
    aux = load_balancing_loss(logits, experts, E)
    cap = capacity(T, E, top_k, capacity_factor)

    # scatter tokens into the (E, C, d) buffer; each token's top_k copies
    # as a repeat, whose backward sums them
    eid, slot, keep = dispatch_indices(experts, E, cap)
    buf, dest = _dispatch(x, keep, eid, slot, E, cap, top_k)

    # grouped expert FFN (SwiGLU) through the kernel
    g = kops.moe_gemm(buf, w_gate)
    u = kops.moe_gemm(buf, w_up)
    h = swiglu(g, u)
    y = kops.moe_gemm(h, w_down)

    # combine back with gates, in f32
    # (T*K, d); the backward adds each copy's gradient back at its slot,
    # every kept slot once (a dropped copy's gradient is 0)
    gathered = torch.index_select(y.view(E * cap, d), 0, dest)
    weighted = gathered.float() * torch.where(
        keep, gates.reshape(-1), 0.0)[:, None]
    return _sum_copies(weighted, top_k).to(x.dtype), aux


def _sum_copies(weighted: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each token's ``top_k`` gated copies (T*K, d) summed in f32 from 0,
    in k order: the reference's f32 scatter-add into zeros."""
    weighted = weighted.float().view(-1, top_k, weighted.shape[-1])
    out = torch.zeros(weighted.shape[0], weighted.shape[2],
                      dtype=torch.float32, device=weighted.device)
    for k in range(top_k):
        out = out + weighted[:, k]
    return out


def _dispatch(x: torch.Tensor, keep: torch.Tensor, eid: torch.Tensor,
              slot: torch.Tensor, n_buf: int, cap: int, top_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (n_buf, cap, d) buffer of the kept token copies (a copy not
    kept adds 0 at (0, 0), as in the reference; the kept (expert, slot)
    pairs are distinct, so each sum is exact), and each copy's flat
    destination."""
    T, d = x.shape
    dest = torch.where(keep, eid.long() * cap + slot.long(), 0)
    copies = x.repeat_interleave(top_k, dim=0)                # (T*K, d)
    contrib = torch.where(keep[:, None], copies, 0).to(x.dtype)
    buf = torch.zeros(n_buf * cap, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, dest, contrib)
    return buf.view(n_buf, cap, d), dest


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient multiplied by ``scale``."""

    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _local_dispatch_ffn(x: torch.Tensor, router_w: torch.Tensor,
                        w_gate: torch.Tensor, w_up: torch.Tensor,
                        w_down: torch.Tensor, *, top_k: int,
                        capacity_factor: float, n_experts: int,
                        expert_offset: int, n_real: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard MoE: local tokens, local expert slice (E_loc, d, f).

    ``expert_offset`` is this shard's first expert id (0 when experts are
    replicated and only d_ff is sharded).  Returns the PARTIAL output in
    x's dtype (the sum over the expert / ffn axis still required) and the
    local aux loss.  Unlike :func:`moe_ffn`, ``n_real`` counts: experts
    past it are masked out of the routing, the aux loss is taken over the
    first ``n_real`` logits, and the capacity is sized from ``n_real``.
    The combine rounds each gated copy to x's dtype (the gate rounded to
    it first) before the f32 sum over the token's copies, as the
    reference does (``moe.py:115-118``).
    """
    T, d = x.shape
    E_loc = w_gate.shape[0]
    n_real = n_real or n_experts
    logits = x.float() @ router_w.float()
    gates, experts = route_topk(logits, top_k, n_real=n_real)
    aux = load_balancing_loss(logits[:, :n_real], experts, n_real)
    cap = capacity(T, n_real, top_k, capacity_factor)

    eid, slot, keep = dispatch_indices(experts, n_experts, cap)
    mine = keep & (eid >= expert_offset) & (eid < expert_offset + E_loc)
    buf, dest = _dispatch(x, mine, eid - expert_offset, slot, E_loc, cap,
                          top_k)

    g = kops.moe_gemm(buf, w_gate)
    u = kops.moe_gemm(buf, w_up)
    h = swiglu(g, u)
    y = kops.moe_gemm(h, w_down)

    gathered = torch.index_select(y.view(E_loc * cap, d), 0, dest)
    gate = torch.where(mine, gates.reshape(-1), 0.0)[:, None]
    weighted = gathered * gate.to(gathered.dtype)
    return _sum_copies(weighted, top_k).to(x.dtype), aux


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _waited(t):
    return t.wait() if isinstance(t, _funcol().AsyncCollectiveTensor) else t


class _SumOverModel(torch.autograd.Function):
    """The all-reduce (sum) of the model ranks' partial outputs over
    ``group``; its backward the identity: the transpose of JAX's ``psum``
    of a value that varies over the axis (each rank's partial output gets
    the whole output's gradient, which is the same on every model rank).
    ``funcol.all_reduce``'s own backward is another all-reduce, which
    would count that gradient |model| times."""

    @staticmethod
    def forward(ctx, t, group):
        return _waited(_funcol().all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def moe_ffn_sharded(x: torch.Tensor, router_w: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, *, top_k: int,
                    capacity_factor: float, mesh, dp_axes, model_axis: str,
                    fsdp_axes, expert_sharded: bool,
                    n_real: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` MoE under ``local_map``.

    Dispatch is LOCAL to each data shard: tokens are replicated across
    the model axis, so each (data, model) rank dispatches its own token
    shard to the experts it owns and one all-reduce over ``model``
    combines their contributions; the weights' FSDP shards are gathered
    first.  ``expert_sharded``: experts split over ``model`` (E % mp ==
    0); otherwise each expert's d_ff is split.

    The arguments are DTensors of the reference's in-specs on ``mesh``
    (the result then DTensors of its out-specs), or plain tensors that
    every rank holds whole: each rank takes its blocks of them without
    communication, and gets the whole output back.  Returns (out (T, d)
    in x's dtype, the aux loss averaged over the data shards).

    Differentiable as the reference's ``jax.grad`` through ``shard_map``
    is: the gathers' backward is a reduce-scatter, the sum over
    ``model``'s the identity; a rank's gradient of x and of the router
    has a part through the dispatch, which differs between the model
    ranks and is summed over them, and a part through the aux loss, which
    every model rank computes alike and which is counted once (scaled by
    1 / |model| before that sum).  The gradients' placements follow the
    in-specs: x sharded over the dp axes and summed over ``model``; the
    router summed over every axis; the expert weights sharded as they
    are, summed over any dp axis that is not an FSDP axis.  From plain
    tensors, each rank gets the whole gradient (:func:`shd.distribute`'s
    backward gathers it).
    """
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor.experimental import local_map

    E = router_w.shape[-1]
    dp = tuple(dp_axes) if dp_axes else ()
    fa = (fsdp_axes,) if isinstance(fsdp_axes, str) else tuple(fsdp_axes or ())
    x_spec = shd.spec(dp or None, None)
    if expert_sharded:
        w_spec = shd.spec(model_axis, fa or None, None)
        wd_spec = shd.spec(model_axis, None, fa or None)
    else:
        w_spec = shd.spec(None, fa or None, model_axis)
        wd_spec = shd.spec(None, model_axis, fa or None)
    in_specs = (x_spec, (None, None), w_spec, w_spec, wd_spec)
    out_specs = (x_spec, shd.spec(dp or None))
    names = shd.axis_names(mesh)

    def summed(spec_, axes):
        """``spec_``'s placements with ``Partial`` on the mesh dims of
        ``axes``: a gradient each rank holds a share of."""
        return tuple(Partial() if n in axes else p for n, p in
                     zip(names, shd.placements(mesh, spec_)))

    w_sum = tuple(a for a in dp if a not in fa)
    grad_placements = (summed(x_spec, (model_axis,)),
                       summed((None, None), dp + (model_axis,)),
                       summed(w_spec, w_sum), summed(w_spec, w_sum),
                       summed(wd_spec, w_sum))
    aux_scale = 1.0 / shd.axis_size(mesh, model_axis)

    def gather(w, dim):
        # the FSDP shards, minor axis first: the block of the major-first
        # ("a", "b") sharding at i_a * |b| + i_b.  Gathered on dim 0 and
        # the blocks concatenated on ``dim`` (funcol's own gather on
        # another dim is ~10x slower on the CPU); the backward is a
        # reduce-scatter, the transpose of the reference's tiled gather.
        # The concatenation (a copy, even of one block) waits for the
        # gather: ``wait()`` would leave the autograd graph.
        for a in reversed(fa):
            group = mesh.get_group(a)
            y = _funcol().all_gather_tensor_autograd(w.contiguous(), 0, group)
            w = torch.cat(y.chunk(group.size(), 0), dim)
        return w

    def local_fn(x_loc, rw, wg, wu, wd):
        wg, wu, wd = gather(wg, 1), gather(wu, 1), gather(wd, 2)
        off = mesh.get_local_rank(model_axis) * wg.shape[0] \
            if expert_sharded else 0
        out, aux = _local_dispatch_ffn(
            x_loc, rw, wg, wu, wd, top_k=top_k,
            capacity_factor=capacity_factor, n_experts=E,
            expert_offset=off, n_real=n_real)
        # every model rank computes the aux loss alike: its part of the x
        # and router gradients, summed over model, is counted once
        aux = _ScaleGrad.apply(aux, aux_scale)
        out = _SumOverModel.apply(out, mesh.get_group(model_axis))
        return out, aux[None]

    fn = local_map(local_fn,
                   out_placements=tuple(shd.placements(mesh, s)
                                        for s in out_specs),
                   in_placements=tuple(shd.placements(mesh, s)
                                       for s in in_specs),
                   in_grad_placements=grad_placements,
                   device_mesh=mesh)
    args = (x, router_w, w_gate, w_up, w_down)
    plain = not isinstance(x, DTensor)
    if plain:
        args = tuple(shd.distribute(a, mesh, s)
                     for a, s in zip(args, in_specs))
    out, aux = fn(*args)
    if plain:
        out, aux = shd.gathered(out), shd.gathered(aux)
    return out, aux.mean()
