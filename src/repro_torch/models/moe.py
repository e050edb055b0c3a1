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

Without a device mesh (always, in this package: ``moe_ffn_sharded`` and
its local dispatch wait for the distribution work, ROADMAP open item 10)
the reference's ``moe_ffn`` drops its ``n_real`` argument: padded experts
(``LMConfig.n_experts_pad``) are routed to as real ones and count in the
capacity and the aux loss.  This port reproduces that.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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

    eid, slot, keep = dispatch_indices(experts, E, cap)
    dest = torch.where(keep, eid.long() * cap + slot.long(), 0)

    # scatter tokens into the (E, C, d) buffer (dropped copies add 0 at
    # (0, 0); the kept (expert, slot) pairs are distinct, so each sum is
    # exact and the order of the adds cannot matter); each token's top_k
    # copies as a repeat, whose backward sums them
    copies = x.repeat_interleave(top_k, dim=0)                # (T*K, d)
    contrib = torch.where(keep[:, None], copies, 0).to(x.dtype)
    buf = torch.zeros(E * cap, d, dtype=x.dtype, device=x.device)
    buf.index_add_(0, dest, contrib)
    buf = buf.view(E, cap, d)

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
    weighted = weighted.view(T, top_k, d)
    out = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    for k in range(top_k):
        out = out + weighted[:, k]
    return out.to(x.dtype), aux
