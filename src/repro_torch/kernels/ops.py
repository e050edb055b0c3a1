"""Public entry points of the port's kernels, dispatching on the tensors'
device: a CUDA tensor launches the Hopper kernel (or raises), a CPU
tensor runs the plain PyTorch version.  There is no fallback between the
two and no error is caught here.

Gradients.  ``rmsnorm`` and ``moe_gemm`` are differentiable: under grad,
with an input that requires it, each runs as a
``torch.autograd.Function`` whose backward is the kernels' on the card
(the rmsnorm backward kernel; ``moe_gemm`` launched on the transposed
operands) and their plain versions on the CPU.  The other entry points
have no backward: ``flash_attention`` on the card raises under grad (the
reference's Pallas kernel has no backward either; its plain version on
the CPU stays differentiable, as the reference's plain paths are), and
``event_select``, ``fleet_feasibility`` and ``link_cost`` raise under
grad on either device, rather than hand back a result that silently
drops the gradient.

On CUDA tensors the model-path kernels (``flash_attention``, ``rmsnorm``
and its backward, ``moe_gemm``) are reached through their
``torch.library`` operators (:mod:`repro_torch.kernels.library`): a
real tensor launches the kernel, a fake one (``FakeTensorMode``) gets
the output's shape and dtype, and ``torch.utils.flop_counter`` the
kernel's work, with no launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import admission as _ad
from repro_torch.kernels import event_select as _es
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import library, ref
from repro_torch.kernels import rmsnorm as _rn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Forward attention, with the signature of
    ``repro.kernels.ops.flash_attention``: q (B,S,H,D); k, v (B,S,KV,D)
    -> (B,S,H,D), GQA by head mapping, D up to 128, f32 or bf16.

    ``block_q`` / ``block_k`` exist only for signature parity with the
    reference and have no effect: the CUDA kernels tile 64 query rows by
    64 keys (bf16; f32 at D <= 64) or 32 (f32 above), and the result does
    not depend on tiling.
    """
    if q.device.type != "cuda":
        _fa.check_args(q, k, v, window)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if _wants_grad(q, k, v):
        raise RuntimeError(
            "flash_attention has no backward: the CUDA kernel is forward "
            "only, as the reference's Pallas kernel is (it defines no VJP); "
            "train with attn_impl='chunked' or run under torch.no_grad()")
    return library.ops.flash_attention(q, k, v, causal, window or 0)


def _wants_grad(*tensors) -> bool:
    """Whether grad mode is on and any of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _no_grad(kernel: str, *tensors) -> None:
    """Raise if a gradient would be asked of an entry point without one."""
    if _wants_grad(*tensors):
        raise RuntimeError(f"{kernel} has no backward (neither has the "
                           f"reference's kernel); call it under "
                           f"torch.no_grad() or on detached tensors")


def candidate_buffers(t_a, node_a, d_a, p_a, pay_a, avail_a,
                      t_b, node_b, d_b, p_b, pay_b, avail_b):
    """The twelve candidate scalars as the kernel takes them, on their
    device: an (8,) f32 buffer ``(t, d, p, payload)`` of ``_a`` then
    ``_b``, and a (4,) int32 buffer ``(node_a, avail_a, node_b,
    avail_b)``."""
    i32 = torch.int32
    fscal = torch.stack([t_a, d_a, p_a, pay_a, t_b, d_b, p_b, pay_b]
                        ).reshape(8).to(torch.float32)
    iscal = torch.stack([node_a.to(i32), avail_a.to(i32), node_b.to(i32),
                         avail_b.to(i32)]).reshape(4)
    return fscal, iscal


def event_select(t_a, node_a, d_a, p_a, pay_a, avail_a,
                 t_b, node_b, d_b, p_b, pay_b, avail_b,
                 starts: torch.Tensor, ends: torch.Tensor, sizes: torch.Tensor,
                 n: torch.Tensor, head, speeds: torch.Tensor,
                 busy: torch.Tensor, latency: torch.Tensor,
                 inv_bw: torch.Tensor):
    """Fused next-event merge + per-node referral scoring (DESIGN.md §7),
    with the signature of ``repro.kernels.ops.event_select``.

    Candidate 0-d or (1,) tensors ``(t, node, d, p, payload, avail)`` for the
    fresh arrival (``_a``) and the re-arrival buffer head (``_b``);
    stacked (K, W) ledger windows with (K,) ``n`` and ``head`` (``None``
    means 0); (K, K) latency / inverse-bandwidth tensors (zeros for a
    network-free run).  Returns ``(take_fresh, t, node, feasible (K,),
    arrive (K,), j (K,), cap (K,), load (K,))``.

    No path of the port calls it on the card: the fleet simulator's CUDA
    path runs each run as one ``event_scan`` launch, which scores the
    fleet with the same row geometry (``csrc/fleet_row.cuh``).  On the CPU
    the simulator's eager loop (the plain version of ``event_scan``)
    still calls it, as the reference's step does.
    """
    _no_grad("event_select", t_a, d_a, p_a, pay_a, t_b, d_b, p_b, pay_b,
             starts, ends, sizes, speeds, busy, latency, inv_bw)
    if head is None:
        head = torch.zeros_like(n, dtype=torch.int32)
    if starts.device.type != "cuda":
        return ref.event_select_ref(t_a, node_a, d_a, p_a, pay_a, avail_a,
                                    t_b, node_b, d_b, p_b, pay_b, avail_b,
                                    starts, ends, sizes, n, head, speeds,
                                    busy, latency, inv_bw, eps=_es.EPS)
    fscal, iscal = candidate_buffers(t_a, node_a, d_a, p_a, pay_a, avail_a,
                                     t_b, node_b, d_b, p_b, pay_b, avail_b)
    i32 = torch.int32
    take, t, node, *rest = _es.event_select(
        fscal, iscal, starts, ends, sizes, n.to(i32), head.to(i32), speeds,
        busy, latency, inv_bw)
    # the merge outputs take the candidates' shape, as the plain version's do
    shape = t_a.shape
    return (take.reshape(shape), t.reshape(shape), node.reshape(shape),
            *rest)


def _rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        return ref.rmsnorm_ref(x, scale, eps=_rn.EPS)
    return library.ops.rmsnorm(x, scale)


class RMSNormFn(torch.autograd.Function):
    """rmsnorm on rows x (R, d) with its backward: on the card the forward
    and backward kernels, on the CPU their plain versions
    (:func:`ref.rmsnorm_ref`, :func:`ref.rmsnorm_bwd_ref`).  Saves x and
    the scale; the backward recomputes each row's r."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return _rmsnorm_rows(x, scale)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type != "cuda":
            dx, ds = ref.rmsnorm_bwd_ref(x, scale, dy, eps=_rn.EPS)
        else:
            dx, ds = library.ops.rmsnorm_bwd(x, scale, dy)
        return dx, ds


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., d) RMS-normalised over its last axis and scaled by ``1 +
    scale``, with the signature of ``repro.kernels.ops.rmsnorm``: f32 math,
    eps 1e-6, the result in x's dtype (f32 or bf16 on the card).  Leading
    axes are flattened into rows, as the reference does.  Differentiable
    in x and scale (:class:`RMSNormFn`)."""
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    if _wants_grad(x, scale):
        return RMSNormFn.apply(rows, scale).reshape(shape)
    return _rmsnorm_rows(rows, scale).reshape(shape)


def _moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        return ref.moe_gemm_ref(x, w)
    return library.ops.moe_gemm(x, w)


def _pad_rows(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to a multiple of ``n``."""
    extra = -x.shape[dim] % n
    if not extra:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, extra]
    return torch.nn.functional.pad(x, pad)


class MoEGemmFn(torch.autograd.Function):
    """``moe_gemm`` with its backward as two more grouped products, for
    y = x w: dx = moe_gemm(dy, w^T), (E, C, f) x (E, f, d), and dw =
    moe_gemm(x^T, dy), (E, d, C) x (E, C, f), each operand made
    contiguous.  On the card the contraction over C of dw is padded with
    zero rows to a multiple of 8 in both operands (zeros add exactly), so
    that bf16 dw takes the ``tma_wgmma`` kernel: C is 853 a 4,096-token
    Granite sequence, which ``variant`` would send to ``mma_sync``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _moe_gemm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _moe_gemm(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            xt = x.transpose(1, 2).contiguous()
            if x.device.type == "cuda":
                xt, dy = _pad_rows(xt, 8, 2), _pad_rows(dy, 8, 1)
            dw = _moe_gemm(xt, dy)
        return dx, dw


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f) grouped GEMM with f32
    accumulation and the result in x's dtype, with the signature of
    ``repro.kernels.ops.moe_gemm``.  Differentiable in x and w
    (:class:`MoEGemmFn`)."""
    if _wants_grad(x, w):
        return MoEGemmFn.apply(x, w)
    return _moe_gemm(x, w)


def _ledger_args(starts, n, ps, head):
    """``n`` and ``head`` as (K,) int32 (``head=None`` means 0) and ``ps``
    as (K,) f32 on the ledgers' device."""
    K, dev, i32 = starts.shape[0], starts.device, torch.int32
    head = torch.zeros(K, dtype=i32, device=dev) if head is None \
        else head.reshape(K).to(i32)
    return (n.reshape(K).to(i32), _vector(ps, K, dev), head)


def _vector(v, K: int, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(K)


def _scalar(v, dev) -> torch.Tensor:
    """A scalar as the kernels take it: a (1,) f32 tensor on the device,
    so that a launch needs no host read."""
    return torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)


def fleet_feasibility(starts: torch.Tensor, ends: torch.Tensor,
                      sizes: torch.Tensor, n: torch.Tensor, ps, d, cpu_free,
                      head=None):
    """Stacked (K, N) ledgers -> ``((K,) feasible, (K,) load)`` for one
    request of per-node work ``ps`` at deadline ``d`` from each node's
    ``cpu_free``, with the signature of
    ``repro.kernels.ops.fleet_feasibility``.  ``head`` marks retired slots
    (head-pointer rows; ``None`` means 0); a full row is infeasible.  The
    event heap's ``batched_feasible`` router scores each decision with
    it (:mod:`repro_torch.orchestration.router`)."""
    _no_grad("fleet_feasibility", starts, ends, sizes, ps, d, cpu_free)
    if starts.device.type != "cuda":
        return ref.fleet_feasibility_ref(starts, ends, sizes, n, ps, d,
                                         cpu_free, head, eps=_ad.EPS)
    dev, K = starts.device, starts.shape[0]
    n, ps, head = _ledger_args(starts, n, ps, head)
    return _ad.fleet_feasibility(starts, ends, sizes, n, ps, _scalar(d, dev),
                                 _vector(cpu_free, K, dev), head)


def link_cost(starts: torch.Tensor, ends: torch.Tensor, sizes: torch.Tensor,
              n: torch.Tensor, ps, d, busy, head, t_src, lat_row, inv_bw_row,
              payload):
    """Referral scoring with the signature of
    ``repro.kernels.ops.link_cost``: one request at a source node at
    ``t_src`` against K candidates' stacked (K, N) ledgers, delayed by
    the wire cost ``lat_row + payload * inv_bw_row`` (the source's rows of
    the network tensors, one rounding) and admitted from ``max(arrive,
    busy)``.  Returns ``((K,) feasible, (K,) arrive, (K,) load)``."""
    _no_grad("link_cost", starts, ends, sizes, ps, d, busy, t_src, lat_row,
             inv_bw_row, payload)
    if starts.device.type != "cuda":
        return ref.link_cost_ref(starts, ends, sizes, n, ps, d, busy, head,
                                 t_src, lat_row, inv_bw_row, payload,
                                 eps=_ad.EPS)
    dev, K = starts.device, starts.shape[0]
    n, ps, head = _ledger_args(starts, n, ps, head)
    return _ad.link_cost(starts, ends, sizes, n, ps, _scalar(d, dev),
                         _vector(busy, K, dev), head, _scalar(t_src, dev),
                         _vector(lat_row, K, dev), _vector(inv_bw_row, K, dev),
                         _scalar(payload, dev))
