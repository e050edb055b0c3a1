"""Public entry points of the port's kernels, dispatching on the tensors'
device: a CUDA tensor launches the Hopper kernel (or raises), a CPU
tensor runs the plain PyTorch version.  There is no fallback between the
two and no error is caught here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import event_select as _es
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Forward attention, with the signature of
    ``repro.kernels.ops.flash_attention``: q (B,S,H,D); k, v (B,S,KV,D)
    -> (B,S,H,D), GQA by head mapping, D up to 128, f32 or bf16.

    ``block_q`` / ``block_k`` exist only for signature parity with the
    reference and have no effect: the CUDA kernels tile 64 query rows by
    64 (bf16) or 32 (f32) keys, and the result does not depend on tiling.
    """
    if q.device.type != "cuda":
        _fa.check_args(q, k, v, window)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


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
    """
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
