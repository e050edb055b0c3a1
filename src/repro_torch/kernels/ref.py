"""Plain PyTorch versions of the scheduling kernels (the port of the
``fleet_search_ref`` / ``event_select_ref`` oracles in
``repro/kernels/ref.py``).

They follow the JAX oracles operation for operation.  :mod:`.ops` runs
them for tensors that lie on the CPU; on the card they are only the
yardstick the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

BIG = 1e30


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with ONE rounding, as a fused multiply-add.

    The reference simulator runs under ``jax.jit``, and XLA's CPU compiler
    contracts ``c + a * b`` into a fused multiply-add; the CUDA kernel
    uses ``__fmaf_rn``.  PyTorch has no fused f32 multiply-add op, so this
    computes it exactly: the f64 product of two f32 values is exact, the
    f64 sum is rounded *to odd* (round to nearest, then, if inexact and
    even, one ulp toward the exact value — the error term comes from
    Knuth's TwoSum), and rounding that to f32 is the correctly rounded
    result, since f64 carries more than 24 + 2 bits.
    """
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64                                   # exact
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)               # s + err == p + c
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.to(torch.float32)


def fleet_search_ref(starts: torch.Tensor, ends: torch.Tensor,
                     sizes: torch.Tensor, n: torch.Tensor, ps, d, cpu_free,
                     head=None, eps: float = 1e-6):
    """Full admission geometry per row of stacked (K, N) ledgers:
    ``(feasible, j, cap, load)``, each (K,).

    ``j`` is the insertion slot and ``cap`` the window's right edge, so a
    caller applies the insert without a second search.  ``head`` marks
    retired slots (head-pointer rows: ``[0, head)`` holds -BIG/0, live
    blocks ``[head, head + n)``); ``None`` means 0.
    """
    K, N = starts.shape
    dev = starts.device
    n = n.reshape(K, 1).to(torch.int32)
    head = torch.zeros((K, 1), dtype=torch.int32, device=dev) if head is None \
        else head.reshape(K, 1).to(torch.int32)
    tail = head + n
    free = torch.as_tensor(cpu_free, dtype=starts.dtype, device=dev).reshape(K, 1)
    p = torch.as_tensor(ps, dtype=starts.dtype, device=dev).reshape(K, 1)
    idx = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    # retired slots hold -BIG and count into both sums identically
    cap_idx = (starts < d).sum(1, keepdim=True, dtype=torch.int32)
    e_hi = (ends < d).sum(1, keepdim=True, dtype=torch.int32)
    prev_ends = torch.cat([ends.new_full((K, 1), -BIG), ends[:, :-1]], dim=1)
    has_gap = (starts > prev_ends) & (idx >= head + 1) & (idx < tail)
    gap_ok = has_gap & (idx <= e_hi)
    prev_gap = torch.where(gap_ok, idx, head).amax(1, keepdim=True)
    no_straddle = e_hi >= cap_idx
    j = torch.where(no_straddle, e_hi, prev_gap)
    start_j = torch.gather(starts, 1, torch.clamp(j, max=N - 1).long())
    start_j = torch.where(j < tail, start_j, BIG)
    cap = torch.where(no_straddle, d, torch.minimum(start_j, d))
    start_h = torch.gather(starts, 1, torch.clamp(head, max=N - 1).long())
    start_h = torch.where(n > 0, start_h, BIG)
    front = ~no_straddle & (prev_gap == head)
    cap = torch.where(front, torch.minimum(start_h, d), cap)
    j = torch.where(front, head, j)
    pw_j = torch.where(idx < j, sizes, 0.0).sum(1, keepdim=True)
    feasible = (cap - (free + pw_j) >= p - eps) & (cap > free) & (tail < N)
    return feasible[:, 0], j[:, 0], cap[:, 0], sizes.sum(1)


def event_select_ref(t_a, node_a, d_a, p_a, pay_a, avail_a,
                     t_b, node_b, d_b, p_b, pay_b, avail_b,
                     starts: torch.Tensor, ends: torch.Tensor,
                     sizes: torch.Tensor, n: torch.Tensor, head,
                     speeds: torch.Tensor, busy: torch.Tensor,
                     latency: torch.Tensor, inv_bw: torch.Tensor,
                     eps: float = 1e-6):
    """Fused next-event merge + per-node referral scoring.

    Two candidate events — the next fresh arrival (``_a``) and the head
    of the re-arrival buffer (``_b``), each ``(t, node, d, p, payload,
    avail)`` 0-d tensors — merge by ``(time, seq)``: fresh wins ties.
    The selected event is scored against all K nodes at its wire-delayed
    arrival ``(t + latency[node]) + payload · inv_bw[node]``, the last
    step a fused multiply-add (:func:`fma32`) as in the reference (zero
    tensors for a network-free run; the zero diagonal scores the event's
    own node at ``t``).

    Returns ``(take_fresh, t, node, feasible (K,), arrive (K,), j (K,),
    cap (K,), load (K,))``.
    """
    K = starts.shape[0]
    dev = starts.device
    avail_a = torch.as_tensor(avail_a, dtype=torch.bool, device=dev)
    avail_b = torch.as_tensor(avail_b, dtype=torch.bool, device=dev)
    take_a = avail_a & ((t_a <= t_b) | ~avail_b)
    t = torch.where(take_a, t_a, t_b)
    node = torch.where(take_a, node_a, node_b)
    d = torch.where(take_a, d_a, d_b)
    p = torch.where(take_a, p_a, p_b)
    payload = torch.where(take_a, pay_a, pay_b)
    ps = p / speeds.reshape(K)
    row = node.reshape(1)
    arrive = fma32(payload, inv_bw.index_select(0, row).reshape(K),
                   t + latency.index_select(0, row).reshape(K))
    free = torch.maximum(arrive, busy.reshape(K))
    feas, j, cap, load = fleet_search_ref(starts, ends, sizes, n, ps, d,
                                          free, head, eps)
    return take_a, t, node, feas, arrive, j, cap, load
