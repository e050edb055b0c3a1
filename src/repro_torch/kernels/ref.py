"""Plain PyTorch versions of the port's kernels (the port of the oracles
in ``repro/kernels/ref.py``: ``flash_attention_ref``, ``rmsnorm_ref``,
``moe_gemm_ref``, ``fleet_feasibility_ref``, ``link_cost_ref``,
``event_select_ref`` and ``fleet_search_ref``).

They follow the JAX oracles operation for operation.  :mod:`.ops` runs
them for tensors that lie on the CPU; on the card they are only the
yardstick the CUDA kernel is held against.
"""
from __future__ import annotations

from typing import Optional

import torch

BIG = 1e30


def flash_attention_mask(Sq: int, Sk: int, causal: bool,
                         window: Optional[int], device=None,
                         q_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: key j is live for query row i, at position
    ``q_offset + i``, under :func:`flash_attention_ref`'s masks (``i >=
    j`` under ``causal``, ``i - j < window`` under a window)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= qpos - kpos < window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,D); k,v (B,S,KV,D) -> (B,S,H,D).  f32 scores and softmax,
    masked entries -1e30, GQA by head grouping (q head h reads kv head
    h // (H // KV)); the probabilities are rounded to v's dtype before the
    PV product and the result is cast to q's dtype.  Query row i sits at
    position ``q_offset + i`` of the keys' sequence."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * (D ** -0.5)
    ok = flash_attention_mask(Sq, Sk, causal, window, q.device, q_offset)
    s = torch.where(ok, s, -BIG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_ref_by_blocks(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  window: Optional[int] = None,
                                  block: int = 1024) -> torch.Tensor:
    """:func:`flash_attention_ref` a block of ``block`` query rows at a
    time, each at its offset, against the keys up to the block's end under
    ``causal`` (every key otherwise): no head holds an (S, S) score matrix
    at once, which at 32k tokens would take ~100 GB of f32 scores."""
    S = q.shape[1]
    return torch.cat([flash_attention_ref(
        q[:, i:i + block], k[:, :i + block if causal else S],
        v[:, :i + block if causal else S], causal=causal, window=window,
        q_offset=i) for i in range(0, S, block)], dim=1)


def flash_attention_tolerance(want: torch.Tensor, v: torch.Tensor) -> dict:
    """``rtol`` and ``atol`` of ``torch.allclose`` for a flash-attention
    kernel's output against :func:`flash_attention_ref` ``want`` on the
    same inputs (``v`` the values, whose dtype picks the rule; ``want``
    may be upcast).

    f32: 1e-5 both, the JAX package's own tolerance for its kernel against
    its oracle; only the order of the sums differs.  bf16: both sides
    round the output to 8 significant bits, so ``rtol`` is one unit in the
    last place, 2^-7; the kernel rounds the unnormalised probabilities
    where the plain version rounds the normalised ones (a relative 2^-8
    per probability), and an element that cancels to near zero keeps the
    rounding of the terms it sums, so ``atol = 2^-7 (max|want| +
    max|v| / 8)``, scaled to the case.  At 578 keys of random inputs that
    is ~0.01, a tenth of what dropping one key changes.
    """
    if v.dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5)
    scale = float(want.float().abs().max()) + float(v.float().abs().max()) / 8
    return dict(rtol=2.0 ** -7, atol=2.0 ** -7 * scale)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm over the last axis, scaled by ``1 + scale``, the math in
    f32 and the result in ``x``'s dtype: ``x * rsqrt(mean(x^2) + eps) *
    (1 + scale)``."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_tolerance(dtype: torch.dtype) -> dict:
    """``rtol`` and ``atol`` of ``torch.allclose`` for an rmsnorm kernel
    against :func:`rmsnorm_ref` on the same inputs.

    The output is a product, so its error is relative.  f32: rtol 2e-6,
    atol 1e-6 — the sum of squares is taken in another order, and rsqrt
    is not correctly rounded everywhere (XLA's is not; PyTorch's is
    ``1/sqrt`` on the CPU and the approximate ``rsqrtf`` on the card), a
    few ulp in all.  bf16: one unit in the last place, rtol 2^-7: the f32
    values agree to a few ulp and each side rounds once to bf16.  A
    kernel that drops one element of a 5376-wide row from the sum errs by
    1e-4 to 1e-3 relative: the f32 rule rejects it, the bf16 one cannot.
    """
    if dtype == torch.float32:
        return dict(rtol=2e-6, atol=1e-6)
    return dict(rtol=2.0 ** -7, atol=0.0)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The backward of :func:`rmsnorm_ref` written out in f32, without
    autograd: with r = rsqrt(mean(x^2) + eps) per row and g = dy * (1 +
    scale),

        dx     = r * g - x * (r * r * r * mean(g * x))
        dscale = sum over rows of dy * x * r

    dx in ``x``'s dtype, dscale in ``scale``'s (the rmsnorm backward
    kernel's plain version; the reference gets the same function from
    ``jax.vjp`` of its ``rms_norm``).  x and dy (..., d), scale (d,)."""
    d = x.shape[-1]
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    g = dy32 * (1.0 + scale.float())
    c = r * r * r * (g * x32).mean(-1, keepdim=True)
    dx = r * g - x32 * c
    ds = (dy32 * x32 * r).reshape(-1, d).sum(0)
    return dx.to(x.dtype), ds.to(scale.dtype)


def rmsnorm_bwd_tolerance(x: torch.Tensor, scale: torch.Tensor,
                          dy: torch.Tensor, eps: float = 1e-6) -> dict:
    """``{"dx": tol, "dscale": tol}``, each the ``rtol`` / ``atol`` of
    ``torch.allclose`` for an rmsnorm backward against
    :func:`rmsnorm_bwd_ref` on the same inputs.

    dx is a difference of two f32 terms of the size of r |g| (1 + |x r|),
    each a few roundings deep, so ``atol = 2^-18`` of that size's largest
    value (16 times a few ulp) and ``rtol`` 1e-5 in f32, one bf16 unit
    (2^-7) in bf16, where each side rounds once.  dscale sums R terms
    ``dy x r`` per column in another order (the kernel: each block's rows,
    then the blocks): ``atol = 2^-16`` of the largest column's sum of
    |terms| (a sequential f32 sum of R terms errs by ~sqrt(R) 2^-24 of it
    on random inputs, 2^-17.5 at R = 8192), ``rtol`` as for dx by the
    scale's dtype.  A dscale without its last row errs by one term, about
    R 2^-16 = 8 times this ``atol`` at R = 8192; a dscale of 0 by ~sqrt(R)
    terms."""
    d = x.shape[-1]
    x32, dy32 = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    g = dy32 * (1.0 + scale.float())
    size = float((r * g.abs() * (1.0 + (x32 * r).abs())).max())
    col = float((dy32 * x32 * r).abs().sum(0).max())

    def rtol(dt):
        return 1e-5 if dt == torch.float32 else 2.0 ** -7
    return {"dx": dict(rtol=rtol(x.dtype), atol=2.0 ** -18 * size),
            "dscale": dict(rtol=rtol(scale.dtype), atol=2.0 ** -16 * col)}


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped per-expert GEMM ``(E, C, d) @ (E, d, f) -> (E, C, f)``: the
    inputs upcast to f32, contracted in f32 (the reference's
    ``preferred_element_type=f32``), the result cast to ``x``'s dtype.  On
    the card the caller keeps TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default)."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def moe_gemm_tolerance(x: torch.Tensor, w: torch.Tensor) -> dict:
    """``rtol`` and ``atol`` of ``torch.allclose`` for a grouped-GEMM kernel
    against :func:`moe_gemm_ref` on the same inputs.

    Both sum d f32 products in different orders; a sequential f32 sum errs
    by up to ~4.4 * 2^-24 * sqrt(d) max|x| max|w| on random inputs
    (measured on the CPU against f64 at d = 512 and 1536), so ``atol =
    2^-18 sqrt(d) max|x| max|w|`` (64 * 2^-24) leaves a margin of ~14 and
    grows with sqrt(d).  ``rtol``: 1e-5 in f32; one bf16 unit, 2^-7, in
    bf16, where each side rounds its f32 sum once.  Dropping a 16-wide
    slice of d moves an output by about four typical products, thousands
    of times ``atol``.
    """
    d = x.shape[-1]
    scale = d ** 0.5 * float(x.float().abs().max()) \
        * float(w.float().abs().max())
    return dict(rtol=1e-5 if x.dtype == torch.float32 else 2.0 ** -7,
                atol=2.0 ** -18 * scale)


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


def lane_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a (K, N) f32 tensor in the association the CUDA fleet
    kernels use (``csrc/fleet_row.cuh``, ``csrc/admission.cu``): lane l of
    a warp sums ``x[:, l], x[:, l + 32], ...`` in order, then the lanes
    meet in a butterfly of adds (xor 16, 8, 4, 2, 1).  The plain versions
    above sum in PyTorch's order instead: the two agree exactly on
    integers and dyadic values, and otherwise within
    :func:`sum_order_rtol`."""
    K, N = x.shape
    lanes = torch.nn.functional.pad(x, (0, (-N) % 32)).reshape(K, -1, 32)
    acc = lanes[:, 0]
    for i in range(1, lanes.shape[1]):
        acc = acc + lanes[:, i]
    flip = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, flip ^ o]
    return acc[:, 0]


def sum_order_rtol(n: int) -> float:
    """How far apart two f32 sums of the same n non-negative terms, taken
    in different orders, can be, relative to either: each errs by at most
    (n - 1) units of 2^-24 of the exact sum, whatever its order."""
    return 2.0 * n * 2.0 ** -24


def load_rtol(n: int) -> float:
    """``rtol`` of a fleet kernel's ``load`` against the plain version's
    over rows of n slots of non-dyadic sizes (the kernel sums in
    :func:`lane_tree_sum`'s order): 1e-6 up to the entry points' n = 1024,
    past it :func:`sum_order_rtol` (1.4e-6 apart at n = 20000 on an H100
    80GB HBM3 at 700 W)."""
    return 1e-6 if n <= 1024 else sum_order_rtol(n)


def fleet_feasibility_ref(starts: torch.Tensor, ends: torch.Tensor,
                          sizes: torch.Tensor, n: torch.Tensor, ps, d,
                          cpu_free, head=None, eps: float = 1e-6):
    """Cross-node admission verdict for one request at deadline ``d``
    from each node's ``cpu_free``: ``((K,) feasible, (K,) load)`` of the
    stacked (K, N) ledgers (:func:`fleet_search_ref` without ``j`` and
    ``cap``)."""
    feas, _, _, load = fleet_search_ref(starts, ends, sizes, n, ps, d,
                                        cpu_free, head, eps)
    return feas, load


def link_cost_ref(starts: torch.Tensor, ends: torch.Tensor,
                  sizes: torch.Tensor, n: torch.Tensor, ps, d,
                  busy: torch.Tensor, head, t_src, lat_row: torch.Tensor,
                  inv_bw_row: torch.Tensor, payload, eps: float = 1e-6):
    """Referral scoring of one request sitting at a source node at
    ``t_src``: its wire-delayed arrival at each of K candidates,
    ``fma(payload, inv_bw_row, t_src + lat_row)`` with one rounding
    (:func:`fma32`, as XLA contracts the reference's jitted ``t_src +
    lat_row + payload * inv_bw_row``), then the admission verdict from
    ``max(arrive, busy)``.  Returns ``((K,) feasible, (K,) arrive, (K,)
    load)``."""
    K = starts.shape[0]
    f32, dev = starts.dtype, starts.device
    scalar = lambda v: torch.as_tensor(v, dtype=f32, device=dev).reshape(())
    arrive = fma32(scalar(payload).expand(K), inv_bw_row.reshape(K),
                   scalar(t_src) + lat_row.reshape(K))
    free = torch.maximum(arrive, busy.reshape(K))
    feas, _, _, load = fleet_search_ref(starts, ends, sizes, n, ps, d,
                                        free, head, eps)
    return feas, arrive, load


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
