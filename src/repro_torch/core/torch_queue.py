"""The preferential admission ledger and the sorted event buffer in torch
(the port of ``repro/core/jax_queue.py``).

* the ledger is (starts, ends, sizes, n) arrays sorted by time, ``+BIG``
  padded past ``n``;
* the feasibility test is searchsorted-as-masked-count plus prefix sums;
* the Fig. 2c-d cascade left-shift has a closed form — after inserting
  at position j with right edge ``cap``::

      new_end_i = min(end_i, cap - p_new - sum(sizes[i+1 .. j-1]))   (i < j)

  computed with one cumulative sum, so a push has no sequential walk;
* the event buffer is a compact sorted ``(B,)`` array of keys plus
  parallel value arrays, the device mirror of the host event heap.

Every function is a chain of tensor ops with no host round trip, and all
of them follow the JAX functions' arithmetic operation for operation, so
both packages agree bit for bit on the same f32 inputs.  Scalars are 0-d
tensors (or (1,) tensors; values to write may be Python numbers); ids
and counts stay int32.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

BIG = 1e30


class Ledger(NamedTuple):
    starts: torch.Tensor       # (N,) f32, +BIG past n
    ends: torch.Tensor         # (N,) f32, +BIG past n
    sizes: torch.Tensor        # (N,) f32, 0 past n
    n: torch.Tensor            # () int32


def empty_ledger(capacity: int, device: DeviceLike = None) -> Ledger:
    dev = resolve_device(device)
    return Ledger(
        starts=torch.full((capacity,), BIG, dtype=torch.float32, device=dev),
        ends=torch.full((capacity,), BIG, dtype=torch.float32, device=dev),
        sizes=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        n=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _at(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d index tensor, without a host round trip."""
    return a.index_select(0, i.reshape(1)).reshape(a.shape[1:])


def _as(v, like: torch.Tensor):
    """A value to write into ``like``: a tensor cast to its dtype, or a
    Python number kept as a scalar operand (no host-to-device copy)."""
    return v.to(like.dtype) if torch.is_tensor(v) else v


def _search(led: Ledger, p, d, cpu_free
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(feasible, position j, right edge cap) of one plain ledger."""
    starts, ends, sizes, n = led
    N = starts.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=starts.device)
    cap_idx = (starts < d).sum(dtype=torch.int32)       # first start >= d
    e_hi = (ends < d).sum(dtype=torch.int32)            # count of ends < d
    prev_ends = torch.cat([ends.new_full((1,), -BIG), ends[:-1]])
    has_gap = (starts > prev_ends) & (idx >= 1) & (idx < n)
    gap_ok = has_gap & (idx <= e_hi)
    prev_gap = torch.where(gap_ok, idx, 0).amax()
    no_straddle = e_hi >= cap_idx
    j = torch.where(no_straddle, e_hi, prev_gap)
    start_j = torch.where(j < n, _at(starts, torch.clamp(j, max=N - 1)), BIG)
    cap = torch.where(no_straddle, d, torch.minimum(start_j, d))
    start0 = torch.where(n > 0, starts[0], BIG)
    front = ~no_straddle & (prev_gap == 0)
    cap = torch.where(front, torch.minimum(start0, d), cap)
    j = torch.where(front, 0, j)
    pw = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
    pw_j = _at(pw, torch.clamp(j, max=N))
    feasible = cap - (cpu_free + pw_j) >= p - 1e-6
    return feasible & (cap > cpu_free), j, cap


def insert_at(starts, ends, sizes, head, n, feasible, forced_ok, j, cap, p,
              cpu_free, meta: Tuple[torch.Tensor, ...] = (),
              meta_vals: Tuple[torch.Tensor, ...] = ()):
    """Apply an admission on one ledger row at a pre-computed ``(j, cap)``.

    A feasible insert right-aligns the new block at ``cap`` and
    left-shifts earlier blocks by their cumulative slack; ``forced_ok``
    appends after the tail and moves nothing.  Rows may be head-pointer
    rows (retired prefix ``[0, head)`` holding -BIG/0, live blocks in
    ``[head, head + n)``); ``meta`` arrays ride the same shift with
    ``meta_vals`` written into the new slot.  Returns ``(starts, ends,
    sizes, admitted, meta)``.
    """
    N = starts.shape[0]
    admitted = feasible | forced_ok
    tail = head + n
    tail_end = torch.where(n > 0, _at(ends, torch.clamp(tail - 1, 0, N - 1)),
                           cpu_free)
    jj = torch.where(feasible, j, tail)
    right = torch.where(feasible, cap, tail_end + p)
    new_start = right - p
    idx = torch.arange(N, device=starts.device)
    before = idx < jj
    sz_before = torch.where(before, sizes, 0.0)
    between = sz_before.sum() - torch.cumsum(sz_before, 0)
    bound = torch.where(feasible, new_start - between, BIG)
    new_ends = torch.where(before, torch.minimum(ends, bound), ends)
    new_starts = torch.where(before, new_ends - sizes, starts)
    at_j = idx == jj

    def ins(pre, v, orig):
        shifted = torch.cat([pre[:1], pre[:-1]])     # entries >= j move right
        out = torch.where(before, pre, torch.where(at_j, _as(v, orig), shifted))
        return torch.where(admitted, out, orig)

    meta_out = tuple(ins(m, v, m) for m, v in zip(meta, meta_vals))
    return (ins(new_starts, new_start, starts), ins(new_ends, right, ends),
            ins(sizes, p, sizes), admitted, meta_out)


def admit(led: Ledger, p, d, cpu_free, forced=False,
          meta: Tuple[torch.Tensor, ...] = (),
          meta_vals: Tuple[torch.Tensor, ...] = ()):
    """The host queue's full admission: the feasible right-aligned insert,
    else (``forced``) the tail append.  Returns ``(ledger, admitted,
    was_forced, meta)``; a push into a full ledger is refused."""
    starts, ends, sizes, n = led
    has_room = n < starts.shape[0]
    ok, j, cap = _search(led, p, d, cpu_free)
    ok = ok & has_room
    was_forced = torch.as_tensor(forced, device=starts.device) & ~ok & has_room
    zero = torch.zeros((), dtype=torch.int32, device=starts.device)
    new_starts, new_ends, new_sizes, admitted, meta_out = insert_at(
        starts, ends, sizes, zero, n, ok, was_forced, j, cap, p, cpu_free,
        meta, meta_vals)
    out = Ledger(new_starts, new_ends, new_sizes,
                 torch.where(admitted, n + 1, n))
    return out, admitted, was_forced, meta_out


def push(led: Ledger, p, d, cpu_free) -> Tuple[Ledger, torch.Tensor]:
    """Admit if feasible; returns (new ledger, admitted flag)."""
    out, ok, _, _ = admit(led, p, d, cpu_free, forced=False)
    return out, ok


# ---------------------------------------------------------------------------
# sorted event buffer: keys ascending, head (index 0) is the earliest event
# ---------------------------------------------------------------------------
def event_push(keys: torch.Tensor, vals: Tuple[torch.Tensor, ...],
               n: torch.Tensor, key, val_new: Tuple, active):
    """Stable sorted insert: the slot is ``sum(keys <= key)`` over the live
    prefix, so an equal key lands after every buffered one — the host
    heap's ``(time, seq)`` order.  ``active=False`` is a no-op.  Returns
    ``(keys, vals, n, dropped)``; ``dropped`` flags an active push into a
    full buffer."""
    B = keys.shape[0]
    idx = torch.arange(B, dtype=torch.int32, device=keys.device)
    room = n < B
    active = torch.as_tensor(active, device=keys.device)
    do = active & room
    pos = ((keys <= key) & (idx < n)).sum(dtype=torch.int32)
    before, at = idx < pos, idx == pos

    def ins(a, v):
        shifted = torch.cat([a[:1], a[:-1]])
        out = torch.where(before, a, torch.where(at, _as(v, a), shifted))
        return torch.where(do, out, a)

    return (ins(keys, key), tuple(ins(a, v) for a, v in zip(vals, val_new)),
            n + do.to(n.dtype), active & ~room)


def event_pop(keys: torch.Tensor, vals: Tuple[torch.Tensor, ...],
              n: torch.Tensor, active):
    """Drop the head event; the vacated tail slot refills with ``+BIG`` /
    0 so the buffer stays sorted.  ``active=False`` is a no-op.  Read the
    head fields before popping."""
    do = torch.as_tensor(active, device=keys.device)

    def shift(a, fill):
        return torch.where(do, torch.cat([a[1:], a.new_full((1,), fill)]), a)

    return (shift(keys, BIG), tuple(shift(a, 0) for a in vals),
            n - do.to(n.dtype))
