"""Device-side telemetry: the fleet run's time-binned observability cube
(the port of ``repro/telemetry/timeline.py``).

The event-time fleet simulator exposes end-of-run aggregates; this
module adds the *dynamics* — per-bucket / per-node queue depth, busy
time, event-buffer occupancy and event-kind counters — as fixed-shape
tensors that ride the run, one cube per sweep cell under
``simulate_fn``'s leading cell axis.  With telemetry off nothing of it
is allocated or computed: the eager loop's state carries ``None`` and
``event_scan`` launches its instantiation without the carry.

Bucket contract (DESIGN.md §8): the run window ``[0, horizon)`` splits
into ``n_buckets`` equal buckets of width ``w = f32(f32(horizon) /
f32(n_buckets))``; a point event at time ``t`` bins into ``min(floor(t /
w), n_buckets - 1)``.  The reference runs that division under
``jax.jit`` with ``w`` a constant, and XLA's CPU compiler turns it into a
multiplication by the constant's f32 reciprocal: its buckets are
``floor(f32(t · f32(1 / w)))``, which differs from the true quotient for
a few times within an ulp or so below an edge ``k·w`` (``bucket_of_np``
of the reference divides, and so disagrees with its own compiled scan
there).  The port bins as the compiled reference does, in every engine —
the eager loop, the kernel's ``__fmul_rn`` and the host recorder — so
binning is bit-identical to it everywhere.  Time past the last bucket
edge counts into the last bucket for point events and is truncated for
the derived time integrals (depth / busy).

Two halves:

* **carried** (per event step): ``counts[node, bucket, kind]`` — the
  five event kinds below, attributed to the node where the strategy ran
  them — and ``occupancy_hwm[bucket]``, the high-water mark of the
  re-arrival buffer's live count sampled after every event step's push;
* **derived** (one pass over the terminal per-request arrays after the
  run): ``queue_depth[node, bucket]`` — the time-average ledger depth,
  from each served request's queue residency interval ``[arrival +
  transfer, completion - proc/speed]`` — and ``busy_time[node, bucket]``
  from its execution interval ``[completion - proc/speed, completion]``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# event kinds, in counts[..., kind] order.  DISCARD folds in the fleet's
# forced-push overflow; SERVE counts admissions, forced ones included —
# the host engine's on_admit / on_discard hook semantics.
KIND_ARRIVAL, KIND_REARRIVAL, KIND_FORWARD, KIND_DISCARD, KIND_SERVE = \
    range(5)
N_KINDS = 5
KIND_NAMES = ("arrival", "rearrival", "forward", "discard", "serve")


class TelemetryConfig(NamedTuple):
    """The telemetry knobs: ``n_buckets`` fixes every telemetry tensor
    shape; ``horizon`` is the end of the binned window (events past it
    clip into the last bucket).  For a comparison across engines pass the
    host run's ``end_time`` so both summaries bin the same window."""
    n_buckets: int
    horizon: float

    @property
    def width(self) -> np.float32:
        """The f32 bucket width every engine divides by."""
        return bucket_width(self.horizon, self.n_buckets)


class TelemetryFrame(NamedTuple):
    """The telemetry cube of one run; under ``simulate_fn``'s cell axis
    every tensor gains the leading ``(C,)``."""
    counts: torch.Tensor          # (K, NB, N_KINDS) i32 event-kind counters
    queue_depth: torch.Tensor     # (K, NB) f32 time-average ledger depth
    busy_time: torch.Tensor       # (K, NB) f32 CPU-busy UT within the bucket
    occupancy_hwm: torch.Tensor   # (NB,) i32 re-arrival buffer high water
    bucket_width: torch.Tensor    # () f32: the f32 width (horizon / NB)

    def cell(self, c: int) -> "TelemetryFrame":
        """The cube of sweep cell ``c`` (``simulate_fn`` with a cell axis)."""
        return TelemetryFrame(*(t[c] for t in self))

    @property
    def utilization(self) -> torch.Tensor:
        """(K, NB) busy fraction of each bucket, in [0, 1]."""
        w = self.bucket_width
        return self.busy_time / (w[..., None, None] if w.dim() else w)


def bucket_width(horizon: float, n_buckets: int) -> np.float32:
    """``f32(f32(horizon) / f32(n_buckets))``, computed once on the host."""
    if n_buckets <= 0:
        raise ValueError(f"n_buckets must be positive, got {n_buckets}")
    if not horizon > 0.0:
        raise ValueError(f"horizon must be positive, got {horizon}")
    return np.float32(np.float32(horizon) / np.float32(n_buckets))


def reciprocal(width) -> np.float32:
    """``f32(1 / w)``: the constant the compiled reference multiplies event
    times by in place of dividing by ``w``."""
    return np.float32(1.0) / np.float32(width)


def bucket_of(t: torch.Tensor, width, n_buckets: int) -> torch.Tensor:
    """Bucket index of f32 event times ``t``: ``clamp(t · f32(1 / w), 0,
    NB - 1)`` on the float side (a +BIG time cannot overflow the cast),
    then truncation to int32."""
    r = torch.tensor(reciprocal(width), device=t.device)
    return torch.clamp(t * r, 0, n_buckets - 1).to(torch.int32)


def bucket_of_np(t, width: np.float32, n_buckets: int) -> np.ndarray:
    """Host mirror of :func:`bucket_of`: the same f32 product, clip on the
    float side and truncation."""
    t32 = np.asarray(t, np.float32)
    return np.clip(t32 * reciprocal(width), 0, n_buckets - 1).astype(
        np.int32)


def interval_histogram(lo: torch.Tensor, hi: torch.Tensor,
                       node: torch.Tensor, valid: torch.Tensor,
                       n_nodes: int, width, n_buckets: int) -> torch.Tensor:
    """Per-(node, bucket) total overlap of R intervals ``[lo, hi]``.

    ``lo``, ``hi``, ``node`` and ``valid`` are (R,), or (C, R) with a
    leading cell axis; returns (K, NB), or (C, K, NB), sums in UT.  Time
    outside ``[0, n_buckets · width)`` is truncated; invalid rows
    (never-served requests) add nothing, whatever their ``node``.  The
    sums go through ``index_add_`` (on CUDA in no fixed order: held to
    ``summary.DERIVED_ATOL``, the reference's contract).
    """
    batched = lo.dim() == 2
    lo2, hi2 = (lo, hi) if batched else (lo[None], hi[None])
    node2, valid2 = (node, valid) if batched else (node[None], valid[None])
    C, R = lo2.shape
    w = torch.tensor(np.float32(width), device=lo.device)
    edges_lo = torch.arange(n_buckets, dtype=lo.dtype, device=lo.device) * w
    edges_hi = edges_lo + w
    ov = torch.clamp(torch.minimum(hi2[..., None], edges_hi)
                     - torch.maximum(lo2[..., None], edges_lo), min=0.0)
    ov = torch.where(valid2[..., None], ov, 0.0)
    cells = torch.arange(C, device=lo.device)[:, None] * n_nodes
    idx = (cells + torch.clamp(node2, 0, n_nodes - 1)).reshape(-1)
    out = torch.zeros((C * n_nodes, n_buckets), dtype=lo.dtype,
                      device=lo.device)
    out.index_add_(0, idx, ov.reshape(C * R, n_buckets))
    out = out.view(C, n_nodes, n_buckets)
    return out if batched else out[0]


def interval_histogram_np(lo, hi, node, valid, n_nodes: int,
                          width, n_buckets: int) -> np.ndarray:
    """Numpy mirror of :func:`interval_histogram` for one run (f32
    throughout), for the host-side ``TelemetrySummary``."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    edges_lo = (np.arange(n_buckets, dtype=np.float32)
                * np.float32(width))
    edges_hi = edges_lo + np.float32(width)
    ov = np.clip(np.minimum(hi[:, None], edges_hi[None, :])
                 - np.maximum(lo[:, None], edges_lo[None, :]), 0.0, None)
    ov[~np.asarray(valid, bool)] = 0.0
    out = np.zeros((n_nodes, n_buckets), np.float32)
    np.add.at(out, np.clip(np.asarray(node), 0, n_nodes - 1), ov)
    return out


def telemetry_init(n_nodes: int, n_buckets: int, device: DeviceLike = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fresh carried-telemetry tensors ``(counts, occupancy_hwm)`` on
    ``device`` (``None`` means CUDA)."""
    device = resolve_device(device)
    return (torch.zeros((n_nodes, n_buckets, N_KINDS), dtype=torch.int32,
                        device=device),
            torch.zeros((n_buckets,), dtype=torch.int32, device=device))
