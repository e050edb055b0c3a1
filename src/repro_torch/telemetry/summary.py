"""TelemetrySummary — the engine-neutral time-binned view, plus the
cross-engine comparator (the port's copy of ``repro/telemetry/summary.py``;
numpy on the host).

Both observability paths reduce to the same structure: the fleet run's
:class:`~repro_torch.telemetry.timeline.TelemetryFrame` converts via
:meth:`TelemetrySummary.from_frame`, the host
:class:`~repro_torch.telemetry.trace.TraceRecorder` builds one directly
from the hook stream.  :func:`compare_summaries` then extends the repo's
exactness contract from outcomes to dynamics: event-kind counters and
buffer-occupancy high-water marks must agree **exactly** (binning is
bit-identical f32 arithmetic on both engines, DESIGN.md §8), while the
derived time integrals (queue depth, busy time) carry a small tolerance
— their interval endpoints come from f64 host completions vs f32 device
completion chains, so the integrals differ at the last-ulp-of-an-
endpoint level, never structurally.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.telemetry.timeline import KIND_NAMES, TelemetryFrame

#: default tolerance on the derived integrals, as a fraction of the
#: bucket: |Δbusy| <= DERIVED_ATOL * width, |Δdepth| <= DERIVED_ATOL *
#: peak depth (scale-free).  Worst case per bucket is ~(requests in
#: bucket) x ulp(horizon); measured values sit far below this.
DERIVED_ATOL = 0.02


@dataclasses.dataclass
class TelemetrySummary:
    """Time-binned run dynamics: ``n_buckets`` buckets over ``[0,
    horizon)`` for ``n_nodes`` nodes (see DESIGN.md §8 for the bucket
    contract shared by both engines)."""
    counts: np.ndarray           # (K, NB, N_KINDS) i32
    queue_depth: np.ndarray      # (K, NB) f32 time-average ledger depth
    busy_time: np.ndarray        # (K, NB) f32 CPU-busy UT per bucket
    occupancy_hwm: np.ndarray    # (NB,) i32 in-flight referral high water
    bucket_width: float
    horizon: float

    @property
    def n_nodes(self) -> int:
        return self.counts.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.counts.shape[1]

    @property
    def utilization(self) -> np.ndarray:
        """(K, NB) busy fraction per bucket, in [0, 1]."""
        return self.busy_time / np.float32(self.bucket_width)

    @classmethod
    def from_frame(cls, frame: TelemetryFrame) -> "TelemetrySummary":
        """Device cube -> host summary (one sweep cell: no leading cell
        axis — index the stacked frame first for sweep outputs)."""
        frame = TelemetryFrame(*(t.detach().cpu().numpy().copy()
                                 if torch.is_tensor(t) else t for t in frame))
        counts = np.asarray(frame.counts)
        if counts.ndim != 3:
            raise ValueError(
                "from_frame expects one sweep cell (counts of rank 3, got "
                f"shape {counts.shape}); index the sweep frame by cell first")
        width = float(np.asarray(frame.bucket_width))
        return cls(counts=counts.astype(np.int32),
                   queue_depth=np.asarray(frame.queue_depth, np.float32),
                   busy_time=np.asarray(frame.busy_time, np.float32),
                   occupancy_hwm=np.asarray(frame.occupancy_hwm, np.int32),
                   bucket_width=width,
                   horizon=width * counts.shape[1])

    def kind_totals(self) -> dict:
        """Whole-run event counts per kind (sanity view)."""
        tot = self.counts.sum(axis=(0, 1))
        return {name: int(tot[i]) for i, name in enumerate(KIND_NAMES)}

    def depth_heatmap(self, max_width: int = 72) -> str:
        """ASCII heatmap: one row per node, one cell per bucket, depth
        rendered as 0-9+ (the examples/telemetry_tour.py view)."""
        glyphs = "0123456789"
        nb = min(self.n_buckets, max_width)
        lines = [f"queue depth (time-avg) per bucket, w={self.bucket_width:.0f} UT"]
        for k in range(self.n_nodes):
            row = "".join(
                "+" if d >= 10 else glyphs[int(d)]
                for d in np.clip(self.queue_depth[k, :nb], 0, 10))
            lines.append(f"node {k:3d} |{row}|")
        return "\n".join(lines)


@dataclasses.dataclass
class TelemetryAgreement:
    """Bucket-for-bucket comparison of two summaries (host vs device)."""
    counts_mismatches: int       # (node, bucket, kind) cells that differ
    occupancy_mismatches: int    # buckets whose hwm differs
    depth_max_err: float         # max |Δ time-avg depth| over (node, bucket)
    busy_max_err_frac: float     # max |Δ busy| / bucket width
    depth_tol: float
    busy_tol_frac: float

    @property
    def ok(self) -> bool:
        return (self.counts_mismatches == 0
                and self.occupancy_mismatches == 0
                and self.depth_max_err <= self.depth_tol
                and self.busy_max_err_frac <= self.busy_tol_frac)

    def row(self) -> str:
        tag = "agree" if self.ok else "DISAGREE"
        return (f"counts {self.counts_mismatches} occ "
                f"{self.occupancy_mismatches} mismatches, "
                f"ddepth {self.depth_max_err:.2e} "
                f"dbusy {self.busy_max_err_frac:.2e}w  [{tag}]")


def compare_summaries(host: TelemetrySummary, device: TelemetrySummary,
                      atol: float = DERIVED_ATOL,
                      depth_scale: Optional[float] = None
                      ) -> TelemetryAgreement:
    """The cross-engine telemetry contract, measured.

    Counters and occupancy high-water marks compare exactly; the derived
    integrals compare within ``atol`` of their natural scales (bucket
    width for busy time; ``depth_scale`` — default the peak observed
    depth, floored at 1 — for queue depth).
    """
    for name in ("counts", "queue_depth", "busy_time", "occupancy_hwm"):
        a, b = getattr(host, name), getattr(device, name)
        if a.shape != b.shape:
            raise ValueError(f"summary shapes differ on {name}: "
                             f"{a.shape} vs {b.shape}")
    if not np.isclose(host.bucket_width, device.bucket_width):
        raise ValueError(f"bucket widths differ: {host.bucket_width} vs "
                         f"{device.bucket_width}")
    if depth_scale is None:
        depth_scale = max(1.0, float(host.queue_depth.max(initial=0.0)))
    depth_err = float(np.abs(host.queue_depth
                             - device.queue_depth).max(initial=0.0))
    busy_err = float(np.abs(host.busy_time
                            - device.busy_time).max(initial=0.0))
    return TelemetryAgreement(
        counts_mismatches=int(np.sum(host.counts != device.counts)),
        occupancy_mismatches=int(np.sum(host.occupancy_hwm
                                        != device.occupancy_hwm)),
        depth_max_err=depth_err,
        busy_max_err_frac=busy_err / float(host.bucket_width),
        depth_tol=atol * depth_scale,
        busy_tol_frac=atol)
