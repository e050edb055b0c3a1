"""What the metric readers share: the calls of a run's window.

A record's ``calls`` are ``(t0, t1, frames, resolution)`` of each call
into a replica's ``run_batch``, host clock, in order; ``window`` is the
window's ``(start, end)``.  A frame counts when its call returned inside
the window.
"""
from __future__ import annotations

from typing import List, Tuple


def seconds(rec: dict) -> float:
    t0, t1 = rec["window"]
    return t1 - t0


def counted(rec: dict) -> List[Tuple[float, float, int, int]]:
    """The calls whose frames were done inside the window."""
    t0, t1 = rec["window"]
    return [c for c in rec["calls"] if t0 <= c[1] <= t1]


def frames(rec: dict) -> int:
    return sum(c[2] for c in counted(rec))


def in_calls_s(rec: dict) -> float:
    """Wall time of the window spent inside ``run_batch`` calls."""
    t0, t1 = rec["window"]
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b, _, _ in rec["calls"])
