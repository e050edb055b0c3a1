"""Baseline queues sharing the preferential queue's interface (the port's
copy of ``repro/core/queues.py``; host Python, as in the reference).

* :class:`FIFOQueue` — the Sequential Forwarding Algorithm v1 baseline
  (Beraldi et al. [12], as used by the paper): a left-packed append-only
  queue; a request is admitted iff the node can finish it within its
  deadline given the work already queued; otherwise it is forwarded;
  after M forwards it is force-appended and processed late.
* :class:`EDFQueue` — earliest-deadline-first with an exact admission
  test: requests are kept sorted by absolute deadline, and a request is
  admitted iff no admitted request (old or new) then misses its deadline.

Both expose ``push(request, cpu_free_time, forced) -> bool``, ``pop()``,
``peek()``, ``__len__``, ``pending_work()`` and
``scheduled_blocks(cpu_free_time)``.
"""
from __future__ import annotations

import bisect
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.core.request import Request

_EPS = 1e-9


class FIFOQueue:
    """SFA v1 FIFO queue with deadline admission test (paper baseline)."""

    def __init__(self) -> None:
        self._items: Deque[Request] = deque()
        self._total_work = 0.0

    def __len__(self) -> int:
        return len(self._items)

    def is_empty(self) -> bool:
        return not self._items

    def pending_work(self) -> float:
        return self._total_work

    def push(self, request: Request, cpu_free_time: float, forced: bool = False) -> bool:
        completion = cpu_free_time + self._total_work + request.proc_time
        if completion > request.deadline + _EPS and not forced:
            return False
        self._items.append(request)
        self._total_work += request.proc_time
        return True

    def peek(self) -> Optional[Request]:
        return self._items[0] if self._items else None

    def pop(self) -> Optional[Request]:
        if not self._items:
            return None
        req = self._items.popleft()
        self._total_work -= req.proc_time
        return req

    def scheduled_blocks(self, cpu_free_time: float) -> List[Tuple[float, float]]:
        """Contiguous run-to-completion schedule starting at ``cpu_free_time``."""
        out, t = [], cpu_free_time
        for r in self._items:
            out.append((t, t + r.proc_time))
            t += r.proc_time
        return out


class EDFQueue:
    """Earliest-deadline-first with exact schedulability admission test.

    Admitted requests are kept sorted by absolute deadline (the *main*
    segment).  A forced push that cannot be scheduled feasibly goes to a
    late *overflow* segment executed after the main segment — analogous to
    the preferential queue's compact-and-append forced semantics: already
    admitted deadlines are never disturbed, the forced request runs late.
    """

    def __init__(self) -> None:
        self._main: List[Request] = []            # sorted by absolute deadline
        self._deadlines: List[float] = []
        self._overflow: List[Request] = []        # forced, already-late, FIFO
        self._total_work = 0.0

    def __len__(self) -> int:
        return len(self._main) + len(self._overflow)

    def is_empty(self) -> bool:
        return not self._main and not self._overflow

    def pending_work(self) -> float:
        return self._total_work

    def push(self, request: Request, cpu_free_time: float, forced: bool = False) -> bool:
        idx = bisect.bisect_right(self._deadlines, request.deadline)
        if self._schedulable_with(request, idx, cpu_free_time):
            self._main.insert(idx, request)
            self._deadlines.insert(idx, request.deadline)
            self._total_work += request.proc_time
            return True
        if not forced:
            return False
        self._overflow.append(request)
        self._total_work += request.proc_time
        return True

    def _schedulable_with(self, request: Request, idx: int, cpu_free_time: float) -> bool:
        t = cpu_free_time
        for r in self._main[:idx]:
            t += r.proc_time
        t += request.proc_time
        if t > request.deadline + _EPS:
            return False
        for r in self._main[idx:]:
            t += r.proc_time
            if t > r.deadline + _EPS:
                return False
        return True

    def peek(self) -> Optional[Request]:
        if self._main:
            return self._main[0]
        return self._overflow[0] if self._overflow else None

    def pop(self) -> Optional[Request]:
        if self._main:
            self._deadlines.pop(0)
            req = self._main.pop(0)
            self._total_work -= req.proc_time
            return req
        if self._overflow:
            req = self._overflow.pop(0)
            self._total_work -= req.proc_time
            return req
        return None

    def scheduled_blocks(self, cpu_free_time: float) -> List[Tuple[float, float]]:
        """Contiguous schedule: main segment in deadline order, then overflow."""
        out, t = [], cpu_free_time
        for r in list(self._main) + list(self._overflow):
            out.append((t, t + r.proc_time))
            t += r.proc_time
        return out


QUEUE_TYPES = {
    "fifo": FIFOQueue,
    "edf": EDFQueue,
}
