"""The FIFO baseline queue (the port's copy of ``FIFOQueue`` from
``repro/core/queues.py``; host Python, as in the reference).

:class:`FIFOQueue` is the Sequential Forwarding Algorithm v1 baseline
(Beraldi et al. [12], as used by the paper): a left-packed append-only
queue; a request is admitted iff the node can finish it within its
deadline given the work already queued; otherwise it is forwarded;
after M forwards it is force-appended and processed late.  It exposes
the preferential queue's interface: ``push(request, cpu_free_time,
forced) -> bool``, ``pop()``, ``peek()``, ``__len__``, ``pending_work()``
and ``scheduled_blocks(cpu_free_time)``.
"""
from __future__ import annotations

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
