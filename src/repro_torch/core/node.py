"""MEC node model: one queue + one worst-case-deterministic processor (the
port's copy of ``repro/core/node.py``).

The paper assumes all MEC nodes have equivalent computing resources and that
every service hits its worst-case processing time, so the processor model is
a deterministic single server.  The *ledger* (queue) decides admission; the
executor is work-conserving (starts the head request the moment the CPU is
free, regardless of the block's scheduled-late position — see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

from repro_torch.core.request import Request


class QueueLike(Protocol):
    def push(self, request: Request, cpu_free_time: float, forced: bool = ...) -> bool: ...
    def pop(self) -> Optional[Request]: ...
    def pending_work(self) -> float: ...
    def __len__(self) -> int: ...


@dataclasses.dataclass
class NodeMetrics:
    received: int = 0          # arrivals incl. forwarded-in
    admitted: int = 0
    forwards_out: int = 0
    forced_pushes: int = 0
    discarded: int = 0
    processed: int = 0
    met_deadline: int = 0


class MECNode:
    """One MEC node: admission queue + deterministic single-server CPU."""

    def __init__(self, node_id: int, queue: QueueLike):
        self.node_id = node_id
        self.queue = queue
        self.busy_until = 0.0
        self.active: Optional[Request] = None
        self.metrics = NodeMetrics()

    def cpu_free_time(self, now: float) -> float:
        """Absolute time at which the CPU will next be free."""
        return max(now, self.busy_until)

    def try_admit(self, request: Request, now: float, forced: bool) -> bool:
        ok = self.queue.push(request, self.cpu_free_time(now), forced=forced)
        if ok:
            self.metrics.admitted += 1
            if forced:
                self.metrics.forced_pushes += 1
        return ok

    def start_next(self, now: float) -> Optional[Request]:
        """Pop and start the head request if the CPU is idle. Returns it."""
        if self.active is not None or now < self.busy_until:
            return None
        req = self.queue.pop()
        if req is None:
            return None
        self.active = req
        self.busy_until = now + req.proc_time
        return req

    def complete(self, now: float) -> Request:
        req = self.active
        assert req is not None
        req.completion_time = now
        req.served_by = self.node_id
        self.active = None
        self.metrics.processed += 1
        if req.met_deadline:
            self.metrics.met_deadline += 1
        return req
