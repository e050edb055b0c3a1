"""The queue interface shared by every admission queue (the port's copy
of ``QueueLike`` from ``repro/core/node.py``; the ``MECNode`` of the
event-heap orchestrator comes with that orchestrator)."""
from __future__ import annotations

from typing import Optional, Protocol

from repro_torch.core.request import Request


class QueueLike(Protocol):
    def push(self, request: Request, cpu_free_time: float, forced: bool = ...) -> bool: ...
    def pop(self) -> Optional[Request]: ...
    def pending_work(self) -> float: ...
    def __len__(self) -> int: ...
