"""Request / service model for the MEC-LB orchestration plane (the port's
copy of ``repro/core/request.py``).

Faithful to Table I of the paper: each *service* is a (resolution,
environment) pair with a worst-case processing time and a relative SLA
deadline, both in generic "UT" units.  A *request* is one invocation of a
service arriving at a MEC node.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

_req_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class Service:
    """One service class (Table I row)."""

    name: str
    pixels: int
    environment: str          # "busy" | "isolated"
    proc_time: float          # worst-case processing time (UT)
    deadline: float           # relative SLA deadline (UT)

    def __post_init__(self) -> None:
        if self.proc_time <= 0:
            raise ValueError(f"proc_time must be positive, got {self.proc_time}")
        if self.deadline <= 0:
            raise ValueError(f"deadline must be positive, got {self.deadline}")


@dataclasses.dataclass
class Request:
    """One inference request with an SLA deadline.

    ``deadline`` is *absolute*: ``arrival_time + service.deadline``.
    ``rid`` is a process-wide creation counter; workloads sort by
    ``(arrival_time, rid)``, so equal arrival times keep creation order.
    """

    service: Service
    arrival_time: float
    origin_node: int
    rid: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    forwards: int = 0
    completion_time: Optional[float] = None
    served_by: Optional[int] = None

    @property
    def proc_time(self) -> float:
        return self.service.proc_time

    @property
    def deadline(self) -> float:
        """Absolute deadline."""
        return self.arrival_time + self.service.deadline


# ---------------------------------------------------------------------------
# Table I of the paper.
# ---------------------------------------------------------------------------
SERVICES = {
    "S1": Service("S1", pixels=8_294_400, environment="busy", proc_time=180.0, deadline=9000.0),
    "S2": Service("S2", pixels=2_073_600, environment="busy", proc_time=44.0, deadline=9000.0),
    "S3": Service("S3", pixels=921_600, environment="busy", proc_time=20.0, deadline=9000.0),
    "S4": Service("S4", pixels=8_294_400, environment="isolated", proc_time=180.0, deadline=4000.0),
    "S5": Service("S5", pixels=2_073_600, environment="isolated", proc_time=44.0, deadline=4000.0),
    "S6": Service("S6", pixels=921_600, environment="isolated", proc_time=20.0, deadline=4000.0),
}

SERVICE_ORDER = ("S1", "S2", "S3", "S4", "S5", "S6")
