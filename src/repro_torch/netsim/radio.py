"""Radio access model: which MEC node a request enters at, and what the
uplink costs (the port's copy of ``repro/netsim/radio.py``).

UEs (cameras, phones, AGVs) attach to *cell sites*, each cell fronts one
MEC node, and mobility hands a UE over between cells.  The model gives
the orchestration plane two things:

* **ingress node** — ``cell_of(ue, t).node``: where the request enters
  the fleet (a handover changes it);
* **uplink delay** — radio + fronthaul latency plus the frame's wire
  time on the cell's uplink; it shifts the request's arrival at the node
  while the SLA clock starts at capture time, so the uplink consumes
  deadline budget as a referral does.

:class:`RadioWorkload` wraps a base workload, reads its origins as UE
ids and emits requests whose origin, arrival and deadline budget went
through the radio model.  A zero radio (0-latency, infinite-bandwidth
cells, identity attachment) reproduces the base workload exactly.  The
mobility draws are copied draw for draw from the JAX package, so both
give the same request lists.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.request import Request, Service
from repro_torch.netsim.link import LinkModel, default_payload
from repro_torch.orchestration.topology import Topology
from repro_torch.orchestration.workload import Workload

#: deadline floor after the uplink cost: a request whose uplink eats the
#: whole SLA budget keeps a positive deadline and is infeasible everywhere
MIN_DEADLINE = 1e-6


@dataclasses.dataclass(frozen=True)
class CellSite:
    """One gNB/cell: fronts one MEC node, owns its uplink pricing."""
    cell_id: int
    node: int                          # MEC node this cell's traffic enters
    uplink_latency: float = 0.0        # radio + fronthaul, UT
    uplink_bandwidth: float = math.inf  # MB/UT

    def uplink_delay(self, payload_mb: float) -> float:
        if math.isinf(self.uplink_bandwidth):
            return self.uplink_latency
        return self.uplink_latency + payload_mb / self.uplink_bandwidth


class RadioModel:
    """Cell/UE attachment with an optional handover (mobility) trace.

    ``attachment[ue]`` is the UE's initial cell (default ``ue %
    n_cells``); ``mobility[ue]`` is a time-sorted ``[(t, cell_id), ...]``
    handover schedule: from time ``t`` on the UE's traffic enters the new
    cell's node.  Queries are pure functions of ``(ue, t)``.
    """

    def __init__(self, cells: Sequence[CellSite],
                 attachment: Optional[Dict[int, int]] = None,
                 mobility: Optional[Dict[int, Sequence[Tuple[float, int]]]]
                 = None,
                 name: str = "radio"):
        if not cells:
            raise ValueError("need at least one cell site")
        self.cells = {c.cell_id: c for c in cells}
        if len(self.cells) != len(cells):
            raise ValueError("duplicate cell_id")
        self.name = name
        self._cell_order = sorted(self.cells)
        self.attachment = dict(attachment or {})
        self.mobility: Dict[int, List[Tuple[float, int]]] = {}
        for ue, events in (mobility or {}).items():
            ev = sorted((float(t), int(c)) for t, c in events)
            for _, c in ev:
                if c not in self.cells:
                    raise ValueError(f"handover target cell {c} unknown")
            self.mobility[ue] = ev

    @property
    def n_nodes(self) -> int:
        return 1 + max(c.node for c in self.cells.values())

    def initial_cell(self, ue: int) -> int:
        got = self.attachment.get(ue)
        if got is not None:
            return got
        return self._cell_order[ue % len(self._cell_order)]

    def cell_of(self, ue: int, t: float) -> CellSite:
        """The cell ``ue`` is attached to at time ``t`` (the last handover
        at or before ``t`` wins)."""
        cell = self.initial_cell(ue)
        events = self.mobility.get(ue)
        if events:
            k = bisect.bisect_right([e[0] for e in events], t)
            if k:
                cell = events[k - 1][1]
        return self.cells[cell]

    def ingress(self, ue: int, t: float) -> int:
        """MEC node a request from ``ue`` at time ``t`` enters."""
        return self.cell_of(ue, t).node

    def handovers(self, ue: int) -> int:
        return len(self.mobility.get(ue, ()))

    @classmethod
    def per_node(cls, topology: Topology, cells_per_node: int = 1, *,
                 uplink_latency: float = 0.0,
                 uplink_bandwidth: float = math.inf,
                 name: str = "per_node") -> "RadioModel":
        """``cells_per_node`` identical cells fronting every MEC node
        (cell ids ``node * cells_per_node + k``)."""
        cells = [CellSite(n * cells_per_node + k, n,
                          uplink_latency, uplink_bandwidth)
                 for n in range(topology.n_nodes)
                 for k in range(cells_per_node)]
        return cls(cells, name=name)

    @classmethod
    def from_link(cls, link: LinkModel, cells_per_node: int = 1,
                  name: Optional[str] = None) -> "RadioModel":
        """Cells priced with the link model's uplink profile."""
        return cls.per_node(link.topology, cells_per_node,
                            uplink_latency=link.uplink_latency,
                            uplink_bandwidth=link.uplink_bandwidth,
                            name=name or f"radio:{link.name}")

    def with_random_mobility(self, n_ues: int, horizon: float,
                             handovers_per_ue: float = 1.0,
                             seed: int = 0) -> "RadioModel":
        """A copy with a seeded random-handover trace: each UE makes
        ``Poisson(handovers_per_ue)`` handovers at uniform times to
        uniformly random other cells."""
        rng = random.Random(f"mobility:{self.name}:{seed}:{n_ues}")
        cells = list(self._cell_order)
        mobility: Dict[int, List[Tuple[float, int]]] = {}
        for ue in range(n_ues):
            # inverse-CDF Poisson draw: one uniform, process-stable
            n_ho = 0
            acc, p = math.exp(-handovers_per_ue), math.exp(-handovers_per_ue)
            u = rng.random()
            while u > acc and n_ho < 64:
                n_ho += 1
                p *= handovers_per_ue / n_ho
                acc += p
            if not n_ho:
                continue
            cur = self.initial_cell(ue)
            events = []
            for t in sorted(rng.uniform(0.0, horizon) for _ in range(n_ho)):
                others = [c for c in cells if c != cur] or [cur]
                cur = rng.choice(others)
                events.append((t, cur))
            mobility[ue] = events
        return RadioModel(list(self.cells.values()),
                          attachment=dict(self.attachment),
                          mobility=mobility,
                          name=f"{self.name}+mob{seed}")


class RadioWorkload(Workload):
    """A base workload pushed through the radio model.

    The base workload's ``origin_node`` values are UE ids; each request's
    origin becomes its UE's cell's node at capture time, its arrival is
    shifted by the cell's uplink delay and its relative deadline shrinks
    by the same amount (floored at :data:`MIN_DEADLINE`).  ``link`` gives
    the payload model (frame sizes); without one the default frame model
    prices the uplink.
    """

    def __init__(self, base: Workload, radio: RadioModel,
                 link: Optional[LinkModel] = None,
                 name: Optional[str] = None):
        self.base = base
        self.radio = radio
        self.link = link
        self.name = name or f"{base.name}@{radio.name}"
        self.n_nodes = radio.n_nodes
        self._svc_cache: Dict[Tuple[str, float, float], Service] = {}

    def _payload(self, service: Service) -> float:
        if self.link is not None:
            return self.link.payload_of(service)
        return default_payload(service)

    def _budgeted(self, service: Service, d_up: float) -> Service:
        if d_up == 0.0:
            return service
        budget = max(service.deadline - d_up, MIN_DEADLINE)
        key = (service.name, service.proc_time, budget)
        svc = self._svc_cache.get(key)
        if svc is None:
            svc = dataclasses.replace(service, deadline=budget)
            self._svc_cache[key] = svc
        return svc

    def generate(self, seed: int) -> List[Request]:
        requests: List[Request] = []
        for r in self.base.generate(seed):
            ue, t_cap = r.origin_node, r.arrival_time
            cell = self.radio.cell_of(ue, t_cap)
            d_up = cell.uplink_delay(self._payload(r.service))
            requests.append(Request(
                service=self._budgeted(r.service, d_up),
                arrival_time=t_cap + d_up,
                origin_node=cell.node,
            ))
        return self._finish(requests)
