"""The single event-driven orchestration core (the port's copy of
``repro/orchestration/orchestrator.py``; host Python and float64, as in
the reference).

One engine implements the paper's strategy — deadline-aware admission +
sequential forwarding (§III) — for every consumer:

* :func:`repro_torch.core.simulator.run_simulation` is a thin adapter
  over :class:`Orchestrator` (held to tests/golden_simulator.json);
* the serving engine places live requests with :func:`place`, the
  synchronous single-request variant of the same admit/forward loop;
* new experiments drive :class:`Orchestrator` directly with any
  :class:`~repro_torch.orchestration.topology.Topology` /
  :class:`~repro_torch.orchestration.workload.Workload` /
  :class:`~repro_torch.orchestration.router.Router` combination;
* :func:`repro_torch.fleetsim.validate.run_validation` holds the fleet
  simulator against it, request by request.

Heterogeneity: a node with ``topology.speed(i) = s`` processes every request
``s``-times faster — admission and execution both use the scaled processing
time, while SLA deadlines stay untouched.  The caller's request objects are
never mutated by the scaling (a scaled shadow copy rides through the queue;
completion results are copied back).

Observability: :class:`Hooks` exposes the four decision points of the
strategy (admit / forward / force / discard) plus completion, and
:class:`OrchestratorResult` carries per-node and per-service metric
breakdowns next to the headline aggregates.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import statistics
from typing import Callable, Dict, List, Optional, Sequence, TYPE_CHECKING

from repro_torch.core.node import MECNode, NodeMetrics, QueueLike
from repro_torch.core.request import Request, Service
from repro_torch.device import DeviceLike
from repro_torch.orchestration.router import Router
from repro_torch.orchestration.topology import Topology

if TYPE_CHECKING:                                  # pragma: no cover
    from repro_torch.netsim.link import LinkModel

_ARRIVAL, _COMPLETE = 0, 1


@dataclasses.dataclass
class Hooks:
    """Optional callbacks at the strategy's decision points.

    Signatures::

        on_admit(request, node, now, forced)    # admitted (forced = ran late)
        on_forward(request, src_node, dst_node, now)
        on_discard(request, node, now)          # discard_on_exhaust variant
        on_complete(request, node, now)
    """
    on_admit: Optional[Callable] = None
    on_forward: Optional[Callable] = None
    on_discard: Optional[Callable] = None
    on_complete: Optional[Callable] = None


@dataclasses.dataclass
class ServiceStats:
    """Per-service-class outcome counters."""
    total: int = 0
    processed: int = 0
    met_deadline: int = 0
    discarded: int = 0
    response_sum: float = 0.0

    @property
    def met_rate(self) -> float:
        return self.met_deadline / max(1, self.total)

    @property
    def mean_response_time(self) -> float:
        return self.response_sum / max(1, self.processed)


@dataclasses.dataclass
class OrchestratorResult:
    total_requests: int
    processed: int
    met_deadline: int
    forwards: int
    discarded: int
    mean_response_time: float
    end_time: float
    events: int
    per_node: List[NodeMetrics]
    per_service: Dict[str, ServiceStats]
    completed: List[Request]
    transfer_time: float = 0.0        # total wire time spent on referrals

    @property
    def met_rate(self) -> float:
        return self.met_deadline / max(1, self.total_requests)


class Orchestrator:
    """Event-heap engine: deadline-aware admission + sequential forwarding.

    ``queue_factory`` builds one admission queue per node (e.g.
    ``FastPreferentialQueue``).  The event loop mirrors the paper's §IV
    semantics exactly — arrival events try admission at the target node;
    rejects forward ``max_forwards`` times through the router; exhausted
    requests are force-pushed (or discarded under the Beraldi variant).

    ``network`` (a :class:`repro_torch.netsim.LinkModel`) prices every referral:
    the forwarded request re-arrives ``transfer_delay(src, dst, service)``
    later while its absolute deadline stays put, so the wire time comes
    straight out of the admission slack — a referral can *cause* a miss.
    The router inherits the same model for network-aware feasibility
    scoring.  ``network=None`` (and the zero model) reproduce the
    network-free event stream exactly (DESIGN.md §6).

    ``device`` is the default router's (``random``), built when no
    ``router`` is passed: ``None`` means CUDA and raises without it, as
    every entry point of the port does; pass ``"cpu"`` on a host without
    one.
    """

    def __init__(self, topology: Topology,
                 queue_factory: Callable[[], QueueLike],
                 router: Optional[Router] = None, *,
                 max_forwards: int = 2,
                 forward_delay: float = 0.0,
                 discard_on_exhaust: bool = False,
                 hooks: Optional[Hooks] = None,
                 network: Optional["LinkModel"] = None,
                 device: DeviceLike = None):
        self.topology = topology
        self.router = router if router is not None \
            else Router(topology, device=device)
        if self.router.topology is not topology:
            raise ValueError("router and orchestrator topology must match")
        self.network = network
        if network is not None:
            if network.n_nodes != topology.n_nodes:
                raise ValueError(f"network prices {network.n_nodes} nodes "
                                 f"for a {topology.n_nodes}-node topology")
            # the router's feasibility scoring must see the same wire
            # costs AND forward delay the heap events pay (no-op unless
            # batched_feasible)
            if self.router.network is None:
                self.router.network = network
            elif self.router.network is not network:
                raise ValueError("router and orchestrator price different "
                                 "networks; pass one LinkModel to both (or "
                                 "only to the orchestrator)")
            self.router.forward_delay = forward_delay
        self.max_forwards = max_forwards
        self.forward_delay = forward_delay
        self.discard_on_exhaust = discard_on_exhaust
        self.hooks = hooks or Hooks()
        self._queue_factory = queue_factory
        # Rebuilt at the top of every run() so the orchestrator is reusable;
        # kept as an attribute for post-run introspection (hooks receive
        # these node objects).
        self.nodes = [MECNode(i, queue_factory())
                      for i in range(topology.n_nodes)]
        self._scaled_services: Dict[tuple, Service] = {}
        self._originals: Dict[int, Request] = {}

    # -- speed scaling -------------------------------------------------------
    def _scaled(self, req: Request, speed: float) -> Request:
        """Shadow copy whose proc_time is scaled by the node speed (same rid,
        same absolute deadline)."""
        key = (req.service.name, req.service.proc_time, speed)
        svc = self._scaled_services.get(key)
        if svc is None:
            svc = dataclasses.replace(req.service,
                                      proc_time=req.service.proc_time / speed)
            self._scaled_services[key] = svc
        return Request(service=svc, arrival_time=req.arrival_time,
                       origin_node=req.origin_node, rid=req.rid,
                       forwards=req.forwards)

    def _try_admit(self, node: MECNode, req: Request, now: float,
                   forced: bool) -> bool:
        speed = self.topology.speed(node.node_id)
        if speed == 1.0:
            return node.try_admit(req, now, forced=forced)
        shadow = self._scaled(req, speed)
        ok = node.try_admit(shadow, now, forced=forced)
        if ok:
            self._originals[shadow.rid] = req
        return ok

    # -- event loop ----------------------------------------------------------
    def run(self, requests: Sequence[Request]) -> OrchestratorResult:
        # fresh node/queue state per run: busy_until and metrics must not
        # leak from a previous run on the same orchestrator
        self.nodes = [MECNode(i, self._queue_factory())
                      for i in range(self.topology.n_nodes)]
        self._originals.clear()
        nodes = self.nodes
        hooks = self.hooks
        seq = itertools.count()
        heap: List = []
        for req in requests:
            heapq.heappush(heap, (req.arrival_time, next(seq), _ARRIVAL, req,
                                  nodes[req.origin_node]))

        forwards = 0
        transfer_time = 0.0
        discarded_reqs: List[Request] = []
        completed: List[Request] = []
        events = 0
        end_time = 0.0
        network = self.network

        def dispatch(node: MECNode, now: float) -> None:
            started = node.start_next(now)
            if started is not None:
                heapq.heappush(heap, (node.busy_until, next(seq), _COMPLETE,
                                      started, node))

        while heap:
            now, _, kind, req, node = heapq.heappop(heap)
            events += 1
            end_time = now
            if kind == _COMPLETE:
                node.complete(now)
                orig = self._originals.pop(req.rid, None)
                if orig is not None:
                    orig.completion_time = req.completion_time
                    orig.served_by = req.served_by
                    req = orig
                completed.append(req)
                if hooks.on_complete:
                    hooks.on_complete(req, node, now)
                dispatch(node, now)
                continue

            # ARRIVAL
            node.metrics.received += 1
            exhausted = (req.forwards >= self.max_forwards
                         or self.topology.degree(node.node_id) == 0)
            forced = exhausted and not self.discard_on_exhaust
            if self._try_admit(node, req, now, forced=forced):
                if hooks.on_admit:
                    hooks.on_admit(req, node, now, forced)
                dispatch(node, now)
            elif exhausted:
                discarded_reqs.append(req)
                node.metrics.discarded += 1
                if hooks.on_discard:
                    hooks.on_discard(req, node, now)
            else:
                req.forwards += 1
                forwards += 1
                node.metrics.forwards_out += 1
                target = self.router.choose(nodes, node.node_id,
                                            request=req, now=now)
                # the referral rides the transport network: the request
                # re-arrives after the wire time, its deadline unmoved —
                # the transfer consumes exactly that much admission slack
                delay = self.forward_delay
                if network is not None:
                    hop = network.transfer_delay(node.node_id,
                                                 target.node_id, req.service)
                    delay += hop
                    transfer_time += hop
                heapq.heappush(heap, (now + delay, next(seq),
                                      _ARRIVAL, req, target))
                if hooks.on_forward:
                    hooks.on_forward(req, node, target, now)

        met = sum(1 for r in completed if r.met_deadline)
        resp = [r.completion_time - r.arrival_time for r in completed
                if r.completion_time is not None]
        return OrchestratorResult(
            total_requests=len(requests),
            processed=len(completed),
            met_deadline=met,
            forwards=forwards,
            discarded=len(discarded_reqs),
            mean_response_time=statistics.fmean(resp) if resp else 0.0,
            end_time=end_time,
            events=events,
            per_node=[n.metrics for n in nodes],
            per_service=_per_service(requests, completed, discarded_reqs),
            completed=completed,
            transfer_time=transfer_time,
        )


def _per_service(requests: Sequence[Request], completed: Sequence[Request],
                 discarded: Sequence[Request]) -> Dict[str, ServiceStats]:
    stats: Dict[str, ServiceStats] = {}
    for r in requests:
        stats.setdefault(r.service.name, ServiceStats()).total += 1
    for r in completed:
        s = stats.setdefault(r.service.name, ServiceStats())
        s.processed += 1
        if r.met_deadline:
            s.met_deadline += 1
        if r.completion_time is not None:
            s.response_sum += r.completion_time - r.arrival_time
    for r in discarded:
        stats.setdefault(r.service.name, ServiceStats()).discarded += 1
    return stats


# ---------------------------------------------------------------------------
# Synchronous placement — the serving engine's entry into the same strategy.
# ---------------------------------------------------------------------------
def place(request, origin: int, nodes: Sequence, router: Router, *,
          now: float, max_forwards: int,
          admit: Callable[[object, object, float, bool], bool],
          discard_on_exhaust: bool = False,
          on_forward: Optional[Callable] = None):
    """Admit-or-forward a single live request, synchronously (zero network
    delay), until it is admitted, force-pushed, or discarded.

    ``nodes`` must be indexed by topology node id; ``admit(node, request,
    now, forced)`` performs the actual admission attempt (so callers bring
    their own node type — MECNode, ServingReplica, ...).  ``request`` only
    needs a mutable integer ``forwards`` attribute.

    Returns ``(outcome, node)`` with outcome in {"admitted", "discarded"}.
    """
    idx = origin
    while True:
        target = nodes[idx]
        exhausted = (request.forwards >= max_forwards
                     or router.topology.degree(idx) == 0)
        forced = exhausted and not discard_on_exhaust
        if admit(target, request, now, forced):
            return "admitted", target
        if exhausted:
            return "discarded", target
        request.forwards += 1
        nxt = router.choose_id(nodes, idx, request=request, now=now)
        if on_forward:
            on_forward(request, target, nodes[nxt], now)
        idx = nxt
