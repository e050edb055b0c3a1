"""Synchronous placement: the serving engine's entry into the paper's
strategy (the port of ``place`` from ``repro/orchestration/orchestrator.py``;
the event-heap ``Orchestrator`` of the simulation plane comes with a
later slice).  Host Python, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.orchestration.router import Router


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
