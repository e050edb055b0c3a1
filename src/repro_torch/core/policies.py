"""Forwarding policies for the Sequential Forwarding Algorithm family (the
port's copy of ``repro/core/policies.py``).

The paper forwards to a *uniformly random* neighbor (excluding the current
node).  We additionally implement the related-work variants the paper
discusses, as comparison points:

* ``random``        — the paper / SFA [12]: uniform random neighbor.
* ``power_of_two``  — sample two random neighbors, forward to the one with
                      less pending work (classic Mitzenmacher po2; a natural
                      beyond-paper upgrade the paper's future-work hints at).
* ``least_loaded``  — consult all neighbors, pick the minimum pending work
                      (Beraldi et al. [11]-style, with full state).
* ``round_robin``   — deterministic cycling, a no-state baseline.

Policies only read ``pending_work()`` — they never touch queue internals, so
they compose with any queue discipline.

.. note:: This module is the legacy fully-connected API.  New code should
   use :class:`repro_torch.orchestration.Router`, which implements the
   same strategies (plus ``batched_feasible``) over an arbitrary
   :class:`~repro_torch.orchestration.topology.Topology`; the simulator
   routes through it.
"""
from __future__ import annotations

import random
from typing import List, Sequence

from repro_torch.core.node import MECNode


def _candidates(nodes: Sequence[MECNode], exclude: int) -> List[MECNode]:
    return [n for n in nodes if n.node_id != exclude]


class ForwardPolicy:
    name = "base"

    def __init__(self, rng: random.Random):
        self.rng = rng

    def choose(self, nodes: Sequence[MECNode], exclude: int) -> MECNode:
        raise NotImplementedError


class RandomPolicy(ForwardPolicy):
    name = "random"

    def choose(self, nodes: Sequence[MECNode], exclude: int) -> MECNode:
        return self.rng.choice(_candidates(nodes, exclude))


class PowerOfTwoPolicy(ForwardPolicy):
    name = "power_of_two"

    def choose(self, nodes: Sequence[MECNode], exclude: int) -> MECNode:
        cands = _candidates(nodes, exclude)
        if len(cands) == 1:
            return cands[0]
        a, b = self.rng.sample(cands, 2)
        return a if a.queue.pending_work() <= b.queue.pending_work() else b


class LeastLoadedPolicy(ForwardPolicy):
    name = "least_loaded"

    def choose(self, nodes: Sequence[MECNode], exclude: int) -> MECNode:
        cands = _candidates(nodes, exclude)
        return min(cands, key=lambda n: (n.queue.pending_work(), self.rng.random()))


class RoundRobinPolicy(ForwardPolicy):
    """Deterministic cycling over *stable node ids*.

    The pointer indexes the global id space and skips the excluded node, so
    a given pointer value always means the same node.  (Indexing into the
    excluded-filtered candidate list — the previous behavior — silently
    shifted which node each pointer value meant whenever ``exclude``
    changed, starving some nodes.)
    """

    name = "round_robin"

    def __init__(self, rng: random.Random):
        super().__init__(rng)
        self._next = 0

    def choose(self, nodes: Sequence[MECNode], exclude: int) -> MECNode:
        n = len(nodes)
        for _ in range(n):
            node = nodes[self._next % n]
            self._next += 1
            if node.node_id != exclude:
                return node
        raise ValueError(f"no candidate besides node {exclude}")


FORWARD_POLICIES = {
    "random": RandomPolicy,
    "power_of_two": PowerOfTwoPolicy,
    "least_loaded": LeastLoadedPolicy,
    "round_robin": RoundRobinPolicy,
}


def make_policy(name: str, rng: random.Random) -> ForwardPolicy:
    try:
        return FORWARD_POLICIES[name](rng)
    except KeyError:
        raise ValueError(f"unknown forward policy {name!r}; "
                         f"options: {sorted(FORWARD_POLICIES)}") from None
