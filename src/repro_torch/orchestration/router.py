"""Topology-aware forwarding router (the port of
``repro/orchestration/router.py``).

The legacy policies (``repro.core.policies``) hardcode the paper's
fully-connected cluster: candidates are "every node but me".  The
:class:`Router` keeps the same four strategies but draws candidates from
``topology.neighbors(node)``, so the identical policy code drives a mesh, a
ring, a star, or a two-tier cluster.  On a full mesh with the ``random``
policy it consumes its rng stream exactly like the legacy
``RandomPolicy`` — that is what keeps the simulator adapter golden-value
equivalent to the pre-refactor event loop.

Strategies (``Router(topology, policy=...)``):

* ``random``           — uniform over neighbors (the paper's SFA step);
* ``power_of_two``     — sample two neighbors, keep the less loaded;
* ``least_loaded``     — full neighbor scan, minimum pending work;
* ``round_robin``      — deterministic cycling over *stable node ids* (the
  pointer indexes the global id space and skips non-neighbors, so the
  rotation never shifts meaning when the excluded node changes);
* ``batched_feasible`` — score every neighbor's admission ledger in one
  device call (:func:`repro_torch.core.torch_queue.feasible_nodes`, on the
  router's ``device``) and pick the least-loaded neighbor that can still
  meet the request's deadline; falls back to ``least_loaded`` order when
  nobody can.  There is no host fallback: the device call runs or raises
  (:func:`_host_feasible` stays as the pure-Python mirror of the test).

Routed objects only need ``.queue`` (``pending_work()``, and
``scheduled_blocks()`` for ``batched_feasible``) and, for
``batched_feasible``, ``cpu_free_time(now)`` — the serving engine's
replicas qualify.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import torch_queue as tq
from repro_torch.core.request import Request
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.orchestration.topology import Topology

ROUTER_POLICIES = ("random", "power_of_two", "least_loaded", "round_robin",
                   "batched_feasible")


class Router:
    """Pick a forwarding target among a node's topology neighbors.

    ``network`` (a :class:`repro_torch.netsim.LinkModel`) makes the
    ``batched_feasible`` policy network-aware: each candidate is scored
    at its *delayed* arrival ``now + transfer_delay(src, cand, service)``,
    so a neighbor whose wire cost would eat the deadline slack is not
    chosen even if its queue alone could admit.  The other policies never
    read ledger state and are unaffected.  ``device`` is where
    ``batched_feasible`` scores (``None`` means CUDA, and raises without
    it; pass ``"cpu"`` to score on the CPU).
    """

    def __init__(self, topology: Topology, policy: str = "random",
                 rng: Optional[random.Random] = None, seed: int = 0,
                 network=None, forward_delay: float = 0.0,
                 device: DeviceLike = None):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"options: {sorted(ROUTER_POLICIES)}")
        self.topology = topology
        self.policy = policy
        self.network = network
        # the orchestrator's fixed per-forward delay: scored alongside the
        # wire cost so feasibility sees the true re-arrival time (the
        # orchestrator syncs it when it injects its network)
        self.forward_delay = float(forward_delay)
        self.rng = rng if rng is not None else random.Random(seed)
        self._rr = 0                         # stable-id round-robin pointer
        self.device = resolve_device(device)

    # -- public API ----------------------------------------------------------
    def candidate_ids(self, src: int) -> Tuple[int, ...]:
        return self.topology.neighbors(src)

    def choose_id(self, nodes: Sequence, src: int, *,
                  request: Optional[Request] = None,
                  now: float = 0.0) -> int:
        """Return the id of the forwarding target for a request at ``src``.

        ``nodes`` must be indexed by topology node id.
        """
        cand_ids = self.topology.neighbors(src)
        if not cand_ids:
            raise ValueError(f"node {src} has no neighbors to forward to")
        return getattr(self, f"_{self.policy}")(nodes, src, cand_ids,
                                                request, now)

    def choose(self, nodes: Sequence, src: int, *,
               request: Optional[Request] = None, now: float = 0.0):
        """Like :meth:`choose_id` but returns the node object."""
        return nodes[self.choose_id(nodes, src, request=request, now=now)]

    # -- strategies ----------------------------------------------------------
    @staticmethod
    def _load(node) -> float:
        return node.queue.pending_work()

    def _random(self, nodes, src, cand_ids, request, now) -> int:
        return self.rng.choice(cand_ids)

    def _power_of_two(self, nodes, src, cand_ids, request, now) -> int:
        if len(cand_ids) == 1:
            return cand_ids[0]
        a, b = self.rng.sample(cand_ids, 2)
        return a if self._load(nodes[a]) <= self._load(nodes[b]) else b

    def _least_loaded(self, nodes, src, cand_ids, request, now) -> int:
        return min(cand_ids,
                   key=lambda i: (self._load(nodes[i]), self.rng.random()))

    def _round_robin(self, nodes, src, cand_ids, request, now) -> int:
        n = self.topology.n_nodes
        neighbors = set(cand_ids)
        for _ in range(n):
            cand = self._rr % n
            self._rr += 1
            if cand in neighbors:
                return cand
        raise AssertionError("unreachable: cand_ids is non-empty")

    def _batched_feasible(self, nodes, src, cand_ids, request, now) -> int:
        if request is None:
            return self._least_loaded(nodes, src, cand_ids, request, now)
        # per-candidate processing time: fast nodes need less of the window
        ps = [request.proc_time / self.topology.speed(i) for i in cand_ids]
        # network-aware: the request reaches each candidate only after the
        # forward delay plus the referral's wire time, so feasibility is
        # scored at that arrival (matching the orchestrator's heap event)
        if self.network is not None:
            arrivals = [now + self.forward_delay
                        + self.network.transfer_delay(src, i,
                                                      request.service)
                        for i in cand_ids]
        else:
            arrivals = [now] * len(cand_ids)
        feasible = dict(zip(cand_ids, _score_feasible(
            nodes, cand_ids, ps, request.deadline, arrivals, self.device)))
        ranked = sorted(cand_ids, key=lambda i: (self._load(nodes[i]), i))
        for i in ranked:
            if feasible[i]:
                return i
        return ranked[0]                      # nobody feasible: least loaded


# ---------------------------------------------------------------------------
# Device-batched feasibility scoring
# ---------------------------------------------------------------------------
def _score_feasible(nodes, cand_ids: Sequence[int], ps: Sequence[float],
                    deadline: float, arrivals: Sequence[float],
                    device: torch.device) -> List[bool]:
    """One admission-feasibility bit per candidate (``ps`` holds the
    request's speed-scaled processing time, ``arrivals`` its per-candidate
    arrival time — they differ under a network model), via a single
    stacked call of :func:`torch_queue.feasible_nodes` on ``device``."""
    blocks = []
    frees = []
    for i, arr in zip(cand_ids, arrivals):
        node = nodes[i]
        free = node.cpu_free_time(arr) if hasattr(node, "cpu_free_time") \
            else arr
        frees.append(free)
        blocks.append(node.queue.scheduled_blocks(free)
                      if hasattr(node.queue, "scheduled_blocks") else [])
    cap = max(8, max((len(b) for b in blocks), default=0) + 1)
    cap = 1 << (cap - 1).bit_length()        # the reference's pow2 ledger
    K = len(cand_ids)
    ns = []
    h_starts = np.full((K, cap), tq.BIG, np.float32)
    h_ends = np.full((K, cap), tq.BIG, np.float32)
    h_sizes = np.zeros((K, cap), np.float32)
    for k, blist in enumerate(blocks):
        for j, (s, e) in enumerate(blist):
            h_starts[k, j] = s
            h_ends[k, j] = e
            h_sizes[k, j] = e - s
        ns.append(len(blist))
    f32 = dict(dtype=torch.float32, device=device)
    leds = tq.Ledger(starts=torch.from_numpy(h_starts).to(device),
                     ends=torch.from_numpy(h_ends).to(device),
                     sizes=torch.from_numpy(h_sizes).to(device),
                     n=torch.tensor(ns, dtype=torch.int32, device=device))
    ok = tq.feasible_nodes(leds, torch.tensor(ps, **f32),
                           torch.tensor(deadline, **f32),
                           torch.tensor(frees, **f32))
    return [bool(v) for v in ok.tolist()]


def _host_feasible(blocks: Sequence[Tuple[float, float]], p: float, d: float,
                   cpu_free: float) -> bool:
    """Pure-python mirror of the ledger test (gap search + cumulative-slack
    feasibility) that :func:`torch_queue.feasible_nodes` runs per row."""
    n = len(blocks)
    starts = [b[0] for b in blocks]
    ends = [b[1] for b in blocks]
    e_hi = sum(1 for e in ends if e < d)
    cap_idx = next((i for i, s in enumerate(starts) if s >= d), n)
    if e_hi >= cap_idx:
        j, cap = e_hi, d
    else:
        j = 0
        for i in range(e_hi, 0, -1):
            if starts[i] > ends[i - 1]:
                j = i
                break
        cap = min(starts[j], d) if n else d
    pw = sum(e - s for s, e in blocks[:j])
    return cap > cpu_free and cap - (cpu_free + pw) >= p - 1e-6
