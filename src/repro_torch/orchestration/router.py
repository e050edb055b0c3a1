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
  call of :func:`repro_torch.kernels.ops.fleet_feasibility` (on CUDA one
  launch of the ``fleet_feasibility`` kernel, on the CPU its plain
  version) and pick the least-loaded neighbor that can still meet the
  request's deadline; falls back to ``least_loaded`` order when nobody
  can.  The reference scores with ``jax_queue.feasible_nodes``; with
  ``head = 0`` the kernel computes the same verdict per row.  There is no
  host fallback: the device call runs or raises (:func:`_host_feasible`
  stays as the pure-Python mirror of the test).

Routed objects only need ``.queue`` (``pending_work()``, and
``scheduled_blocks()`` for ``batched_feasible``) and, for
``batched_feasible``, ``cpu_free_time(now)`` — the serving engine's
replicas qualify.
"""
from __future__ import annotations

import random
from itertools import chain
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.request import Request
from repro_torch.core.torch_queue import BIG
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
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
        self._staging = None                 # batched_feasible's buffers

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
        if self._staging is None:
            self._staging = FeasibilityStaging(self.device)
        feasible = dict(zip(cand_ids, _score_feasible(
            nodes, cand_ids, ps, request.deadline, arrivals, self._staging)))
        ranked = sorted(cand_ids, key=lambda i: (self._load(nodes[i]), i))
        for i in ranked:
            if feasible[i]:
                return i
        return ranked[0]                      # nobody feasible: least loaded


# ---------------------------------------------------------------------------
# Device-batched feasibility scoring
# ---------------------------------------------------------------------------
def ledger_cap(blocks: Sequence[Sequence[Tuple[float, float]]]) -> int:
    """The reference's pow2 ledger width: at least 8 and above the
    longest row, so a row is never full (``head + n < N`` holds)."""
    cap = max(8, max((len(b) for b in blocks), default=0) + 1)
    return 1 << (cap - 1).bit_length()


def staged_views(buf, K: int, cap: int, int32=torch.int32):
    """``ops.fleet_feasibility``'s arguments as contiguous views of one
    flat f32 buffer (a tensor, or with ``int32=np.int32`` an array):
    ``(starts, ends, sizes, n, ps, d, cpu_free, head)``, the (K, cap)
    ledgers first, then (K,) ``n`` and ``head`` as int32 (the f32 words'
    bits), (K,) ``ps`` and ``cpu_free``, and (1,) ``d``.  The buffer holds
    ``3 K cap + 4 K + 1`` words."""
    L = K * cap
    ledger = lambda i: buf[i * L:(i + 1) * L].reshape(K, cap)
    vec = lambda i: buf[3 * L + i * K:3 * L + (i + 1) * K]
    return (ledger(0), ledger(1), ledger(2), vec(0).view(int32), vec(2),
            buf[3 * L + 4 * K:3 * L + 4 * K + 1], vec(3), vec(1).view(int32))


class FeasibilityStaging:
    """The inputs of one ``batched_feasible`` decision packed into one
    host buffer (pinned when ``device`` is CUDA) and one device buffer,
    both kept and grown by the router: a decision is one copy, one
    ``ops.fleet_feasibility`` call and one read of the K verdicts."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = torch.empty(0, dtype=torch.float32)
        self.dev = self.host
        self.words = self.host.numpy()       # the host buffer, as numpy

    def pack(self, blocks, ps, cpu_free, deadline) -> Tuple[int, int]:
        """Write the (K, cap) ledgers of ``blocks`` (one list of ``(start,
        end)`` per candidate) and the scalars into the host buffer, as the
        reference builds its ledgers: f64 values rounded to f32, sizes
        ``end - start`` in f64 before rounding, ``+BIG`` / 0 padding.
        Returns ``(K, cap)``."""
        K, cap = len(blocks), ledger_cap(blocks)
        words = 3 * K * cap + 4 * K + 1
        if self.host.numel() < words:
            cuda = self.device.type == "cuda"
            words = max(words, 2 * self.host.numel())
            self.host = torch.empty(words, dtype=torch.float32,
                                    pin_memory=cuda)
            self.dev = torch.empty(words, dtype=torch.float32,
                                   device=self.device) if cuda else self.host
            self.words = self.host.numpy()
        starts, ends, sizes, n, ps_v, d, free_v, head = staged_views(
            self.words, K, cap, np.int32)
        starts.fill(BIG)
        ends.fill(BIG)
        sizes.fill(0.0)
        for k, row in enumerate(blocks):
            m = n[k] = len(row)
            if m:
                se = np.fromiter(chain.from_iterable(row), np.float64,
                                 2 * m).reshape(m, 2)
                starts[k, :m] = se[:, 0]
                ends[k, :m] = se[:, 1]
                sizes[k, :m] = se[:, 1] - se[:, 0]
        head.fill(0)
        ps_v[:] = ps
        free_v[:] = cpu_free
        d[0] = deadline
        return K, cap

    def to_device(self, K: int, cap: int):
        """The packed inputs on the device, as views for
        ``ops.fleet_feasibility``: one ``non_blocking`` copy from the
        pinned buffer (none on the CPU).  The copy is ordered before the
        next :meth:`pack` rewrites the host buffer by the blocking read of
        each decision's verdicts, which waits for the copy and the launch
        on the same stream."""
        words = 3 * K * cap + 4 * K + 1
        if self.dev is not self.host:
            self.dev[:words].copy_(self.host[:words], non_blocking=True)
        return staged_views(self.dev, K, cap)


def ledger_rows(nodes, cand_ids: Sequence[int], arrivals: Sequence[float]):
    """Each candidate's scheduled ``(start, end)`` blocks and CPU free time
    at the request's arrival there: ``(blocks, cpu_free)``."""
    blocks, frees = [], []
    for i, arr in zip(cand_ids, arrivals):
        node = nodes[i]
        free = node.cpu_free_time(arr) if hasattr(node, "cpu_free_time") \
            else arr
        frees.append(free)
        blocks.append(node.queue.scheduled_blocks(free)
                      if hasattr(node.queue, "scheduled_blocks") else [])
    return blocks, frees


def _score_feasible(nodes, cand_ids: Sequence[int], ps: Sequence[float],
                    deadline: float, arrivals: Sequence[float],
                    staging: FeasibilityStaging) -> List[bool]:
    """One admission-feasibility bit per candidate (``ps`` holds the
    request's speed-scaled processing time, ``arrivals`` its per-candidate
    arrival time — they differ under a network model), via one call of
    :func:`repro_torch.kernels.ops.fleet_feasibility` on ``staging``'s
    device."""
    blocks, frees = ledger_rows(nodes, cand_ids, arrivals)
    K, cap = staging.pack(blocks, ps, frees, deadline)
    feasible, _ = ops.fleet_feasibility(*staging.to_device(K, cap))
    return feasible.tolist()


def _host_feasible(blocks: Sequence[Tuple[float, float]], p: float, d: float,
                   cpu_free: float) -> bool:
    """Pure-python mirror of the ledger test (gap search + cumulative-slack
    feasibility) that :func:`repro_torch.kernels.ops.fleet_feasibility`
    runs per row."""
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
