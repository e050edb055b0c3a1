"""Deadline-aware vision serving engine — the paper's orchestration plane
driving a real PyTorch data plane (the port of ``repro/serving/engine.py``).

Mapping (DESIGN.md §3):

* MEC node          -> :class:`ServingReplica` (one model replica; on a pod,
                       one model-parallel group)
* request           -> an inference call with an SLA deadline; its service
                       class comes from the input resolution (Table I:
                       4K/FullHD/HD -> S1/S2/S3-style classes)
* node CPU timeline -> replica device-time ledger; proc_time comes from a
                       measured per-(service, batch) step-time model
* queue             -> FIFO (SFA baseline) or the preferential block queue
* forwarding        -> re-route to another replica (max M, then forced)

Beyond the paper: **deadline-aware batching** — the executor pops a *run*
of queue-head requests of the same service class (up to ``max_batch``) and
executes them as one device batch; the ledger treats the run like one block
per request, so admission guarantees survive (batching only ever finishes
requests earlier than their scheduled ends, never later, because batched
throughput >= sequential throughput for the same work — enforced by using
the measured batched step time as the per-request proc_time upper bound).

The engine is host Python, as in the reference, with the same seeding
(``random.Random(f"serving-fwd:{seed}")`` for the router,
``np.random.default_rng(seed)`` for origins), so both packages make the
same decisions on the same stream.  The data plane is whatever
``run_batch`` the replicas are given (``repro_torch.launch.serve`` builds
one over :mod:`repro_torch.models.vit` or :mod:`repro_torch.models.resnet`,
replaying CUDA graphs on the card); the router's
``batched_feasible`` scoring runs on the engine's ``device``.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.block_queue import FastPreferentialQueue
from repro_torch.core.node import QueueLike
from repro_torch.core.request import Request, Service
from repro_torch.device import DeviceLike
from repro_torch.orchestration.orchestrator import place
from repro_torch.orchestration.router import Router
from repro_torch.orchestration.topology import Topology


@dataclasses.dataclass
class ServiceClass:
    """One resolution class backed by a measured step-time model."""
    name: str
    resolution: int
    deadline: float                   # relative SLA deadline (engine time)
    proc_time: float                  # worst-case per-request time
    batch_proc_time: Dict[int, float] = dataclasses.field(default_factory=dict)

    def service(self) -> Service:
        return Service(self.name, pixels=self.resolution ** 2,
                       environment="serving", proc_time=self.proc_time,
                       deadline=self.deadline)


@dataclasses.dataclass
class ServeRequest:
    payload: Any                       # e.g. image array
    cls: ServiceClass
    arrival: float
    rid: int
    forwards: int = 0
    done_at: Optional[float] = None
    result: Any = None

    @property
    def deadline(self) -> float:
        return self.arrival + self.cls.deadline

    @property
    def proc_time(self) -> float:
        """Worst-case per-request time (router feasibility scoring reads it)."""
        return self.cls.proc_time


class ServingReplica:
    """One model replica with a deadline-aware admission queue.

    ``speed`` is the replica's :class:`~repro_torch.orchestration.
    topology.Topology` speed factor: a ``speed = s`` replica admits *and
    executes* every request ``s``-times faster, so the router's
    speed-scaled feasibility scoring (``Router._batched_feasible``) and
    the data plane agree.
    :class:`DeadlineAwareEngine` overwrites it from an explicitly
    provided topology (then the source of truth for per-node speeds);
    with the defaulted full mesh the replica's own ``speed`` stands.
    """

    def __init__(self, replica_id: int, run_batch: Callable[[str, List[Any]], Any],
                 queue: Optional[QueueLike] = None, max_batch: int = 8,
                 speed: float = 1.0):
        if speed <= 0:
            raise ValueError(f"speed must be positive, got {speed}")
        self.replica_id = replica_id
        self.run_batch = run_batch
        self.queue = queue if queue is not None else FastPreferentialQueue()
        self.max_batch = max_batch
        self.speed = float(speed)
        self.busy_until = 0.0
        self._by_rid: Dict[int, ServeRequest] = {}
        self._scaled_services: Dict[tuple, Service] = {}
        self.stats = {"admitted": 0, "rejected": 0, "forced": 0,
                      "met": 0, "missed": 0, "batches": 0}

    def cpu_free_time(self, now: float) -> float:
        return max(now, self.busy_until)

    def _scaled_service(self, cls: ServiceClass) -> Service:
        """The request's admission-ledger service, proc scaled by speed
        (deadline untouched — SLAs don't move with hardware)."""
        svc = cls.service()
        if self.speed == 1.0:
            return svc
        key = (svc.name, svc.proc_time, svc.deadline, self.speed)
        scaled = self._scaled_services.get(key)
        if scaled is None:
            scaled = dataclasses.replace(svc,
                                         proc_time=svc.proc_time / self.speed)
            self._scaled_services[key] = scaled
        return scaled

    def try_admit(self, req: ServeRequest, now: float, forced: bool) -> bool:
        core_req = Request(service=self._scaled_service(req.cls),
                           arrival_time=req.arrival,
                           origin_node=self.replica_id, rid=req.rid,
                           forwards=req.forwards)
        ok = self.queue.push(core_req, self.cpu_free_time(now), forced=forced)
        if ok:
            self._by_rid[req.rid] = req
            self.stats["admitted"] += 1
            if forced:
                self.stats["forced"] += 1
        else:
            self.stats["rejected"] += 1
        return ok

    def next_run_time(self) -> float:
        """Earliest time the next run could start (inf if queue empty)."""
        head = self.queue.peek() if hasattr(self.queue, "peek") else None
        if head is None:
            return float("inf") if len(self.queue) == 0 else self.busy_until
        return max(self.busy_until, head.arrival_time)

    def _pop_run(self, start: float) -> List[ServeRequest]:
        """Pop up to max_batch queue-head requests of one service class that
        have arrived by ``start``."""
        run: List[ServeRequest] = []
        head_cls = None
        while len(run) < self.max_batch:
            nxt = self.queue.peek() if hasattr(self.queue, "peek") else None
            if nxt is None and len(self.queue) == 0:
                break
            if nxt is not None:
                if nxt.arrival_time > start + 1e-9:
                    break
                cls_name = nxt.service.name
                if head_cls is not None and cls_name != head_cls:
                    break
                head_cls = cls_name
            popped = self.queue.pop()
            if popped is None:
                break
            run.append(self._by_rid.pop(popped.rid))
            if nxt is None:
                break                      # queue without peek: batch of 1
        return run

    def step(self, now: float) -> Tuple[float, List[ServeRequest]]:
        """Execute one batched run work-conservingly starting at ``now``
        (requires now >= next_run_time). Returns (t_done, requests)."""
        if now < self.busy_until or len(self.queue) == 0:
            return self.busy_until, []
        run = self._pop_run(now)
        if not run:
            return self.busy_until, []
        cls = run[0].cls
        b = len(run)
        # the measured step-time model is for a reference (speed-1) replica;
        # this replica executes speed× faster — matching the scaled ledger
        # blocks admission committed to, so admission guarantees survive
        t_batch = cls.batch_proc_time.get(b, cls.proc_time * b) / self.speed
        outs = self.run_batch(cls.name, [r.payload for r in run])
        self.stats["batches"] += 1
        done = now + t_batch
        self.busy_until = done
        for r, o in zip(run, outs):
            r.done_at = done
            r.result = o
            if done <= r.deadline + 1e-9:
                self.stats["met"] += 1
            else:
                self.stats["missed"] += 1
        return done, run


class DeadlineAwareEngine:
    """Multi-replica orchestrator: admission + sequential forwarding.

    Forwarding is NOT re-implemented here — target selection and the
    admit/forward/force loop come from the orchestration core
    (:class:`repro_torch.orchestration.Router` +
    :func:`repro_torch.orchestration.place`), so the engine honors any
    topology (e.g. ``Topology.two_tier`` with a fast cloud replica group)
    and any router policy, including ``batched_feasible`` device-side
    scoring on ``device`` (``None`` means CUDA and raises without it;
    ``"cpu"`` scores on the CPU).
    """

    def __init__(self, replicas: Sequence[ServingReplica], max_forwards: int = 2,
                 rng_seed: int = 0, topology: Optional[Topology] = None,
                 forward_policy: str = "random", device: DeviceLike = None):
        self.replicas = list(replicas)
        for idx, rep in enumerate(self.replicas):
            if rep.replica_id != idx:
                raise ValueError("replicas must be indexed by replica_id "
                                 f"(got id {rep.replica_id} at position {idx})")
        self.max_forwards = max_forwards
        explicit_topology = topology is not None
        self.topology = topology if explicit_topology \
            else Topology.full_mesh(len(self.replicas))
        if self.topology.n_nodes != len(self.replicas):
            raise ValueError(f"topology has {self.topology.n_nodes} nodes "
                             f"for {len(self.replicas)} replicas")
        # a provided topology is the source of truth for per-node speeds:
        # the data plane must execute at the same rate the router scores
        # and the admission ledger commits to (ROADMAP speed-scaling fix).
        # Without one, the replicas' own speeds stand — the defaulted
        # full mesh must not clobber an explicit ServingReplica(speed=...)
        if explicit_topology:
            for idx, rep in enumerate(self.replicas):
                rep.speed = self.topology.speed(idx)
        self.router = Router(self.topology, forward_policy,
                             rng=random.Random(f"serving-fwd:{rng_seed}"),
                             device=device)
        self._rng = np.random.default_rng(rng_seed)
        self._next_rid = 0
        self.forwards = 0

    def submit(self, payload: Any, cls: ServiceClass, now: float,
               origin: Optional[int] = None) -> ServeRequest:
        self.advance(now)      # execute everything that starts before `now`
        req = ServeRequest(payload=payload, cls=cls, arrival=now,
                           rid=self._next_rid)
        self._next_rid += 1
        if origin is None:
            origin = int(self._rng.integers(len(self.replicas)))
        place(req, origin, self.replicas, self.router, now=now,
              max_forwards=self.max_forwards,
              admit=lambda rep, r, t, forced: rep.try_admit(r, t, forced=forced),
              on_forward=self._on_forward)
        return req

    def _on_forward(self, req: ServeRequest, src: ServingReplica,
                    dst: ServingReplica, now: float) -> None:
        self.forwards += 1

    def advance(self, now: float) -> None:
        """Event-driven execution: run every replica's pending runs whose
        start time is strictly before ``now`` (earliest-first for
        deterministic cross-replica ordering)."""
        while True:
            t_next, rep_next = min(
                ((r.next_run_time(), r) for r in self.replicas),
                key=lambda x: x[0])
            if t_next >= now or t_next == float("inf"):
                return
            rep_next.step(t_next)

    def drain(self, now: float) -> float:
        """Run every replica until all queues are empty. Returns end time."""
        self.advance(float("inf"))
        busy = [r.busy_until for r in self.replicas]
        return max([now] + busy)

    def stats(self) -> Dict[str, int]:
        agg: Dict[str, int] = {"forwards": self.forwards}
        for rep in self.replicas:
            for k, v in rep.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg


def measure_step_times(run_batch: Callable[[str, List[Any]], Any],
                       cls: ServiceClass, payload: Any,
                       batches=(1, 2, 4, 8), warmup: int = 1) -> None:
    """Fill cls.batch_proc_time with wall-clock measurements (and set
    proc_time to the measured batch-1 worst case).  ``run_batch`` must
    return host values (as ``launch.serve``'s does), so that the wall
    clock covers the device's work.  On CUDA, ``launch.serve``'s
    ``run_batch`` replays a CUDA graph per batch shape, so these are the
    times of graph replays (the warm-up call captures a new shape's
    graph); its ``graphed=False`` form times the eager step."""
    for b in batches:
        payloads = [payload] * b
        for _ in range(warmup):
            run_batch(cls.name, payloads)
        t0 = time.perf_counter()
        run_batch(cls.name, payloads)
        dt = time.perf_counter() - t0
        cls.batch_proc_time[b] = dt
    cls.proc_time = max(cls.proc_time, cls.batch_proc_time.get(1, 0.0))
