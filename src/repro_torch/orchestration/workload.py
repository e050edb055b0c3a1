"""Arrival processes + the scenario registry (the port's copy of
``repro/orchestration/workload.py``).

* :class:`UniformWorkload` — the paper's process (per-(node, service)
  counts, uniform arrivals over a window);
* :class:`PoissonWorkload` — per-(node, service) Poisson streams over a
  horizon;
* :class:`DiurnalWorkload` — the counts under a sinusoidal intensity
  (thinning): daily peaks, bursts;
* :class:`TraceWorkload` — replay of a JSONL trace (``{"service": "S1",
  "arrival_time": 12.5, "node": 0}`` a line), which :func:`dump_trace`
  writes.

Both packages must hand the simulator identical request arrays, so the
seeding and the order of the draws are copied bit for bit: the paper
scenarios seed Python's ``random`` from the int tuple ``(scenario, seed,
round(window))`` (its hash is process-stable), every other workload from
a string (hashed with sha512 by ``random.Random``).
"""
from __future__ import annotations

import json
import math
import random
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.request import Request, SERVICES, SERVICE_ORDER, Service
from repro_torch.core.scenarios import DEFAULT_ARRIVAL_WINDOW, SCENARIOS


class Workload:
    """Deterministic seed -> request-list generator."""

    name: str = "workload"
    n_nodes: int = 1

    def generate(self, seed: int) -> List[Request]:
        raise NotImplementedError

    def total_requests(self, seed: int = 0) -> int:
        return len(self.generate(seed))

    def to_arrays(self, seed: int = 0, payload_fn=None):
        """``generate(seed)`` packed into the fleet simulator's numpy
        arrays: ``(RequestArrays, service name table)``."""
        from repro_torch.fleetsim.arrays import pack_requests
        arrays, names, _ = pack_requests(self.generate(seed),
                                         payload_fn=payload_fn)
        return arrays, names

    @staticmethod
    def _finish(requests: List[Request]) -> List[Request]:
        requests.sort(key=lambda r: (r.arrival_time, r.rid))
        return requests


class UniformWorkload(Workload):
    """The paper's arrival process: fixed per-(node, service) counts with
    i.i.d. uniform arrival times over ``[0, window]``.  An int
    ``seed_key`` reproduces the paper scenarios' stream."""

    def __init__(self, counts: Sequence[Dict[str, int]],
                 window: float = DEFAULT_ARRIVAL_WINDOW,
                 services: Optional[Dict[str, Service]] = None,
                 name: str = "uniform", seed_key=None):
        self.counts = [dict(c) for c in counts]
        self.window = float(window)
        self.services = dict(services or SERVICES)
        self.name = name
        self.n_nodes = len(self.counts)
        self._seed_key = seed_key if seed_key is not None else name

    def _service_order(self) -> Sequence[str]:
        if all(s in self.services for s in SERVICE_ORDER) and \
                len(self.services) == len(SERVICE_ORDER):
            return SERVICE_ORDER
        return sorted(self.services)

    def generate(self, seed: int) -> List[Request]:
        if isinstance(self._seed_key, int):
            # int-tuple hash: the paper scenarios' process-stable stream
            rng = random.Random(
                (self._seed_key, seed, round(self.window)).__hash__())
        else:
            rng = random.Random(
                f"uniform:{self._seed_key}:{seed}:{round(self.window)}")
        requests: List[Request] = []
        for node_idx, counts in enumerate(self.counts):
            for sname in self._service_order():
                svc = self.services[sname]
                for _ in range(counts.get(sname, 0)):
                    requests.append(Request(
                        service=svc,
                        arrival_time=rng.uniform(0.0, self.window),
                        origin_node=node_idx,
                    ))
        return self._finish(requests)


class PoissonWorkload(Workload):
    """Independent Poisson streams per (node, service) over ``[0,
    horizon]``; ``rates[node][service]`` in requests per unit time.
    :meth:`from_counts` matches a count table's expected volume."""

    def __init__(self, rates: Sequence[Dict[str, float]], horizon: float,
                 services: Optional[Dict[str, Service]] = None,
                 name: str = "poisson"):
        self.rates = [dict(r) for r in rates]
        self.horizon = float(horizon)
        self.services = dict(services or SERVICES)
        self.name = name
        self.n_nodes = len(self.rates)

    @classmethod
    def from_counts(cls, counts: Sequence[Dict[str, int]], horizon: float,
                    services: Optional[Dict[str, Service]] = None,
                    name: str = "poisson") -> "PoissonWorkload":
        rates = [{s: c / horizon for s, c in node.items()} for node in counts]
        return cls(rates, horizon, services=services, name=name)

    def generate(self, seed: int) -> List[Request]:
        rng = random.Random(
            f"poisson:{self.name}:{seed}:{round(self.horizon)}")
        requests: List[Request] = []
        for node_idx, rates in enumerate(self.rates):
            for sname in sorted(rates):
                rate = rates[sname]
                if rate <= 0:
                    continue
                svc = self.services[sname]
                t = rng.expovariate(rate)
                while t <= self.horizon:
                    requests.append(Request(service=svc, arrival_time=t,
                                            origin_node=node_idx))
                    t += rng.expovariate(rate)
        return self._finish(requests)


class DiurnalWorkload(Workload):
    """Fixed counts with arrivals drawn by thinning from the intensity
    ``1 + amplitude * sin(2 pi peaks t / window)`` over ``[0, window]``;
    ``amplitude=0`` is uniform."""

    def __init__(self, counts: Sequence[Dict[str, int]],
                 window: float = DEFAULT_ARRIVAL_WINDOW,
                 peaks: int = 2, amplitude: float = 0.8,
                 services: Optional[Dict[str, Service]] = None,
                 name: str = "diurnal"):
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
        self.counts = [dict(c) for c in counts]
        self.window = float(window)
        self.peaks = peaks
        self.amplitude = amplitude
        self.services = dict(services or SERVICES)
        self.name = name
        self.n_nodes = len(self.counts)

    def _sample_arrival(self, rng: random.Random) -> float:
        lam_max = 1.0 + self.amplitude
        while True:
            t = rng.uniform(0.0, self.window)
            lam = 1.0 + self.amplitude * math.sin(
                2.0 * math.pi * self.peaks * t / self.window)
            if rng.random() * lam_max <= lam:
                return t

    def generate(self, seed: int) -> List[Request]:
        rng = random.Random(
            f"diurnal:{self.name}:{seed}:{self.peaks}:{round(self.window)}")
        requests: List[Request] = []
        for node_idx, counts in enumerate(self.counts):
            for sname in sorted(counts):
                svc = self.services[sname]
                for _ in range(counts[sname]):
                    requests.append(Request(
                        service=svc,
                        arrival_time=self._sample_arrival(rng),
                        origin_node=node_idx,
                    ))
        return self._finish(requests)


class TraceWorkload(Workload):
    """Replay of a JSONL trace (the seed is ignored).  Unknown service
    names raise at load."""

    def __init__(self, path: str,
                 services: Optional[Dict[str, Service]] = None,
                 name: Optional[str] = None):
        self.path = path
        self.services = dict(services or SERVICES)
        self.name = name or f"trace:{path}"
        self._records: List[Dict] = []
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec["service"] not in self.services:
                    raise ValueError(
                        f"{path}:{lineno}: unknown service {rec['service']!r}")
                self._records.append(rec)
        self.n_nodes = 1 + max((r["node"] for r in self._records), default=0)

    def generate(self, seed: int = 0) -> List[Request]:
        requests = [Request(service=self.services[r["service"]],
                            arrival_time=float(r["arrival_time"]),
                            origin_node=int(r["node"]))
                    for r in self._records]
        return self._finish(requests)


def dump_trace(requests: Sequence[Request], path: str) -> None:
    """Write a request list as a JSONL trace :class:`TraceWorkload`
    reads."""
    with open(path, "w") as f:
        for r in requests:
            f.write(json.dumps({"service": r.service.name,
                                "arrival_time": r.arrival_time,
                                "node": r.origin_node}) + "\n")


def fleet_workload(n_nodes: int, div: int = 4) -> UniformWorkload:
    """Scenario-1 node mixes tiled over ``n_nodes``, window scaled by
    ``div`` so every node sees the paper's overload intensity with 1/div
    volume — the fleet regime of ``benchmarks/fleetsim_bench.py``
    (``make_fleet_workload``; same name string, so the same stream)."""
    counts = [{s: max(1, c // div) for s, c in SCENARIOS[1][i % 3].items()}
              for i in range(n_nodes)]
    return UniformWorkload(counts, window=DEFAULT_ARRIVAL_WINDOW / div,
                           name=f"fleet{n_nodes}_div{div}")


# ---------------------------------------------------------------------------
# scenario registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], Workload]] = {}


def register_workload(name: str, factory: Callable[[], Workload],
                      overwrite: bool = False) -> None:
    """Register a zero-arg workload factory under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"workload {name!r} already registered")
    _REGISTRY[name] = factory


def get_workload(name: str) -> Workload:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown workload {name!r}; "
                         f"options: {available_workloads()}") from None


def available_workloads() -> List[str]:
    return sorted(_REGISTRY)


for _s, _counts in SCENARIOS.items():
    register_workload(
        f"paper/scenario{_s}",
        (lambda counts=_counts, s=_s: UniformWorkload(
            counts, window=DEFAULT_ARRIVAL_WINDOW,
            name=f"paper/scenario{s}", seed_key=s)))
