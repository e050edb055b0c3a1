"""Arrival processes + the scenario registry (the port's copy of the parts
of ``repro/orchestration/workload.py`` the fleet simulator's main path
needs: :class:`UniformWorkload` and the ``paper/scenario{1,2,3}``
registry).

Both packages must hand the simulator identical request arrays, so the
seeding is copied bit for bit: the paper scenarios seed Python's
``random`` from the int tuple ``(scenario, seed, round(window))`` (its
hash is process-stable), every other workload from a string (hashed with
sha512 by ``random.Random``).
"""
from __future__ import annotations

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
