"""Experiment scenarios — Tables I and II of the paper (the port's copy of
``repro/core/scenarios.py``).

Scenarios 1-2 have 3 MEC nodes; scenario 3 adds 3 lightly-loaded nodes.
Request counts are per (node, service) exactly as published; arrival
times are i.i.d. uniform over ``DEFAULT_ARRIVAL_WINDOW``.
"""
from __future__ import annotations

import random
from typing import Dict, List

from repro_torch.core.request import Request, SERVICES, SERVICE_ORDER

# Table II. counts[node_index][service_name]
SCENARIOS: Dict[int, List[Dict[str, int]]] = {
    1: [
        {"S1": 500, "S2": 300, "S3": 200, "S4": 500, "S5": 300, "S6": 200},
        {"S1": 200, "S2": 300, "S3": 500, "S4": 200, "S5": 300, "S6": 500},
        {"S1": 300, "S2": 500, "S3": 200, "S4": 300, "S5": 500, "S6": 200},
    ],
    2: [
        {"S1": 250, "S2": 300, "S3": 700, "S4": 250, "S5": 300, "S6": 700},
        {"S1": 100, "S2": 300, "S3": 1000, "S4": 100, "S5": 300, "S6": 1000},
        {"S1": 150, "S2": 500, "S3": 700, "S4": 150, "S5": 500, "S6": 700},
    ],
    3: [
        {"S1": 250, "S2": 300, "S3": 700, "S4": 250, "S5": 300, "S6": 700},
        {"S1": 100, "S2": 300, "S3": 1000, "S4": 100, "S5": 300, "S6": 1000},
        {"S1": 150, "S2": 500, "S3": 700, "S4": 150, "S5": 500, "S6": 700},
        {"S1": 100, "S2": 100, "S3": 100, "S4": 100, "S5": 100, "S6": 100},
        {"S1": 100, "S2": 100, "S3": 100, "S4": 100, "S5": 100, "S6": 100},
        {"S1": 100, "S2": 100, "S3": 100, "S4": 100, "S5": 100, "S6": 100},
    ],
}

# Paper totals used for the Fig. 5/6 percentages.
TOTAL_REQUESTS = {1: 6000, 2: 8000, 3: 9800}

# Calibrated so scenario 1 sits in the paper's "<20% met" overload regime
# (EXPERIMENTS.md §Paper-reproduction).
DEFAULT_ARRIVAL_WINDOW = 110_000.0


def total_requests(scenario: int) -> int:
    return sum(sum(c.values()) for c in SCENARIOS[scenario])


def generate_requests(scenario: int, seed: int,
                      arrival_window: float = DEFAULT_ARRIVAL_WINDOW
                      ) -> List[Request]:
    """Deterministic request list for one simulation seed.

    The same (scenario, seed, window) always yields identical arrival times
    and service mix, so different queue disciplines are compared on an
    identical workload — the paper's "a copy of the requisition list
    simulates each load distribution approach".
    """
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario}; options {sorted(SCENARIOS)}")
    rng = random.Random((scenario, seed, round(arrival_window)).__hash__())
    requests: List[Request] = []
    for node_idx, counts in enumerate(SCENARIOS[scenario]):
        for sname in SERVICE_ORDER:
            svc = SERVICES[sname]
            for _ in range(counts.get(sname, 0)):
                requests.append(Request(
                    service=svc,
                    arrival_time=rng.uniform(0.0, arrival_window),
                    origin_node=node_idx,
                ))
    requests.sort(key=lambda r: (r.arrival_time, r.rid))
    return requests
