"""Experiment scenarios — Tables I and II of the paper (the port's copy of
``repro/core/scenarios.py``).

Scenarios 1-2 have 3 MEC nodes; scenario 3 adds 3 lightly-loaded nodes.
Request counts are per (node, service) exactly as published; arrival
times are i.i.d. uniform over ``DEFAULT_ARRIVAL_WINDOW``.
"""
from __future__ import annotations

from typing import Dict, List

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
