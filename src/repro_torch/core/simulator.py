"""MEC-LB Simulator — the paper-config adapter over the orchestration core
(the port's copy of ``repro/core/simulator.py``).

Faithful behaviors (implemented once, in
:class:`repro_torch.orchestration.Orchestrator`; this module maps the
paper's experiment space onto that core and is held to
tests/golden_simulator.json, the reference's pinned Table II grid):

* users send requests to their nearest MEC node (``Request.origin_node``);
* admission is decided by the node's queue discipline (FIFO = SFA v1
  baseline, preferential = the paper's contribution);
* on rejection the request is forwarded to a randomly chosen neighbor
  (``max_forwards`` = 2 in all paper experiments); network/scheduling delays
  are neglected (``forward_delay`` = 0), as in the paper;
* a request that has exhausted its forwards is force-pushed and processed
  even if late (the paper uses the non-discarding SFA variant); the
  Beraldi [9] discard variant is available via ``discard_on_exhaust``;
* every service always takes its worst-case processing time;
* the cluster is a homogeneous full mesh (``Topology.full_mesh``) — use the
  orchestration API directly for rings, stars, two-tier or heterogeneous
  clusters (DESIGN.md §4 has the migration table).

The simulator is deterministic given (scenario, seed): arrival lists are
regenerated from the seed for every policy so all disciplines see an
identical workload, while forwarding randomness uses an independent stream.

    PYTHONPATH=src python -m repro_torch.core.simulator --scenario 1 \
        --queues fifo preferential edf --seeds 2 --device cpu

``device`` is the router's (``None`` means CUDA and raises without it);
only ``forward_policy="batched_feasible"`` computes anything there.
"""
from __future__ import annotations

import dataclasses
import random
import statistics
from typing import List, Optional, Sequence

from repro_torch.core.block_queue import (FastPreferentialQueue,
                                          PreferentialQueue)
from repro_torch.core.node import QueueLike
from repro_torch.core.queues import EDFQueue, FIFOQueue
from repro_torch.core.request import Request
from repro_torch.core.scenarios import (DEFAULT_ARRIVAL_WINDOW, SCENARIOS,
                                        generate_requests)
from repro_torch.device import DeviceLike
from repro_torch.orchestration.orchestrator import Orchestrator
from repro_torch.orchestration.router import Router
from repro_torch.orchestration.topology import Topology


def make_queue(kind: str) -> QueueLike:
    if kind == "fifo":
        return FIFOQueue()
    if kind == "preferential":
        return FastPreferentialQueue()
    if kind == "preferential_faithful":
        return PreferentialQueue()
    if kind == "preferential_compact":
        # literal Alg.2 pseudo-code reading of the forced push (ablation)
        return FastPreferentialQueue(forced_compaction=True)
    if kind == "edf":
        return EDFQueue()
    raise ValueError(f"unknown queue kind {kind!r}")


@dataclasses.dataclass
class SimConfig:
    scenario: int = 1
    queue: str = "fifo"                  # fifo | preferential | preferential_faithful | edf
    forward_policy: str = "random"       # random | power_of_two | least_loaded | round_robin
    max_forwards: int = 2                # paper: M = 2
    forward_delay: float = 0.0           # paper neglects network delay
    discard_on_exhaust: bool = False     # Beraldi [9] variant
    arrival_window: float = DEFAULT_ARRIVAL_WINDOW
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    config: SimConfig
    total_requests: int
    processed: int
    met_deadline: int
    forwards: int
    discarded: int
    mean_response_time: float
    per_node_forwards: List[int]

    @property
    def met_rate(self) -> float:
        return self.met_deadline / max(1, self.total_requests)

    @property
    def forward_rate(self) -> float:
        """Fraction of the maximum possible referrals (paper Fig. 6)."""
        return self.forwards / max(1, self.total_requests * self.config.max_forwards)


def run_simulation(config: SimConfig,
                   requests: Optional[Sequence[Request]] = None,
                   device: DeviceLike = None) -> SimResult:
    """Run one seeded simulation and return aggregate metrics.

    Thin adapter: builds the paper's homogeneous full mesh and delegates the
    event loop to :class:`repro_torch.orchestration.Orchestrator`.
    """
    topology = Topology.full_mesh(len(SCENARIOS[config.scenario]))
    # str seeds hash via sha512 inside random.Random, so the forwarding
    # stream is stable across processes (tuple.__hash__ of a str-bearing
    # tuple is NOT — it varies with PYTHONHASHSEED).
    fwd_rng = random.Random(f"forwarding:{config.seed}")
    router = Router(topology, config.forward_policy, rng=fwd_rng,
                    device=device)
    orch = Orchestrator(topology, lambda: make_queue(config.queue), router,
                        max_forwards=config.max_forwards,
                        forward_delay=config.forward_delay,
                        discard_on_exhaust=config.discard_on_exhaust)

    if requests is None:
        requests = generate_requests(config.scenario, config.seed,
                                     config.arrival_window)
    res = orch.run(requests)
    return SimResult(
        config=config,
        total_requests=res.total_requests,
        processed=res.processed,
        met_deadline=res.met_deadline,
        forwards=res.forwards,
        discarded=res.discarded,
        mean_response_time=res.mean_response_time,
        per_node_forwards=[m.forwards_out for m in res.per_node],
    )


@dataclasses.dataclass
class AggregateResult:
    met_rate_mean: float
    met_rate_stdev: float
    forward_rate_mean: float
    forward_rate_stdev: float
    mean_response_time: float
    n_seeds: int


def run_experiment(scenario: int, queue: str, *, n_seeds: int = 40,
                   forward_policy: str = "random",
                   arrival_window: float = DEFAULT_ARRIVAL_WINDOW,
                   max_forwards: int = 2,
                   discard_on_exhaust: bool = False,
                   base_seed: int = 0,
                   device: DeviceLike = None) -> AggregateResult:
    """Average of ``n_seeds`` simulations — the paper runs 40 per scenario."""
    met, fwd, resp = [], [], []
    for s in range(n_seeds):
        cfg = SimConfig(scenario=scenario, queue=queue,
                        forward_policy=forward_policy,
                        arrival_window=arrival_window,
                        max_forwards=max_forwards,
                        discard_on_exhaust=discard_on_exhaust,
                        seed=base_seed + s)
        res = run_simulation(cfg, device=device)
        met.append(res.met_rate)
        fwd.append(res.forward_rate)
        resp.append(res.mean_response_time)
    return AggregateResult(
        met_rate_mean=statistics.fmean(met),
        met_rate_stdev=statistics.stdev(met) if len(met) > 1 else 0.0,
        forward_rate_mean=statistics.fmean(fwd),
        forward_rate_stdev=statistics.stdev(fwd) if len(fwd) > 1 else 0.0,
        mean_response_time=statistics.fmean(resp),
        n_seeds=n_seeds,
    )


def main() -> List[SimResult]:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--queues", nargs="*",
                    default=["fifo", "preferential", "edf"])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--policy", default="random")
    ap.add_argument("--device", default=None,
                    help="the router's device (default CUDA; 'cpu' runs "
                         "without a GPU)")
    args = ap.parse_args()
    out = []
    for sc in args.scenario:
        for queue in args.queues:
            for seed in range(args.seeds):
                res = run_simulation(
                    SimConfig(scenario=sc, queue=queue,
                              forward_policy=args.policy, seed=seed),
                    device=args.device)
                out.append(res)
                print(f"scenario {sc} {queue:13s} seed {seed}: met "
                      f"{res.met_deadline}/{res.total_requests} "
                      f"({100 * res.met_rate:.2f}%), forwards "
                      f"{res.forwards} ({100 * res.forward_rate:.2f}%), "
                      f"mean response {res.mean_response_time:.3f} UT",
                      flush=True)
    return out


if __name__ == "__main__":
    main()
