"""Cross-validation: fleetsim vs the event-heap Orchestrator (the port's
copy of ``repro/fleetsim/validate.py``).

The contract (DESIGN.md §5, §7): on identical workloads — under **any**
link pricing, zero or priced — the event-time fleet simulator reproduces
the event heap's per-request ``(outcome, serving node, transfer time)``

* **exactly** for deterministic forwarding policies (``round_robin``,
  ``batched_feasible``), and
* **exactly under trace replay** for the stochastic ones — the host run
  records every forwarding choice through ``Hooks.on_forward`` and
  fleetsim replays it (``policy="trace"``), so any dynamics divergence
  (admission, timing, tie-breaking, event ordering) still surfaces as an
  outcome mismatch while the Mersenne-vs-threefry rng stream difference
  is factored out,

modulo float32-boundary flips: the host queue schedules in float64, the
device ledger in float32, so a request whose feasibility / deadline margin
is below f32 resolution (~1e-2 at the paper's 1e5-UT timescale) can land
on the other side of the test — and under a priced network two re-arrival
events closer together than f32 resolution can swap order.  Empirically
neither has produced a mismatch (see EXPERIMENTS.md §Netsim);
``run_validation`` reports exact counts and the per-request mismatch list
so the tolerance is measured, not assumed.

``device`` (``--device``) is where both engines compute: the fleet side
is one ``event_scan`` launch a run on CUDA (``None`` means CUDA and
raises without it) and the eager per-event loop on the CPU; the heap's
router scores ``batched_feasible`` there too.  ``telemetry=`` /
``--telemetry`` extends the contract from outcomes to dynamics
(DESIGN.md §8): the heap's trace and the fleet's telemetry cube must
agree bucket for bucket.

    PYTHONPATH=src python -m repro_torch.fleetsim.validate   # 3 scenarios, CUDA
    PYTHONPATH=src python -m repro_torch.fleetsim.validate --device cpu
    PYTHONPATH=src python -m repro_torch.fleetsim.validate --policy round_robin
    PYTHONPATH=src python -m repro_torch.fleetsim.validate --net campus
    PYTHONPATH=src python -m repro_torch.fleetsim.validate --telemetry --device cpu
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.block_queue import FastPreferentialQueue
from repro_torch.device import DeviceLike
from repro_torch.fleetsim import core as fcore
from repro_torch.fleetsim.arrays import pack_requests, topology_arrays
from repro_torch.netsim import LinkModel
from repro_torch.orchestration import (Hooks, Orchestrator, Router, Topology,
                                       Workload, get_workload)
from repro_torch.telemetry import (TelemetryAgreement, TelemetryConfig,
                                   TelemetrySummary, TraceRecorder,
                                   compare_summaries)

# host policies fleetsim replays move-for-move without a trace
DETERMINISTIC = ("round_robin", "batched_feasible")

#: |host - fleet| tolerance on per-request wire time (f32 sums vs f64)
TRANSFER_ATOL = 1e-2


@dataclasses.dataclass
class ValidationReport:
    scenario: str
    seed: int
    policy: str
    total: int
    host: Dict[str, float]
    fleet: Dict[str, float]
    outcome_mismatches: int          # per-request outcome-code disagreements
    node_mismatches: int             # per-request serving-node disagreements
    transfer_max_err: float          # max |per-request wire time| difference
    met_diff_pp: float               # |met-rate difference| in percent points
    capacity: int
    telemetry: Optional[TelemetryAgreement] = None   # --telemetry only

    @property
    def exact(self) -> bool:
        return (self.outcome_mismatches == 0 and self.node_mismatches == 0
                and self.transfer_max_err <= TRANSFER_ATOL
                and (self.telemetry is None or self.telemetry.ok))

    def row(self) -> str:
        tag = "exact" if self.exact else \
            f"{self.outcome_mismatches}o/{self.node_mismatches}n mismatches"
        tel = "" if self.telemetry is None else f"  tel: {self.telemetry.row()}"
        return (f"{self.scenario:18s} seed={self.seed} {self.policy:16s} "
                f"met {self.host['met_deadline']:6.0f}/{self.fleet['met_deadline']:6.0f} "
                f"fwd {self.host['forwards']:6.0f}/{self.fleet['forwards']:6.0f} "
                f"disc {self.host['discarded']:5.0f}/{self.fleet['discarded']:5.0f} "
                f"dmet {self.met_diff_pp:5.3f}pp "
                f"dwire {self.transfer_max_err:7.1e}  [{tag}]{tel}")


def _host_run(workload: Workload, topology: Topology, seed: int,
              policy: str, max_forwards: int, discard_on_exhaust: bool,
              network: Optional[LinkModel] = None,
              device: DeviceLike = None, record_trace: bool = False):
    """Event-heap reference run.

    Returns ``(requests, result, targets, peak, depth, transfer,
    recorder)`` —
    ``targets[dense_idx, hop]`` records every forwarding
    choice in the order the heap consumed it, ``transfer[dense_idx]`` the
    wire time the request paid on referrals, ``peak`` the largest
    per-node admission count (sizes the fleet slot buffer: head-pointer
    rows retire slots without reusing them, so capacity tracks total
    admissions, not peak depth), ``depth`` the deepest queue observed.
    The router runs on ``device``.  With ``record_trace`` the run also
    streams through a :class:`repro_torch.telemetry.TraceRecorder`
    (chained ahead of the local hooks) and returns it; otherwise
    ``recorder`` is None.
    """
    requests = workload.generate(seed)
    idx = {r.rid: j for j, r in enumerate(requests)}
    targets = np.full((len(requests), max(max_forwards, 1)), -1, np.int32)
    transfer = np.zeros((len(requests),), np.float64)
    hops = {}
    depth = 0

    def on_forward(req, src, dst, now):
        h = hops.get(req.rid, 0)
        hops[req.rid] = h + 1
        targets[idx[req.rid], h] = dst.node_id
        if network is not None:
            transfer[idx[req.rid]] += network.transfer_delay(
                src.node_id, dst.node_id, req.service)

    def on_admit(req, node, now, forced):
        nonlocal depth
        depth = max(depth, len(node.queue))

    hooks = Hooks(on_forward=on_forward, on_admit=on_admit)
    recorder = None
    if record_trace:
        recorder = TraceRecorder(network=network, hooks=hooks)
        hooks = recorder.hooks
    orch = Orchestrator(topology, FastPreferentialQueue,
                        Router(topology, policy, seed=seed, device=device),
                        max_forwards=max_forwards,
                        discard_on_exhaust=discard_on_exhaust,
                        network=network,
                        hooks=hooks)
    result = orch.run(requests)
    peak = max(n.admitted for n in result.per_node)
    return requests, result, targets, peak, depth, transfer, recorder


def _host_outcomes(requests, result):
    """Per-request (outcome code, serving node) of the heap run."""
    out = np.full((len(requests),), fcore.DISCARDED, np.int32)
    served = np.full((len(requests),), -1, np.int32)
    idx = {r.rid: j for j, r in enumerate(requests)}
    for r in result.completed:
        out[idx[r.rid]] = fcore.MET if r.met_deadline else fcore.LATE
        served[idx[r.rid]] = r.served_by
    return out, served


def run_validation(scenario: str = "paper/scenario1", seed: int = 0,
                   policy: str = "random", max_forwards: int = 2,
                   discard_on_exhaust: bool = False,
                   topology: Optional[Topology] = None,
                   capacity: Optional[int] = None,
                   network: Optional[LinkModel] = None,
                   telemetry: Optional[int] = None,
                   device: DeviceLike = None) -> ValidationReport:
    """One (scenario, seed, policy) cross-validation cell.

    ``network`` runs BOTH engines under the link model (the host pays
    transfer delays on forward events, fleetsim defers the re-arrival
    event by the same ``(K, K)`` costs).  The exactness contract covers
    priced networks as well as the zero model — the event-time scan
    replays the heap's event interleaving exactly (DESIGN.md §7), so
    outcome, serving node and per-request wire time are all compared.

    ``device`` is where both engines compute (module docstring); on CUDA
    the fleet side is one ``event_scan`` launch, which runs or raises.

    ``telemetry`` (a bucket count) extends the contract from outcomes to
    dynamics (DESIGN.md §8): the host run streams through a
    :class:`~repro_torch.telemetry.TraceRecorder`, a second fleet run
    carries the telemetry cube, and the two time-binned summaries must
    agree bucket for bucket — counters and occupancy exactly, derived
    integrals within ``DERIVED_ATOL``.  The telemetry run is also checked
    bit-identical to the plain run on every shared output.
    """
    workload = get_workload(scenario) if isinstance(scenario, str) \
        else scenario
    name = scenario if isinstance(scenario, str) else workload.name
    if topology is None:
        topology = network.topology if network is not None \
            else Topology.full_mesh(workload.n_nodes)
    if network is not None and network.n_nodes != topology.n_nodes:
        raise ValueError("network and topology disagree on node count")
    requests, result, targets, peak, depth, host_tr, recorder = _host_run(
        workload, topology, seed, policy, max_forwards, discard_on_exhaust,
        network=network, device=device, record_trace=telemetry is not None)

    if capacity is None:
        capacity = 1 << max(3, (peak + 2 - 1).bit_length())
    window = 1 << max(3, (depth + 2 - 1).bit_length())
    # scan length: one step per heap arrival event (fresh + re-arrivals),
    # sized off the host's realized forward count with generous slack —
    # event_overflow is asserted 0 below, so undersizing cannot pass
    max_events = min(len(requests) * (max_forwards + 1),
                     len(requests) + 2 * result.forwards + 256)
    reqs, _, _ = pack_requests(
        requests, payload_fn=network.payload_of if network else None)
    fleet_policy = policy if policy in DETERMINISTIC else "trace"
    fleet_kw = dict(policy=fleet_policy, max_forwards=max_forwards,
                    discard_on_exhaust=discard_on_exhaust,
                    capacity=capacity, depth=window, targets=targets,
                    net=network.net_params() if network else None,
                    max_events=max_events, device=device)
    m = fcore.simulate(reqs, topology_arrays(topology),
                       fcore.SimParams.make(seed), **fleet_kw)
    assert int(m.overflow) == 0 and int(m.window_saturation) == 0, \
        f"fleet capacity {capacity}/depth {window} saturated " \
        f"(host peak admissions {peak}, depth {depth})"
    assert int(m.event_overflow) == 0, \
        f"event plane saturated (max_events {max_events}, " \
        f"host forwards {result.forwards})"

    agreement = None
    if telemetry is not None:
        horizon = float(result.end_time)
        m_tel = fcore.simulate(
            reqs, topology_arrays(topology), fcore.SimParams.make(seed),
            telemetry=TelemetryConfig(telemetry, horizon), **fleet_kw)
        # carrying the cube must not perturb a single output bit
        for fld in ("outcome", "served_by", "completion", "forwards_used",
                    "transfer_used", "met_deadline", "processed",
                    "forwards", "discarded", "overflow",
                    "window_saturation", "event_overflow"):
            if not torch.equal(getattr(m, fld), getattr(m_tel, fld)):
                raise AssertionError(f"the telemetry run perturbed {fld}")
        host_sum = recorder.summary(requests, topology, telemetry, horizon)
        dev_sum = TelemetrySummary.from_frame(m_tel.telemetry)
        agreement = compare_summaries(host_sum, dev_sum)

    host_out, host_served = _host_outcomes(requests, result)
    mismatches = int(np.sum(host_out != m.outcome.cpu().numpy()))
    node_mismatches = int(np.sum(host_served != m.served_by.cpu().numpy()))
    transfer_max_err = float(np.max(np.abs(
        host_tr - m.transfer_used.cpu().numpy().astype(np.float64)),
        initial=0.0))
    total = len(requests)
    host = dict(met_deadline=result.met_deadline, processed=result.processed,
                forwards=result.forwards, discarded=result.discarded,
                mean_response_time=result.mean_response_time,
                transfer_time=result.transfer_time)
    fleet = dict(met_deadline=int(m.met_deadline), processed=int(m.processed),
                 forwards=int(m.forwards), discarded=int(m.discarded),
                 mean_response_time=float(m.mean_response_time),
                 transfer_time=float(m.transfer_time))
    return ValidationReport(
        scenario=name, seed=seed, policy=policy, total=total,
        host=host, fleet=fleet, outcome_mismatches=mismatches,
        node_mismatches=node_mismatches, transfer_max_err=transfer_max_err,
        met_diff_pp=100.0 * abs(host["met_deadline"]
                                - fleet["met_deadline"]) / max(1, total),
        capacity=capacity, telemetry=agreement)


def main() -> List[ValidationReport]:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", nargs="*", default=[
        "paper/scenario1", "paper/scenario2", "paper/scenario3"])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--policy", default="random")
    ap.add_argument("--discard", action="store_true")
    ap.add_argument("--net", default=None,
                    help="run both engines under a link model: 'zero' or a "
                         "priced preset (campus/metro/wan).  The exactness "
                         "contract is enforced either way — the event-time "
                         "scan replays the heap exactly under any pricing "
                         "(DESIGN.md §7)")
    ap.add_argument("--telemetry", nargs="?", type=int, const=32,
                    default=None, metavar="BUCKETS",
                    help="also enforce the telemetry contract (DESIGN.md "
                         "§8): host trace and fleet time series must "
                         "agree bucket for bucket, and the telemetry run "
                         "must be bit-identical to the plain one.  "
                         "Optional value = bucket count (default 32)")
    ap.add_argument("--device", default=None,
                    help="where both engines compute (default CUDA: one "
                         "event_scan launch a fleet run; 'cpu': the eager "
                         "loop)")
    args = ap.parse_args()
    reports = []
    for sc in args.scenarios:
        workload = get_workload(sc)
        network = None
        if args.net is not None:
            topo = Topology.full_mesh(workload.n_nodes)
            network = LinkModel.zero(topo) if args.net == "zero" \
                else LinkModel.preset(topo, args.net)
        for seed in range(args.seeds):
            rep = run_validation(sc, seed, policy=args.policy,
                                 discard_on_exhaust=args.discard,
                                 network=network, telemetry=args.telemetry,
                                 device=args.device)
            reports.append(rep)
            print(rep.row(), flush=True)
    worst = max(r.met_diff_pp for r in reports)
    n_exact = sum(r.exact for r in reports)
    violations = [r for r in reports
                  if r.met_diff_pp > 0.5
                  or r.outcome_mismatches > 0.005 * r.total
                  or r.node_mismatches > 0.005 * r.total
                  or (r.telemetry is not None and not r.telemetry.ok)]
    print(f"# {n_exact}/{len(reports)} cells exact; "
          f"worst met-rate delta {worst:.3f}pp "
          f"(contract: exact or <= 0.5pp f32-boundary flips, "
          f"DESIGN.md §5/§7; net={args.net or 'none'})")
    if violations:
        raise SystemExit(
            f"equivalence contract violated in {len(violations)} cell(s): "
            + "; ".join(v.row() for v in violations))
    return reports


if __name__ == "__main__":
    main()
