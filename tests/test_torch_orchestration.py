"""The port's event heap (``repro_torch.orchestration.Orchestrator`` and the
paper's simulator over it) against the JAX package's, on the CPU.

Both heaps are host Python in float64 and draw their stochastic forwards
from Python's ``random`` with the same seeding, so the bar is exact: per
request ``completion_time``, ``served_by`` and ``forwards``, every field
of the result and of ``per_node`` / ``per_service``, and the order of the
hook calls.  The reference's ``batched_feasible`` router scores through
``jax_queue.feasible_nodes``, the port's through
``repro_torch.kernels.ops.fleet_feasibility`` (on the CPU its plain
version, ``ref.fleet_feasibility_ref``).  The port's ``run_simulation``
is also held to ``tests/golden_simulator.json``, the reference's pinned
Table II grid (all 18 entries).
"""
import dataclasses
import json
import os

import pytest
import torch

from repro.core.block_queue import (FastPreferentialQueue as JFast,
                                    PreferentialQueue as JFaithful)
from repro.core.queues import EDFQueue as JEDF, FIFOQueue as JFIFO
from repro.netsim import LinkModel as JLinkModel
from repro.orchestration import (Hooks as JHooks,
                                 Orchestrator as JOrchestrator,
                                 Router as JRouter, Topology as JTopology,
                                 UniformWorkload as JUniformWorkload)
from repro_torch.core.block_queue import (FastPreferentialQueue as TFast,
                                          PreferentialQueue as TFaithful)
from repro_torch.core.node import MECNode
from repro_torch.core.policies import make_policy
from repro_torch.core.queues import EDFQueue as TEDF, FIFOQueue as TFIFO
from repro_torch.core.request import SERVICES
from repro_torch.core.scenarios import generate_requests, total_requests
from repro_torch.core.simulator import (SimConfig, make_queue,
                                        run_experiment, run_simulation)
from repro_torch.netsim import LinkModel as TLinkModel, paper_campus
from repro_torch.orchestration import (Hooks as THooks,
                                       Orchestrator as TOrchestrator,
                                       Router as TRouter,
                                       Topology as TTopology,
                                       UniformWorkload as TUniformWorkload)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_simulator.json")
HOT_COUNTS = [{"S1": 30, "S4": 30, "S5": 25, "S6": 25}] * 3
POLICIES = ("random", "power_of_two", "least_loaded", "round_robin",
            "batched_feasible")
QUEUES = {"fifo": (JFIFO, TFIFO), "edf": (JEDF, TEDF),
          "preferential": (JFast, TFast),
          "preferential_faithful": (JFaithful, TFaithful)}
RESULT_FIELDS = ("total_requests", "processed", "met_deadline", "forwards",
                 "discarded", "mean_response_time", "end_time", "events",
                 "transfer_time")


def _hot(seed=0, counts=HOT_COUNTS):
    j = JUniformWorkload(counts, window=1200.0, name="hot").generate(seed)
    t = TUniformWorkload(counts, window=1200.0, name="hot").generate(seed)
    assert [(r.arrival_time, r.origin_node, r.service.name) for r in j] == \
        [(r.arrival_time, r.origin_node, r.service.name) for r in t]
    return j, t


def _recorder(log, index):
    """Hooks appending (hook, request index, node ids, now) to ``log``."""
    return dict(
        on_admit=lambda r, n, now, forced: log.append(
            ("admit", index[r.rid], n.node_id, now, forced)),
        on_forward=lambda r, s, d, now: log.append(
            ("forward", index[r.rid], s.node_id, d.node_id, now)),
        on_discard=lambda r, n, now: log.append(
            ("discard", index[r.rid], n.node_id, now)),
        on_complete=lambda r, n, now: log.append(
            ("complete", index[r.rid], n.node_id, now)))


def _run_both(queue="preferential", policy="random", seed=0, topo=None,
              net=None, counts=HOT_COUNTS, **kw):
    """Both heaps on the same requests; returns, for the reference and the
    port, (result, requests, hook log, request index by rid)."""
    jq, tq = QUEUES[queue]
    jtopo, ttopo = topo or (JTopology.full_mesh(len(counts)),
                            TTopology.full_mesh(len(counts)))
    jnet = tnet = None
    if net is not None:
        jnet, tnet = JLinkModel.preset(jtopo, net), TLinkModel.preset(ttopo,
                                                                      net)
    jreqs, treqs = _hot(seed, counts)
    out = []
    for Orch, Router, Hooks, q, topo_, net_, reqs in (
            (JOrchestrator, JRouter, JHooks, jq, jtopo, jnet, jreqs),
            (TOrchestrator, TRouter, THooks, tq, ttopo, tnet, treqs)):
        log = []
        index = {r.rid: i for i, r in enumerate(reqs)}
        router = Router(topo_, policy, seed=seed,
                        **({} if Orch is JOrchestrator else
                           dict(device="cpu")))
        orch = Orch(topo_, q, router, network=net_,
                    hooks=Hooks(**_recorder(log, index)), **kw)
        out.append((orch.run(reqs), reqs, log, index))
    return out


def _assert_same(ref, port):
    (a, areqs, alog, aidx), (b, breqs, blog, bidx) = ref, port
    for f in RESULT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert [dataclasses.asdict(m) for m in a.per_node] == \
        [dataclasses.asdict(m) for m in b.per_node]
    assert {k: dataclasses.asdict(v) for k, v in a.per_service.items()} == \
        {k: dataclasses.asdict(v) for k, v in b.per_service.items()}
    assert [aidx[r.rid] for r in a.completed] == \
        [bidx[r.rid] for r in b.completed]
    for x, y in zip(areqs, breqs):
        assert (x.completion_time, x.served_by, x.forwards) == \
            (y.completion_time, y.served_by, y.forwards)
    assert alog == blog
    assert a.met_rate == b.met_rate


@pytest.mark.parametrize("queue", ["fifo", "edf", "preferential"])
@pytest.mark.parametrize("policy", POLICIES)
def test_orchestrator_matches_reference(policy, queue):
    ref, port = _run_both(queue, policy)
    _assert_same(ref, port)
    assert port[0].forwards > 0 and port[0].events > port[0].total_requests


def test_faithful_preferential_queue_matches_reference():
    _assert_same(*_run_both("preferential_faithful", "power_of_two", seed=1))


@pytest.mark.parametrize("policy", ["round_robin", "batched_feasible"])
def test_heterogeneous_ring_matches_reference(policy):
    speeds = [1.0, 2.0, 0.5]
    ref, port = _run_both(
        "preferential", policy,
        topo=(JTopology.ring(3, speeds=speeds),
              TTopology.ring(3, speeds=speeds)))
    _assert_same(ref, port)
    # the shadow requests never leak: the caller's objects keep their
    # unscaled service
    assert all(r.service is SERVICES[r.service.name] for r in port[1])


@pytest.mark.parametrize("queue", ["fifo", "preferential"])
def test_discard_variant_matches_reference(queue):
    ref, port = _run_both(queue, "random", discard_on_exhaust=True)
    _assert_same(ref, port)
    assert port[0].discarded > 0
    assert any(e[0] == "discard" for e in port[2])


@pytest.mark.parametrize("policy", ["random", "batched_feasible"])
def test_campus_pricing_matches_reference(policy):
    ref, port = _run_both("preferential", policy, net="campus",
                          forward_delay=1.5)
    _assert_same(ref, port)
    assert port[0].transfer_time > 0


def test_hook_order_follows_the_heap():
    """Each request: admitted (or discarded) after its forwards, completed
    after its admission, and the clock never runs backwards."""
    _, (res, _, log, _) = _run_both("fifo", "random", discard_on_exhaust=True)
    assert [e[-1] if e[0] != "admit" else e[3] for e in log] == sorted(
        e[-1] if e[0] != "admit" else e[3] for e in log)
    seen = {}
    for e in log:
        seen.setdefault(e[1], []).append(e[0])
    for kinds in seen.values():
        while kinds and kinds[0] == "forward":
            kinds.pop(0)
        assert kinds in (["admit", "complete"], ["discard"]), kinds
    assert len(seen) == res.total_requests


def test_golden_simulator_grid():
    """All 18 pinned (scenario, queue, seed) runs of the paper's grid."""
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert len(golden) == 18
    for key, g in golden.items():
        scenario, queue, seed = key.split("-")
        r = run_simulation(SimConfig(scenario=int(scenario), queue=queue,
                                     seed=int(seed)), device="cpu")
        for f in ("total_requests", "processed", "met_deadline", "forwards",
                  "discarded", "per_node_forwards"):
            assert getattr(r, f) == g[f], (key, f)
        assert r.mean_response_time == pytest.approx(
            g["mean_response_time"], rel=1e-9), key


def test_simulator_adapter_pieces():
    assert total_requests(1) == 6000 and total_requests(3) == 9800
    reqs = generate_requests(2, 0)
    assert len(reqs) == 8000 and reqs == sorted(
        reqs, key=lambda r: (r.arrival_time, r.rid))
    for kind, cls in (("fifo", TFIFO), ("edf", TEDF),
                      ("preferential", TFast),
                      ("preferential_faithful", TFaithful)):
        assert type(make_queue(kind)) is cls
    assert make_queue("preferential_compact").forced_compaction
    with pytest.raises(ValueError, match="unknown queue"):
        make_queue("lifo")
    agg = run_experiment(3, "preferential", n_seeds=2, device="cpu")
    assert agg.n_seeds == 2 and 0.0 < agg.met_rate_mean <= 1.0


def test_legacy_policies_and_nodes():
    import random
    nodes = [MECNode(i, TFIFO()) for i in range(3)]
    for name in ("random", "power_of_two", "least_loaded", "round_robin"):
        pol = make_policy(name, random.Random(0))
        assert pol.choose(nodes, 1).node_id != 1
    with pytest.raises(ValueError, match="unknown forward policy"):
        make_policy("nope", random.Random(0))
    topo, link = paper_campus()
    assert topo.n_nodes == link.n_nodes == 3 and not link.is_zero
    assert TLinkModel.zero(topo).is_zero


def test_orchestrator_default_router_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = TTopology.full_mesh(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOrchestrator(topo, TFIFO)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_simulation(SimConfig(scenario=3))
    orch = TOrchestrator(topo, TFIFO, device="cpu")
    assert orch.router.policy == "random" and orch.router.device.type == "cpu"
