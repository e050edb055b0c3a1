"""The port's serving path against the JAX reference's on the CPU.

Host code (queues, router, placement, engine) must make the reference's
decisions exactly: both packages seed the router with
``random.Random(f"serving-fwd:{seed}")`` and draw origins from
``np.random.default_rng(seed)``, and the ``batched_feasible`` policy
scores with ``repro_torch.kernels.ops.fleet_feasibility`` (on the CPU its
plain version) where the reference uses ``jax_queue.feasible_nodes``
(the same verdicts; ``torch_queue.feasible_nodes``, the port of the
latter, is held to it bit for bit below).
Then the whole slice: ``repro_torch.launch.serve`` against
``repro.launch.serve`` with the same weights.
"""
import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_queue as jq
from repro.core.block_queue import FastPreferentialQueue as JFastQ
from repro.core.block_queue import PreferentialQueue as JPrefQ
from repro.core.queues import FIFOQueue as JFIFO
from repro.core.request import Request as JRequest
from repro.core.request import Service as JService
from repro.launch import serve as jserve
from repro.models import vit as jvit
from repro.orchestration import Topology as JTopology
from repro.orchestration import router as jrouter
from repro.serving import engine as jeng
from repro_torch.core import torch_queue as tq
from repro_torch.core.block_queue import FastPreferentialQueue as TFastQ
from repro_torch.core.block_queue import PreferentialQueue as TPrefQ
from repro_torch.core.queues import FIFOQueue as TFIFO
from repro_torch.core.request import Request as TRequest
from repro_torch.core.request import Service as TService
from repro_torch.launch import serve as tserve
from repro_torch.orchestration import ROUTER_POLICIES, Topology
from repro_torch.orchestration import router as trouter
from repro_torch.serving import engine as teng

VIT_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "torch_vit_golden.json")
POLICIES = ["random", "power_of_two", "least_loaded", "round_robin",
            "batched_feasible"]


def _classes(mod):
    hd = mod.ServiceClass("hd", 224, deadline=30.0, proc_time=4.0)
    hd.batch_proc_time = {1: 4.0, 2: 4.6, 4: 5.8, 8: 8.0}
    fhd = mod.ServiceClass("fhd", 384, deadline=41.5, proc_time=9.7)
    fhd.batch_proc_time = {1: 9.7, 2: 12.1, 4: 16.3, 8: 24.9}
    return [hd, fhd]


def _run_engine(mod, fifo_cls, queue, policy, arrivals, idx, n_rep=3,
                topology=None, **kw):
    """One engine of package ``mod`` with a constant runner per replica
    that records its batches; returns every decision."""
    batches, served = [], {}

    def runner(rep):
        def run_batch(cls_name, payloads):
            batches.append((rep, cls_name, len(payloads)))
            for i in payloads:
                served[i] = rep
            return [f"{cls_name}:{i}" for i in payloads]
        return run_batch

    reps = [mod.ServingReplica(i, runner(i),
                               queue=fifo_cls() if queue == "fifo" else None,
                               max_batch=8)
            for i in range(n_rep)]
    eng = mod.DeadlineAwareEngine(reps, forward_policy=policy,
                                  topology=topology, rng_seed=3, **kw)
    classes = _classes(mod)
    reqs = []
    for i, (t, c) in enumerate(zip(arrivals, idx)):
        origin = None if i % 5 == 0 else i % n_rep   # some from the rng
        reqs.append(eng.submit(i, classes[c], now=float(t), origin=origin))
    eng.drain(float(arrivals[-1]))
    return dict(stats=eng.stats(), batches=batches,
                done_at=[r.done_at for r in reqs],
                forwards=[r.forwards for r in reqs],
                results=[r.result for r in reqs],
                served=[served.get(i) for i in range(len(reqs))])


@pytest.mark.parametrize("queue", ["preferential", "fifo"])
@pytest.mark.parametrize("policy", POLICIES)
def test_engine_decisions_match_reference(policy, queue):
    arrivals, idx = tserve.frame_stream(56, 1.3, (0.6, 0.4), seed=4)
    want = _run_engine(jeng, JFIFO, queue, policy, arrivals, idx)
    got = _run_engine(teng, TFIFO, queue, policy, arrivals, idx,
                      device="cpu")
    assert got == want
    assert want["stats"]["forwards"] > 0 and want["stats"]["batches"] > 0


def test_engine_on_a_heterogeneous_ring_matches_reference():
    arrivals, idx = tserve.frame_stream(40, 1.0, (0.5, 0.5), seed=9)
    want = _run_engine(jeng, JFIFO, "preferential", "batched_feasible",
                       arrivals, idx, n_rep=4,
                       topology=JTopology.ring(4, speeds=[1, 2, 0.5, 1]))
    got = _run_engine(teng, TFIFO, "preferential", "batched_feasible",
                      arrivals, idx, n_rep=4,
                      topology=Topology.ring(4, speeds=[1, 2, 0.5, 1]),
                      device="cpu")
    assert got == want


def test_port_engine_reproduces_the_golden_serving_run():
    """The decisions ``chip_smoke.py`` holds the card to come from the
    reference engine on ``SURVEILLANCE``; the port's engine makes them on
    the CPU too."""
    with open(VIT_GOLDEN) as f:
        spec = json.load(f)["serving"]
    assert {k: v for k, v in spec.items() if k != "runs"} == json.loads(
        json.dumps(tserve.SURVEILLANCE))
    for queue, want in spec["runs"].items():
        got = tserve.record_run(spec, queue,
                                lambda cls_name, frames: [0] * len(frames),
                                [None] * len(spec["classes"]), device="cpu")
        del got["results"]
        assert got == want
    # the paper's contrast: preferential admission meets every deadline
    # with fewer referrals than FIFO
    pref, fifo = (spec["runs"][q]["stats"] for q in ("preferential", "fifo"))
    assert pref["met"] > fifo["met"] and pref["forwards"] < fifo["forwards"]


def _svc(service_cls, rng):
    p = float(rng.choice([2.0, 3.5, 7.25, 10.0]))
    return service_cls(f"s{p}", pixels=1, environment="busy", proc_time=p,
                       deadline=float(rng.choice([12.0, 30.0, 55.5])))


@pytest.mark.parametrize("queues", [(JPrefQ, TPrefQ), (JFastQ, TFastQ),
                                    (JFIFO, TFIFO)])
def test_queues_match_reference(queues):
    """Random pushes (forced and not) and pops: the same verdicts, the
    same scheduled blocks, the same pending work."""
    jqueue, tqueue = queues[0](), queues[1]()
    rng = np.random.default_rng(17)
    now = 0.0
    for step in range(400):
        now += float(rng.exponential(1.5))
        if rng.random() < 0.3:
            a, b = jqueue.pop(), tqueue.pop()
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.rid, a.arrival_time) == (b.rid, b.arrival_time)
            continue
        svc_seed = int(rng.integers(1 << 30))
        forced = bool(rng.random() < 0.2)
        js = _svc(JService, np.random.default_rng(svc_seed))
        ts = _svc(TService, np.random.default_rng(svc_seed))
        jr = JRequest(js, now, 0, rid=step)
        tr = TRequest(ts, now, 0, rid=step)
        free = now + float(rng.choice([0.0, 1.0, 4.5]))
        assert jqueue.push(jr, free, forced) == tqueue.push(tr, free, forced)
        assert len(jqueue) == len(tqueue)
        assert jqueue.pending_work() == tqueue.pending_work()
        assert jqueue.scheduled_blocks(free) == tqueue.scheduled_blocks(free)


def test_feasible_nodes_matches_reference():
    """K stacked ledgers with gaps, ties and straddling blocks: the same
    feasibility bit per candidate as ``jax_queue.feasible_nodes``."""
    rng = np.random.default_rng(23)
    checked = 0
    for trial in range(60):
        K, N = int(rng.integers(1, 6)), 16
        starts = np.full((K, N), jq.BIG, np.float32)
        ends = np.full((K, N), jq.BIG, np.float32)
        sizes = np.zeros((K, N), np.float32)
        ns = rng.integers(0, N, K).astype(np.int32)
        for k in range(K):
            t = float(rng.integers(0, 20))
            for i in range(ns[k]):
                t += float(rng.choice([0.0, 0.0, 1.5, 4.0]))
                sz = float(rng.choice([2.0, 4.6, 10.0]))
                starts[k, i], ends[k, i], sizes[k, i] = t, t + sz, sz
                t += sz
        ps = rng.choice([2.0, 4.0, 9.7], K).astype(np.float32)
        d = np.float32(rng.choice([float(starts[0, 0]) if ns[0] else 5.0,
                                   float(rng.integers(5, 120))]))
        frees = rng.integers(0, 30, K).astype(np.float32)
        want = np.asarray(jq.feasible_nodes(
            jq.Ledger(*(jnp.asarray(a) for a in (starts, ends, sizes, ns))),
            jnp.asarray(ps), jnp.float32(d), jnp.asarray(frees)))
        got = tq.feasible_nodes(
            tq.Ledger(*(torch.from_numpy(a) for a in (starts, ends, sizes,
                                                      ns))),
            torch.from_numpy(ps), torch.tensor(d), torch.from_numpy(frees))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want)
        checked += int(want.any()) + int((~want).any())
    assert checked > 60                 # both verdicts occur


def test_router_policies_and_host_mirror():
    assert ROUTER_POLICIES == jrouter.ROUTER_POLICIES
    with pytest.raises(ValueError, match="unknown router policy"):
        trouter.Router(Topology.full_mesh(3), "nearest", device="cpu")
    blocks = [(0.0, 4.0), (6.0, 10.0), (20.0, 24.0)]
    for p, d, free in ((2.0, 12.0, 0.0), (9.0, 19.0, 1.0), (3.0, 5.0, 4.5)):
        assert trouter._host_feasible(blocks, p, d, free) == \
            jrouter._host_feasible(blocks, p, d, free)


def _serve_args(queue, device="cpu"):
    return argparse.Namespace(arch="deit-b", replicas=3, requests=24,
                              queue=queue, max_batch=8, deadline=30.0,
                              inter_arrival=1.2, device=device)


@pytest.mark.parametrize("queue", ["preferential", "fifo"])
def test_serve_launcher_matches_reference(queue, capsys, monkeypatch):
    """The whole slice on the CPU: the port's launcher against the
    reference's — its printed summary, and per request the argmax of the
    smoke DeiT (f32, the launcher's weights carried by numpy) through the
    reference engine driving the reference model."""
    jserve_argv = ["--queue", queue, "--requests", "24"]
    monkeypatch.setattr(sys, "argv", ["serve"] + jserve_argv)
    jserve.main()
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    tserve.main(jserve_argv + ["--device", "cpu"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line == want_line

    args = _serve_args(queue)
    eng, reqs = tserve.run(args)
    # the reference launcher's path with the port's weights
    from repro.configs import get_smoke_config
    cfg = get_smoke_config("deit-b")
    tcfg = tserve.get_smoke_config("deit-b")
    tree = tserve.model_module(tcfg).numpy_params(tcfg, 0)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(cfg.param_dtype), tree)
    fwd = jax.jit(lambda imgs: jvit.forward(params, imgs, cfg))

    def run_batch(cls_name, payloads):
        return list(np.asarray(jnp.argmax(fwd(jnp.stack(payloads)), -1)))

    img = jnp.ones((cfg.img_res, cfg.img_res, 3), jnp.float32)
    cls = jeng.ServiceClass("hd", cfg.img_res, deadline=30.0, proc_time=4.0)
    cls.batch_proc_time = dict(tserve.HD_STEP_TIMES)
    jreps = [jeng.ServingReplica(i, run_batch, max_batch=8,
                                 queue=JFIFO() if queue == "fifo" else None)
             for i in range(3)]
    jeng_ = jeng.DeadlineAwareEngine(jreps)
    arrivals = np.cumsum(np.random.default_rng(0).exponential(1.2, 24))
    jreqs = [jeng_.submit(img, cls, now=float(t), origin=i % 3)
             for i, t in enumerate(arrivals)]
    jeng_.drain(float(arrivals[-1]))
    assert eng.stats() == jeng_.stats()
    assert [r.done_at for r in reqs] == [r.done_at for r in jreqs]
    assert [r.result for r in reqs] == [int(r.result) for r in jreqs]


def test_serve_run_on_cpu_serves_every_frame():
    eng, reqs = tserve.run(_serve_args("preferential"))
    assert len(reqs) == 24 and all(isinstance(r.result, int) for r in reqs)
    assert eng.stats()["met"] + eng.stats()["missed"] == 24
