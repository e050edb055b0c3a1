"""Serving launcher: the deadline-aware engine over N model replicas on
one device (the port of ``repro/launch/serve.py``, same options plus
``--device``).

The paper's deployment: requests with per-resolution SLA deadlines are
admitted by the preferential queue (or FIFO for comparison), forwarded
between replicas on rejection, and executed in deadline-aware batches.
The model is the arch's smoke configuration (a vision transformer or
ResNet) with seeded weights (the model module's ``numpy_params``, seed
0); engine time is the reference's fixed step-time model, so the
engine's decisions do not depend on the device.  On CUDA each replica
batch replays a CUDA graph of the model's serve step, one per (class
resolution, batch size) (:class:`repro_torch.launch.graphs.GraphedStep`,
the counterpart of the reference's ``jax.jit``); on the CPU the step runs
eagerly.

    python -m repro_torch.launch.serve --arch deit-b \\
        --replicas 3 --requests 60 --queue preferential     # on the GPU
    python -m repro_torch.launch.serve --arch resnet-50 --device cpu

The helpers below are the pieces a caller combines for another stream:
``SURVEILLANCE`` is the surveillance stream that ``chip_smoke.py`` serves
with DeiT-B and ResNet-50 at full width, and :func:`record_run` records
an engine's decisions on it, for this package's engine or the
reference's.
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.queues import FIFOQueue
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.graphs import GraphedStep
from repro_torch.launch.steps import model_module
from repro_torch.serving.engine import (DeadlineAwareEngine, ServeRequest,
                                        ServiceClass, ServingReplica)

# the reference launcher's engine-time step model of one "hd" batch
HD_STEP_TIMES = {1: 4.0, 2: 4.6, 4: 5.8, 8: 8.0}


def _surveillance_class(name: str, resolution: int, deadline: float,
                        proc_time: float, model_res: int) -> dict:
    return dict(name=name, resolution=resolution, deadline=deadline,
                proc_time=proc_time, model_res=model_res,
                batch_proc_time={b: proc_time * (1 + 0.15 * (b - 1))
                                 for b in (1, 2, 4, 8)})


# The campus surveillance stream of examples/serve_surveillance.py at 64
# frames: its three classes (the paper's Table I in engine time units)
# with their frame sizes, deadlines, per-frame times and batch model
# proc_time * (1 + 0.15 (b - 1)), its 20 / 30 / 50 mix, 1.2 mean
# inter-arrival, stream seed 1 and forwarding seed 42.  ``model_res`` is
# the side a frame is resized to for the model: 384 px (578 tokens, the
# flash-attention kernel) for 4K and FHD frames, 224 px (198 tokens,
# naive attention) for HD frames.
SURVEILLANCE = dict(
    requests=64, inter_arrival=1.2, seed=1, rng_seed=42, replicas=3,
    max_batch=8, policy="random", weights=[0.2, 0.3, 0.5],
    classes=[_surveillance_class("4k", 3840, 60.0, 18.0, model_res=384),
             _surveillance_class("fhd", 1920, 45.0, 4.4, model_res=384),
             _surveillance_class("hd", 1280, 20.0, 2.0, model_res=224)])


def service_classes(spec, service_class=ServiceClass) -> list:
    """``spec["classes"]`` as ``service_class`` objects (batch sizes of a
    spec read back from JSON are strings)."""
    out = []
    for c in spec["classes"]:
        cls = service_class(c["name"], c["resolution"], deadline=c["deadline"],
                            proc_time=c["proc_time"])
        cls.batch_proc_time = {int(b): t
                               for b, t in c["batch_proc_time"].items()}
        out.append(cls)
    return out


def make_run_batch(params, cfg, mod=None, graphed: Optional[bool] = None
                   ) -> Callable[[str, List[torch.Tensor]], List[int]]:
    """A replica's ``run_batch``: stack the frames (H, W, C), run the
    model's ``serve_step`` on the parameters' device, return each frame's
    argmax class as a host int (so the call ends when the device's work
    does).

    ``graphed`` (default: whether the parameters are on CUDA) replays one
    CUDA graph per input shape (:class:`GraphedStep`, kept as
    ``run_batch.step``); the argmax reads the graph's static output before
    the next call can overwrite it.  ``graphed=False`` runs the step
    eagerly, the form the CPU runs and the one graphs are timed
    against."""
    mod = mod or model_module(cfg)
    on_cuda = params["head"]["w"].is_cuda        # both vision families
    if graphed is None:
        graphed = on_cuda
    if graphed and not on_cuda:
        raise ValueError("graphed=True needs the parameters on CUDA")
    step = GraphedStep.for_model(mod, params, cfg) if graphed else \
        (lambda images: mod.serve_step(params, images, cfg))

    def run_batch(cls_name: str, payloads: List[torch.Tensor]) -> List[int]:
        return step(torch.stack(payloads)).argmax(-1).tolist()

    run_batch.step = step
    return run_batch


def make_engine(run_batch, replicas: int, queue: str, max_batch: int,
                device: DeviceLike = None,
                forward_policy: str = "random") -> DeadlineAwareEngine:
    """``replicas`` replicas sharing ``run_batch``, each with a fresh
    ``"preferential"`` or ``"fifo"`` queue, on a full mesh."""
    if queue not in ("preferential", "fifo"):
        raise ValueError(f"unknown queue {queue!r}")
    reps = [ServingReplica(i, run_batch,
                           queue=FIFOQueue() if queue == "fifo" else None,
                           max_batch=max_batch)
            for i in range(replicas)]
    return DeadlineAwareEngine(reps, forward_policy=forward_policy,
                               device=device)


def frame_stream(n: int, inter_arrival: float, weights: Sequence[float] = (1.0,),
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A Poisson stream of ``n`` frames: arrival times (cumulative
    exponential gaps, drawn first, as the reference launcher draws them)
    and each frame's class index drawn with ``weights``."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(inter_arrival, size=n))
    p = np.asarray(weights, np.float64)
    classes = rng.choice(len(p), size=n, p=p / p.sum()) if len(p) > 1 \
        else np.zeros(n, np.int64)
    return arrivals, classes


def submit_stream(engine: DeadlineAwareEngine, frames: Sequence,
                  classes: Sequence[ServiceClass], arrivals: np.ndarray,
                  class_idx: np.ndarray) -> List[ServeRequest]:
    """Submit frame ``i`` of class ``classes[class_idx[i]]`` at
    ``arrivals[i]`` on replica ``i % replicas``, then drain the engine."""
    n_rep = len(engine.replicas)
    reqs = [engine.submit(frames[c], classes[c], now=float(t), origin=i % n_rep)
            for i, (t, c) in enumerate(zip(arrivals, class_idx))]
    engine.drain(float(arrivals[-1]))
    return reqs


def record_run(spec, queue: str, run_batch, frames: Sequence,
               engine=None, **engine_kw) -> dict:
    """Serve ``spec``'s stream (:data:`SURVEILLANCE`'s keys) through a
    fresh engine whose replicas all run ``run_batch`` on the frames, frame
    ``i`` being ``frames[class index]``, and record its decisions: the
    stats, each frame's class, completion time, forwards and serving
    replica, every batch (replica, class, size) in execution order, and
    each frame's result.  ``engine`` names the ``DeadlineAwareEngine``,
    ``ServingReplica``, ``ServiceClass`` and ``FIFOQueue`` to use (default:
    this package's), so that the reference engine runs the same stream;
    ``engine_kw`` go to the engine (``device=``)."""
    e = engine or SimpleNamespace(
        DeadlineAwareEngine=DeadlineAwareEngine, ServingReplica=ServingReplica,
        ServiceClass=ServiceClass, FIFOQueue=FIFOQueue)
    batches, served = [], {}

    def replica_run(rep):
        def run(cls_name, payloads):
            batches.append([rep, cls_name, len(payloads)])
            served.update((i, rep) for i, _ in payloads)
            return run_batch(cls_name, [f for _, f in payloads])
        return run

    reps = [e.ServingReplica(i, replica_run(i),
                             queue=e.FIFOQueue() if queue == "fifo" else None,
                             max_batch=spec["max_batch"])
            for i in range(spec["replicas"])]
    eng = e.DeadlineAwareEngine(reps, forward_policy=spec["policy"],
                                rng_seed=spec["rng_seed"], **engine_kw)
    classes = service_classes(spec, e.ServiceClass)
    arrivals, idx = frame_stream(spec["requests"], spec["inter_arrival"],
                                 spec["weights"], spec["seed"])
    reqs = [eng.submit((i, frames[c]), classes[c], now=float(t),
                       origin=i % spec["replicas"])
            for i, (t, c) in enumerate(zip(arrivals, idx))]
    eng.drain(float(arrivals[-1]))
    return dict(stats=eng.stats(), classes=[int(c) for c in idx],
                done_at=[r.done_at for r in reqs],
                forwards=[r.forwards for r in reqs],
                replica=[served.get(i) for i in range(len(reqs))],
                batches=batches, results=[r.result for r in reqs])


def summary(queue: str, stats) -> str:
    met_pct = 100 * stats["met"] / max(1, stats["met"] + stats["missed"])
    return (f"{queue}: {met_pct:.1f}% deadlines met, "
            f"{stats['forwards']} forwards, {stats['forced']} forced, "
            f"{stats['batches']} device batches")


def run(args: argparse.Namespace):
    """The launcher's run: returns ``(engine, requests)``."""
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if cfg.family not in ("vit", "resnet"):
        raise SystemExit("serve launcher demo supports vision archs")
    mod = model_module(cfg)
    params = mod.params_from_numpy(mod.numpy_params(cfg, 0), cfg, dev)
    run_batch = make_run_batch(params, cfg, mod)
    img = torch.ones((cfg.img_res, cfg.img_res, 3), dtype=torch.float32,
                     device=dev)
    run_batch("warmup", [img])
    cls = ServiceClass("hd", cfg.img_res, deadline=args.deadline,
                       proc_time=4.0)
    cls.batch_proc_time = dict(HD_STEP_TIMES)
    eng = make_engine(run_batch, args.replicas, args.queue, args.max_batch,
                      device=dev)
    arrivals, idx = frame_stream(args.requests, args.inter_arrival)
    return eng, submit_stream(eng, [img], [cls], arrivals, idx)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deit-b")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--queue", default="preferential",
                    choices=["preferential", "fifo"])
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--inter-arrival", type=float, default=1.2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    eng, _ = run(args)
    print(summary(args.queue, eng.stats()))


if __name__ == "__main__":
    main()
