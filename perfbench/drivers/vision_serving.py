"""The vision serving cells: camera frames through ``repro_torch``'s
deadline-aware engine over graphed ViT replicas.

Set-up draws the configuration's weights and ``images_per_class``
distinct frames a class on the device from the seed (:mod:`perfbench.
inputs`), builds the program's ``launch.serve.make_run_batch`` over them
(one CUDA graph per frame resolution and batch size, built through the
kernels' cache inside the checkout) and calls it once for every
resolution the mix serves at every batch size up to ``max_batch``, the
largest first, so that no graph is captured inside the window.

Before the window, episode 0's stream is served again and again,
untimed, until two episodes in a row take times within ``WARMUP_TOL``
of each other (for at least ``WARMUP_MIN_S``, at most ``WARMUP_MAX``
episodes); that is set-up too.  The window then serves episodes of the mix
(:mod:`perfbench.traffic`), each through a fresh
``serving.engine.DeadlineAwareEngine`` whose replicas share that
``run_batch``, until ``seconds`` have passed; each episode ends in
``drain``.  A thin wrapper around each replica's ``run_batch`` times the
call and records which frames it served and the labels it returned, as
``launch.serve.record_run`` does; the engine gets the generated frames
and nothing else.  With ``trace``, the window's first episodes are
served again under the profiler, whole, for at least ``PROFILE_MIN_S``
(:mod:`perfbench.trace`); the slice keeps the wall time the same
episodes took in the window, unprofiled.

Then, with the program's state freed, every frame served in the window
is judged (a cell compares the first two where its ``checks/<cell>.json``
gives them a limit; the last two have the limit 0):

* ``label_gap``: by how much the reference's logit of the label served
  lies below the reference's best logit for that frame (the widest over
  the run; the plain float32 forward of :mod:`perfbench.reference.vit`
  on the same weights and frames);
* ``labels_moved``: the share of frames served, in percent, whose label
  is not the reference's first;
* ``decisions_differing``: the frames whose serving replica, forwards or
  completion time, the batches (replica, class, frames, in order) and
  the stats that differ from the plain engine's
  (:mod:`perfbench.reference.engine`) on each episode's stream;
* ``frames_unanswered``: frames without a label in range.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from perfbench import inputs, trace as ptrace, traffic
from perfbench.reference import engine as ref_engine
from perfbench.reference import vit as ref_vit

PROFILE_MIN_S = 1.0
# warm-up: episode 0's stream served again and again, untimed, for at
# least WARMUP_MIN_S (the card's first seconds of serving run up to 15%
# slow), until two in a row take times within WARMUP_TOL of each other
WARMUP_MIN_S = 3.0
WARMUP_MAX = 8
WARMUP_TOL = 0.03
MODEL_KEYS = ("img_res", "patch", "n_layers", "d_model", "n_heads", "d_ff",
              "n_classes", "distill_token", "in_channels")


def program_config(cfg: dict):
    """The configuration as the program's ``ViTConfig``."""
    from repro_torch.configs.base import ViTConfig
    m = cfg["model"]
    return ViTConfig(name=cfg["name"], param_dtype=cfg["dtype"], remat=False,
                     attn_impl=cfg["attn_impl"], attn_chunk=cfg["attn_chunk"],
                     **{k: m[k] for k in MODEL_KEYS})


def run(cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
        trace: bool, device: str, t_process: float,
        hooks: Optional[Dict[str, Callable]] = None) -> dict:
    """One run of the cell; returns the metrics' ``record``, the
    ``checks`` (each a value and its limit from ``limits``), ``attempted``,
    ``failed`` and ``memory_peak_bytes``.  ``hooks`` plant faults in tests:
    ``run_batch(run_batch, leaves)`` wraps the program's ``run_batch``
    (``leaves``: the weights by path), ``queue()`` makes each replica's
    queue."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import (DeadlineAwareEngine, ServiceClass,
                                            ServingReplica)
    hooks = hooks or {}
    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    m = cfg["model"]
    layout = inputs.vit_layout(m)
    leaves = inputs.draw_weights(layout, seed, getattr(torch, cfg["dtype"]),
                                    dev)
    gen = inputs.frames_generator(seed, dev)
    images = [inputs.draw_frames(mix["images_per_class"], c["model_res"], gen,
                                 dev) for c in mix["classes"]]
    frames = [list(x.unbind(0)) for x in images]
    marks.append(("weights and frames", time.perf_counter()))
    run_batch = serve.make_run_batch(inputs.tree(leaves), program_config(cfg))
    if "run_batch" in hooks:
        run_batch = hooks["run_batch"](run_batch, leaves)
    res_of = {c["name"]: c["model_res"] for c in mix["classes"]}
    for res in traffic.resolutions(mix):
        img = frames[list(res_of.values()).index(res)][0]
        for b in range(mix["max_batch"], 0, -1):
            run_batch("warmup", [img] * b)
    if cuda:
        torch.cuda.synchronize(dev)
    marks.append(("kernels and graphs", time.perf_counter()))

    classes = []
    for c in mix["classes"]:
        sc = ServiceClass(c["name"], c["resolution"], deadline=c["deadline"],
                          proc_time=c["proc_time"])
        sc.batch_proc_time = traffic.batch_times(c, mix["batch_model"])
        classes.append(sc)
    sink: List[List[tuple]] = [[]]

    def replica_run(rid: int):
        def call(cls_name, payloads):
            t0 = time.perf_counter()
            out = run_batch(cls_name, [f for _, f in payloads])
            t1 = time.perf_counter()
            sink[0].append((t0, t1, rid, cls_name,
                            [fid for fid, _ in payloads], out))
            return out
        return call

    make_queue = hooks.get("queue", lambda: None)

    def episode(k: int, calls: List[tuple]) -> dict:
        sink[0] = calls
        ep = traffic.episode(mix, seed, k)
        reps = [ServingReplica(i, replica_run(i), queue=make_queue(),
                               max_batch=mix["max_batch"])
                for i in range(mix["replicas"])]
        eng = DeadlineAwareEngine(reps, max_forwards=mix["max_forwards"],
                                  rng_seed=ep["rng_seed"],
                                  forward_policy=mix["policy"], device=dev)
        reqs = [eng.submit(((k, i), frames[c][j]), classes[c], now=t, origin=o)
                for i, (t, c, j, o) in enumerate(zip(
                    ep["arrivals"], ep["cls"], ep["image"], ep["origin"]))]
        eng.drain(ep["arrivals"][-1])
        return dict(ep=ep, results=[r.result for r in reqs],
                    forwards=[r.forwards for r in reqs],
                    done_at=[r.done_at for r in reqs], stats=eng.stats())

    gc.collect()
    gc.freeze()
    warmup: List[float] = []
    while len(warmup) < WARMUP_MAX and not _steady(warmup):
        t = time.perf_counter()
        episode(0, [])
        warmup.append(time.perf_counter() - t)
    marks.append(("warm-up episodes", time.perf_counter()))

    calls: List[tuple] = []
    episodes: List[dict] = []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    ends = []
    while True:
        episodes.append(episode(len(episodes), calls))
        ends.append(time.perf_counter())
        if ends[-1] >= t_end:
            break

    slice_ = None
    if trace:
        slice_calls: List[tuple] = []
        served = [0]

        def traced():
            t = time.perf_counter()
            while (not served[0] or time.perf_counter() - t < PROFILE_MIN_S) \
                    and served[0] < len(episodes):
                episode(served[0], slice_calls)
                served[0] += 1
        slice_ = ptrace.reduce(*ptrace.profile(traced, cuda))
        slice_["calls"] = [(len(c[4]), res_of[c[3]]) for c in slice_calls]
        slice_["unprofiled_s"] = ends[served[0] - 1] - t_start

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del run_batch
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, unanswered = check(cfg, mix, limits, episodes, calls, leaves,
                               images)
    record = dict(setup_s=t_start - t_process, window=(t_start, t_end),
                  calls=[(c[0], c[1], len(c[4]), res_of[c[3]])
                         for c in calls],
                  model=m, attn_chunk=cfg["attn_chunk"],
                  elem_bytes=torch.finfo(getattr(torch, cfg["dtype"])).bits // 8,
                  trace=slice_, episode_ends=ends, warmup_episodes=warmup,
                  setup_parts=[(name, b - a) for (name, b), (_, a) in zip(
                      marks, [("", t_process)] + marks)])
    return dict(record=record, checks=checks,
                attempted=len(episodes) * mix["episode_frames"],
                failed=sum(unanswered), memory_peak_bytes=peak)


def _steady(times: List[float]) -> bool:
    """Whether the warm-up episodes have settled: ``WARMUP_MIN_S`` served,
    the last two within ``WARMUP_TOL`` of each other."""
    return len(times) >= 2 and sum(times) >= WARMUP_MIN_S and \
        abs(times[-1] - times[-2]) <= WARMUP_TOL * times[-1]


def check(cfg: dict, mix: dict, limits: dict, episodes: List[dict],
          calls: List[tuple], leaves: Dict[str, torch.Tensor],
          images: List[torch.Tensor]):
    """The checks (see the module's docstring) and each episode's count of
    frames without a label."""
    n_cls = cfg["model"]["n_classes"]
    rclasses = [dict(name=c["name"], deadline=c["deadline"],
                     proc_time=c["proc_time"],
                     batch_times=traffic.batch_times(c, mix["batch_model"]))
                for c in mix["classes"]]
    by_ep: Dict[int, List[tuple]] = defaultdict(list)
    served: Dict[tuple, int] = {}
    for _, _, rid, name, fids, out in calls:
        by_ep[fids[0][0]].append((rid, name, tuple(i for _, i in fids)))
        served.update((f, rid) for f in fids)
    differing = 0
    unanswered = []
    for k, e in enumerate(episodes):
        ep = e["ep"]
        want = ref_engine.serve(rclasses, ep["arrivals"], ep["cls"],
                                ep["origin"], mix["replicas"], mix["max_batch"],
                                mix["max_forwards"], ep["rng_seed"])
        for i in range(len(ep["arrivals"])):
            got = (served.get((k, i)), e["forwards"][i], e["done_at"][i])
            differing += got != (want["replica"][i], want["forwards"][i],
                                 want["done_at"][i])
        got_b, want_b = by_ep[k], want["batches"]
        differing += sum(a != b for a, b in zip(got_b, want_b)) \
            + abs(len(got_b) - len(want_b))
        differing += sum(e["stats"].get(s) != v
                         for s, v in want["stats"].items())
        unanswered.append(sum(not _valid(r, n_cls) for r in e["results"]))

    ref = [ref_vit.logits(leaves, x, cfg["model"]).cpu().double().numpy()
           for x in images]
    best = [r.max(axis=1) for r in ref]
    first = [r.argmax(axis=1) for r in ref]
    gap = 0.0
    answered = moved = 0
    for _, _, _, _, fids, out in calls:
        for (k, i), label in zip(fids, out):
            if not _valid(label, n_cls):
                continue
            ep = episodes[k]["ep"]
            c, j = ep["cls"][i], ep["image"][i]
            gap = max(gap, float(best[c][j] - ref[c][j, label]))
            answered += 1
            moved += int(label != first[c][j])
    value = dict(label_gap=gap, labels_moved=100.0 * moved / max(1, answered))
    checks = {k: dict(value=value[k], limit=limits[k])
              for k in value if k in limits}
    checks.update(decisions_differing=dict(value=differing, limit=0),
                  frames_unanswered=dict(value=sum(unanswered), limit=0))
    return checks, unanswered


def _valid(label, n_cls: int) -> bool:
    return isinstance(label, int) and 0 <= label < n_cls
