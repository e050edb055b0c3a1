"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any mismatch or exception exits non-zero before the
final line:

1. card    — the GPU's name and power limit (nvidia-smi);
2. build   — ``nvcc`` builds the ``event_select`` kernel from
             ``src/repro_torch/kernels/csrc/``;
3. kernel  — the kernel against its plain PyTorch version on the card:
             random fleets (K in {3, 6, 32}, W in {64, 512}) with
             head-pointer rows, ties and a priced network, and inputs
             captured from each of the four main-path runs (so every
             (K, W) the main path gives the kernel is checked); then its
             time at those shapes (CUDA events around a CUDA graph of 1000
             launches, and around 1000 eager calls) beside the plain
             version's and the byte bound;
4. main    — ``repro_torch.fleetsim.simulate`` on ``paper/scenario1..3``
             and the 32-node fleet (seed 0, full mesh, campus pricing,
             ``batched_feasible``), each held against the JAX reference's
             digests in ``tests/data/torch_fleetsim_golden.json``, with
             the kernel's launch count equal to the run's event steps;
5. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_fleetsim_golden.json")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.fleetsim import simulate, topology_arrays  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import event_select as es_mod  # noqa: E402
from repro_torch.netsim import LinkModel  # noqa: E402
from repro_torch.orchestration import (Topology, fleet_workload,  # noqa: E402
                                       get_workload)

BIG = 1e30
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
NAMES = ("take_fresh", "t", "node", "feasible", "arrive", "j", "cap", "load")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/event_select.cu"
KERNEL_REPLACES = "src/repro/kernels/event_select.py:43"
LOAD_RTOL = 1e-6                   # load of non-dyadic sizes (sum order)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def workload_of(spec):
    w = spec["workload"]
    if "registry" in w:
        return get_workload(w["registry"])
    return fleet_workload(w["fleet"], w["div"])


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().astype(np.int32).tobytes()
                          ).hexdigest()


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------
def random_args(rng, K, W, speeds, dev, tie=False):
    """A random head-pointer fleet window and two candidate events, as
    ``ops.event_select`` takes them.  Times sit on a 0.5 grid so that
    deadlines land exactly on block edges (the ``<`` ties)."""
    starts = np.full((K, W), BIG, np.float32)
    ends = np.full((K, W), BIG, np.float32)
    sizes = np.zeros((K, W), np.float32)
    head = np.zeros(K, np.int32)
    n = np.zeros(K, np.int32)
    edges = []
    for k in range(K):
        h = int(rng.integers(0, W // 4 + 1))
        nk = W - h if rng.random() < 0.15 else int(rng.integers(0, W - h + 1))
        head[k], n[k] = h, nk
        starts[k, :h] = ends[k, :h] = -BIG
        tcur = float(rng.integers(0, 400)) / 2
        for i in range(h, h + nk):
            gap = 0.0 if rng.random() < 0.6 else float(rng.integers(1, 100)) / 2
            size = np.float32(rng.choice([20.0, 44.0, 180.0]) / speeds[k])
            s = np.float32(tcur + gap)
            starts[k, i], ends[k, i], sizes[k, i] = s, s + size, size
            tcur = float(s + size)
            edges.append(float(starts[k, i]))
    busy = (rng.integers(0, 400, K) / 2).astype(np.float32)
    lat = rng.uniform(0, 120, (K, K)).astype(np.float32)
    ibw = rng.choice([0.0, 0.1, 0.8, 1.0], (K, K)).astype(np.float32)
    np.fill_diagonal(lat, 0.0)
    np.fill_diagonal(ibw, 0.0)

    def deadline():
        if edges and rng.random() < 0.5:
            return float(rng.choice(edges))          # a tie with a block
        return float(rng.integers(0, 20000)) / 2

    t_a = float(rng.integers(0, 800)) / 2
    t_b = t_a if tie else float(rng.integers(0, 800)) / 2
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    i = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    b = lambda x: torch.tensor(x, dtype=torch.bool, device=dev)
    pays = [0.9216, 2.7648, 6.2208, 24.8832]
    return (f(t_a), i(int(rng.integers(K))), f(deadline()), f(44.0),
            f(float(rng.choice(pays))), b(bool(rng.random() < 0.85)),
            f(t_b), i(int(rng.integers(K))), f(deadline()), f(20.0),
            f(float(rng.choice(pays))), b(bool(rng.random() < 0.85)),
            *(torch.from_numpy(a).to(dev) for a in
              (starts, ends, sizes, n, head)),
            torch.tensor(speeds, dtype=torch.float32, device=dev),
            *(torch.from_numpy(a).to(dev) for a in (busy, lat, ibw)))


def check_kernel(args, exact_load=True) -> float:
    """Kernel vs plain version on one input; returns the max abs error
    over the float outputs.  Integer and bool outputs, t, arrive and cap
    must match bit for bit; load too when the sizes are dyadic."""
    got = ops.event_select(*args)
    want = ref.event_select_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(NAMES, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"event_select {name}: {g.dtype}{tuple(g.shape)} vs "
                 f"{w.dtype}{tuple(w.shape)}")
        if g.dtype.is_floating_point:
            err = max(err, float((g - w).abs().max()))
        if name == "load" and not exact_load:
            if not torch.allclose(g, w, rtol=LOAD_RTOL, atol=0.0):
                fail("event_select load outside rtol")
        elif not torch.equal(g, w):
            fail(f"event_select {name} differs from the plain version: "
                 f"{g.tolist()} vs {w.tolist()}")
    return err


def capture_inputs(spec, golden, dev, limit=1500, every=150):
    """Inputs of every ``every``-th event_select call in the first
    ``limit`` events of a run (its outputs are discarded)."""
    captured = []
    real = ops.event_select

    def spy(*args):
        if (len(captured) + 1) * every == spy.calls + 1:
            captured.append(tuple(a.clone() for a in args))
        spy.calls += 1
        return real(*args)

    spy.calls = 0
    reqs, topo, net = main_inputs(spec)
    ops.event_select = spy
    try:
        simulate(reqs, topo, policy=golden["policy"],
                 max_forwards=golden["max_forwards"],
                 capacity=spec["capacity"], depth=spec["depth"], net=net,
                 max_events=limit, device=dev)
    finally:
        ops.event_select = real
    return captured


def packed_args(args):
    """``ops.event_select`` arguments as the kernel wrapper takes them: the
    twelve candidate scalars in one f32 and one int32 device buffer."""
    return (*ops.candidate_buffers(*args[:12]), *args[12:16],
            args[16].to(torch.int32), *args[17:])


def timed_ms(fn, reps: int) -> float:
    """Device time per call: CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time per call with the launch overhead taken out: ``reps``
    calls captured into one CUDA graph, replayed under CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_segment(spec, golden, dev, events=500):
    """The first ``events`` events of a run under ``torch.profiler``:
    wall time, device busy time (the sum of kernel times), kernel
    launches per event, the host's time in device-to-host syncs, and the
    costliest host ops and device kernels.  The profiler slows the host,
    so the idle share it shows is an upper bound for an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs, topo, net = main_inputs(spec)
    kw = dict(policy=golden["policy"], max_forwards=golden["max_forwards"],
              capacity=spec["capacity"], depth=spec["depth"], net=net,
              max_events=events, device=dev)
    simulate(reqs, topo, **kw)                     # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        m = simulate(reqs, topo, **kw)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    ka = prof.key_averages()
    dev_key = ("self_device_time_total"
               if hasattr(ka[0], "self_device_time_total")
               else "self_cuda_time_total")
    # a CPU op also carries the time of the kernels it launched: count the
    # device's own entries (kernels, copies, fills) only
    on_dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy_us = sum(getattr(e, dev_key) for e in on_dev)
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    sync_us = sum(e.self_cpu_time_total for e in ka if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaMemcpyAsync"))
    top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    top_dev = sorted(on_dev, key=lambda e: getattr(e, dev_key),
                     reverse=True)[:6]
    return dict(
        events=m.events, wall_us=wall_us, device_busy_us=busy_us,
        idle_share=(1.0 - busy_us / wall_us) if busy_us > 0 else None,
        launches_per_event=launches / m.events,
        retire_iterations=m.retire_iterations, sync_us=sync_us,
        top_host_ops=[(e.key, e.count, round(e.self_cpu_time_total))
                      for e in top],
        top_device_ops=[(e.key[:60], e.count, round(getattr(e, dev_key)))
                        for e in top_dev])


def bound_ms(K: int, W: int) -> float:
    """Least time for the work: each input read once, each output written
    once — three (K, W) f32 windows, four (K,) vectors, the selected (K,)
    latency and inverse-bandwidth rows, 48 bytes of candidate scalars;
    out 1 + 4 + 4 bytes of merge scalars and 17 bytes per node."""
    nbytes = 12 * K * W + 16 * K + 8 * K + 48 + 9 + 17 * K
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def main_inputs(spec):
    reqs, _ = workload_of(spec).to_arrays(0)
    topo = Topology.full_mesh(spec["n_nodes"])
    return (reqs, topology_arrays(topo),
            LinkModel.campus(topo).net_params())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with open(GOLDEN) as f:
        golden = json.load(f)
    t_start = time.time()

    # -- 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build
    t0 = time.time()
    build.load("event_select")
    print(f"build: event_select {time.time() - t0:.2f} s", flush=True)

    # -- 3. kernel against its plain version
    rng = np.random.default_rng(0)
    max_err, n_checked = 0.0, 0
    for K in (3, 6, 32):
        for W in (64, 512):
            cases = [(np.ones(K), True, False), (np.ones(K), True, True),
                     (rng.choice([0.5, 1.0, 2.0], K), True, False),
                     (rng.choice([1.0, 3.0], K), False, False)]
            for speeds, exact, tie in cases:
                for _ in range(3):
                    args = random_args(rng, K, W, speeds, dev, tie=tie)
                    max_err = max(max_err, check_kernel(args, exact))
                    n_checked += 1
    # inputs captured from every main-path run, so each (K, W) the main
    # path gives the kernel is checked on its own run's data; the last
    # input of each shape is the one timed below
    runs = golden["runs"]
    shape_args, n_captured = {}, 0
    for spec in runs:
        captured = capture_inputs(spec, golden, dev)
        if not captured:
            fail(f"no event_select inputs captured from {spec['name']}")
        for args in captured:
            max_err = max(max_err, check_kernel(args))
        n_checked += len(captured)
        n_captured += len(captured)
        shape_args.setdefault(tuple(captured[-1][12].shape), captured[-1])
    main_shapes = {(s["n_nodes"], s["depth"]) for s in runs}
    if set(shape_args) != main_shapes:
        fail(f"captured shapes {sorted(shape_args)} are not the main "
             f"path's {sorted(main_shapes)}")
    print(f"kernel: {n_checked} inputs ({n_captured} captured from the "
          f"{len(runs)} main-path runs, shapes (K, W) "
          f"{sorted(shape_args)}) match the plain version, max abs err "
          f"{max_err}", flush=True)

    shapes = []
    for (K, W), args in shape_args.items():
        packed = packed_args(args)
        kern = lambda: es_mod.event_select(*packed)
        plain = lambda: ref.event_select_ref(*args)
        row = dict(K=K, W=W, ms=graph_ms(kern, 1000),
                   ms_eager=timed_ms(kern, 1000),
                   plain_ms=graph_ms(plain, 200),
                   plain_ms_eager=timed_ms(plain, 200),
                   bound_ms=bound_ms(K, W))
        shapes.append(row)
        print(f"kernel time K={K} W={W}: {row['ms'] * 1e3:.2f} us "
              f"(eager {row['ms_eager'] * 1e3:.2f} us), plain "
              f"{row['plain_ms'] * 1e3:.2f} us (eager "
              f"{row['plain_ms_eager'] * 1e3:.2f} us), bound "
              f"{row['bound_ms'] * 1e3:.4f} us", flush=True)

    # -- 4. the main path: where a step's time goes, then the four runs
    prof = profile_segment(runs[0], golden, dev)
    print(f"trace {runs[0]['name']} first {prof['events']} events: "
          f"{prof['wall_us'] / prof['events']:.1f} us/event wall, device "
          f"busy {prof['device_busy_us'] / prof['events']:.1f} us/event, "
          f"idle share {prof['idle_share']}, "
          f"{prof['launches_per_event']:.1f} launches/event, "
          f"{prof['retire_iterations']} retire iterations, host in "
          f"device-to-host syncs {prof['sync_us'] / prof['events']:.1f} "
          f"us/event; top host ops (name, calls, self us): "
          f"{prof['top_host_ops']}; top device ops (name, calls, self us): "
          f"{prof['top_device_ops']}", flush=True)
    launches = {}
    for spec in runs:
        reqs, topo, net = main_inputs(spec)
        torch.cuda.synchronize()
        es_mod.event_select.launches = 0
        t0 = time.time()
        m = simulate(reqs, topo, policy=golden["policy"],
                     max_forwards=golden["max_forwards"],
                     capacity=spec["capacity"], depth=spec["depth"],
                     net=net, max_events=spec["max_events"], device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n_launch = es_mod.event_select.launches
        launches[spec["name"]] = n_launch
        R = int(m.total)
        print(f"main {spec['name']}: {R} requests, {m.events} events, "
              f"{wall:.2f} s, {m.events / wall:.1f} events/s, "
              f"{R / wall:.1f} requests/s, {m.retire_iterations} retire "
              f"iterations, {n_launch} event_select launches, "
              f"{int(m.forwards)} forwards, {int(m.met_deadline)} met",
              flush=True)
        for k, want in spec["aggregates"].items():
            if int(getattr(m, k)) != want:
                fail(f"{spec['name']} {k}: {int(getattr(m, k))} != {want}")
        for k, want in spec["digests"].items():
            if digest(getattr(m, k)) != want:
                fail(f"{spec['name']} per-request {k} differs from the "
                     "JAX reference")
        for k, want in spec["floats"].items():
            got = float(getattr(m, k))
            if not np.isfinite(got) or abs(got - want) > 1e-5 * abs(want):
                fail(f"{spec['name']} {k}: {got} vs {want}")
        if n_launch != m.events or m.events == 0:
            fail(f"{spec['name']}: {n_launch} event_select launches for "
                 f"{m.events} event steps")

    # -- 5. the records
    fleet = next(r for r in shapes if (r["K"], r["W"]) == (32, 512))
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [dict(
        name="event_select", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=sum(launches.values()),
        launches_by_run=launches, checked=True, max_abs_err=max_err,
        ms=fleet["ms"], plain_ms=fleet["plain_ms"],
        bound_ms=fleet["bound_ms"], bound_by="bytes", library_ms=None,
        shapes=shapes)]}), flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
