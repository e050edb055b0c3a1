"""A profiled slice of a run, reduced to what the per-layer metrics read.

On a CUDA device ``torch.profiler`` records the device's activity alone
(kernels, copies, fills, and the CUDA calls the host makes), not the
host's operators (on the CPU, only those); the slice's length is taken
by the host's clock around it.  The tracing slows the host, not the
device's operations.  From
the raw events (no per-event Python objects are built) come: the
device's busy seconds (the union of its operations' intervals), the
device seconds of each operation's name, and each idle gap of the
device between the slice's first and last event, named by the innermost
CUDA call open at its middle (none open: the host's own Python, the
engine's between batches).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

OUTSIDE = "host, outside CUDA calls"
TOP = 10


def profile(fn: Callable[[], None], cuda: bool):
    """Run ``fn`` under the profiler; return the events and the slice's
    wall seconds (``fn`` and the device's last work, host clock)."""
    import torch
    from torch.profiler import ProfilerActivity
    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act]) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.profiler.kineto_results.events(), wall


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events, wall_s: float) -> dict:
    """``window_s`` (``wall_s``), ``busy_s``, ``device_s`` (seconds by
    operation name), and ``device_ops`` and ``idle_gaps`` (the largest,
    by name, at most ten each)."""
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in events:
        if e.is_user_annotation():
            continue
        a = e.start_ns()
        iv = (a, a + e.duration_ns(), e.name())
        (host if e.device_type().name == "CPU" else dev).append(iv)
    busy = _union([(a, b) for a, b, _ in dev])
    device_s: Dict[str, float] = {}
    for a, b, n in dev:
        device_s[n] = device_s.get(n, 0.0) + (b - a) * 1e-9
    gaps: Dict[str, float] = {}
    host.sort()
    ivs = dev + host
    edges = [min(a for a, _, _ in ivs)] if ivs else []
    edges += [t for iv in busy for t in iv]
    edges += [max(b for _, b, _ in ivs)] if ivs else []
    opened: List[Tuple[int, int, str]] = []
    nxt = 0
    for a, b in zip(edges[0::2], edges[1::2]):      # in time order
        if b <= a:
            continue
        mid = (a + b) // 2
        while nxt < len(host) and host[nxt][0] <= mid:
            opened.append(host[nxt])
            nxt += 1
        opened = [h for h in opened if h[1] >= mid]
        # the latest to open is the innermost
        name = opened[-1][2] if opened else OUTSIDE
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9
    return dict(window_s=wall_s,
                busy_s=sum(b - a for a, b in busy) * 1e-9,
                device_s=device_s,
                device_ops=_top(device_s), idle_gaps=_top(gaps))


def _top(by_name: Dict[str, float]) -> List[list]:
    return [[n[:160], s] for n, s in
            sorted(by_name.items(), key=lambda x: -x[1])[:TOP]]
