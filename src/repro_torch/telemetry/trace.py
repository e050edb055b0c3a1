"""Host trace export: the event heap's hook stream as a Chrome trace,
plus the same time-binned :class:`~repro_torch.telemetry.summary.
TelemetrySummary` the fleet run produces (the port's copy of
``repro/telemetry/trace.py``, over the port's
:class:`~repro_torch.orchestration.orchestrator.Hooks`).

:class:`TraceRecorder` plugs into the existing hooks — no orchestrator
changes — and records every admit / forward / discard / complete with
its node and timestamp.  From that stream it emits:

* **Chrome-trace-event JSON** (:meth:`TraceRecorder.chrome_trace`,
  viewable at https://ui.perfetto.dev): one track per MEC node, with a
  ``queue`` span (admission -> execution start), a ``serve`` span
  (execution -> completion), a ``wire`` span per referral hop (forward
  -> wire-delayed re-arrival) and instant markers for discards.  Times
  are the simulator's abstract UT rendered as microseconds.  The export
  is the reference's, field for field.
* **the telemetry summary** (:meth:`TraceRecorder.summary`) — binned
  identically to the device cube.  Event times are *re-derived* as the
  same f32 chain the fleet run computes (``t_0 = f32(arrival)``,
  ``t_{h+1} = f32(t_h + delay)`` with the delay ``lat + payload ·
  inv_bw`` as ONE fused multiply-add from the f32 NetParams tensors, as
  the eager loop, ``event_scan`` and the reference's compiled scan
  round it), and binned as the fleet run bins (``t · f32(1 / w)``,
  :mod:`~repro_torch.telemetry.timeline`), so bucket indices match the
  fleet run bit for bit and the counter / occupancy comparison in
  fleetsim/validate.py ``--telemetry`` is exact, not approximate
  (DESIGN.md §8).

The recorder chains user hooks: pass ``hooks=`` your own and both run.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import fma32
from repro_torch.orchestration.orchestrator import Hooks
from repro_torch.telemetry.summary import TelemetrySummary
from repro_torch.telemetry.timeline import (KIND_ARRIVAL, KIND_DISCARD,
                                            KIND_FORWARD, KIND_REARRIVAL,
                                            KIND_SERVE, N_KINDS,
                                            bucket_width,
                                            interval_histogram_np,
                                            reciprocal)


@dataclasses.dataclass
class _Hop:
    src: int
    dst: int
    now: float                   # host (f64) forward time, for the trace
    payload: float               # MB, for the f32 wire-delay mirror


@dataclasses.dataclass
class _Terminal:
    kind: str                    # "serve" | "discard"
    node: int
    now: float
    forced: bool = False


class TraceRecorder:
    """Record the orchestrator's decision stream through its hooks.

    ``network`` (the same :class:`repro_torch.netsim.LinkModel` the
    orchestrator runs under, or None) prices the wire spans and the f32
    re-arrival chain; ``forward_delay`` mirrors the orchestrator's fixed
    per-hop delay.  ``hooks`` chains an existing Hooks object.
    """

    def __init__(self, network=None, forward_delay: float = 0.0,
                 hooks: Optional[Hooks] = None):
        self.network = network
        self.forward_delay = float(forward_delay)
        self._chained = hooks or Hooks()
        self.hops: Dict[int, List[_Hop]] = {}          # rid -> ordered hops
        self.forward_order: List[Tuple[int, int]] = []  # (rid, hop) push order
        self.terminal: Dict[int, _Terminal] = {}
        self.completions: Dict[int, Tuple[int, float]] = {}  # rid -> (node, t)
        if network is not None:
            np_net = network.net_params()
            self._lat32 = np.asarray(np_net.latency, np.float32)
            self._ibw32 = np.asarray(np_net.inv_bw, np.float32)
        else:
            self._lat32 = self._ibw32 = None
        self._fused: Dict[Tuple[int, int, float], np.float32] = {}

    # -- hook plumbing -------------------------------------------------------
    @property
    def hooks(self) -> Hooks:
        """The Hooks object to hand the Orchestrator."""
        return Hooks(on_admit=self._on_admit, on_forward=self._on_forward,
                     on_discard=self._on_discard,
                     on_complete=self._on_complete)

    def _on_admit(self, req, node, now, forced):
        self.terminal[req.rid] = _Terminal("serve", node.node_id, now, forced)
        if self._chained.on_admit:
            self._chained.on_admit(req, node, now, forced)

    def _on_forward(self, req, src, dst, now):
        hops = self.hops.setdefault(req.rid, [])
        self.forward_order.append((req.rid, len(hops)))
        payload = (self.network.payload_of(req.service)
                   if self.network is not None else 0.0)
        hops.append(_Hop(src.node_id, dst.node_id, now, payload))
        if self._chained.on_forward:
            self._chained.on_forward(req, src, dst, now)

    def _on_discard(self, req, node, now):
        self.terminal[req.rid] = _Terminal("discard", node.node_id, now)
        if self._chained.on_discard:
            self._chained.on_discard(req, node, now)

    def _on_complete(self, req, node, now):
        self.completions[req.rid] = (node.node_id, now)
        if self._chained.on_complete:
            self._chained.on_complete(req, node, now)

    # -- the f32 event-time mirror (DESIGN.md §8) ---------------------------
    def _delay32(self, hop: _Hop) -> np.float32:
        """One hop's wire delay, evaluated exactly as the fleet run does:
        ``fma(payload, inv_bw, base + lat)``, one rounding, from the f32
        NetParams (memoised per edge and payload)."""
        base = np.float32(self.forward_delay)
        if self._lat32 is None:
            return base
        key = (hop.src, hop.dst, hop.payload)
        got = self._fused.get(key)
        if got is None:
            f = lambda x: torch.tensor([x], dtype=torch.float32)
            got = self._fused[key] = np.float32(fma32(
                f(np.float32(hop.payload)), f(self._ibw32[hop.src, hop.dst]),
                f(np.float32(base + self._lat32[hop.src, hop.dst])))[0])
        return got

    def _span32(self, hop: _Hop) -> np.float32:
        """A wire span's width in the Chrome trace: the reference's
        ``f32(lat + f32(payload * inv_bw))``, two roundings, so the export
        equals the reference's; at most an ulp from :meth:`_delay32`."""
        base = np.float32(self.forward_delay)
        if self._lat32 is None:
            return base
        return np.float32(base + self._lat32[hop.src, hop.dst]
                          + np.float32(hop.payload)
                          * self._ibw32[hop.src, hop.dst])

    def event_chain(self, req) -> Tuple[List[np.float32], np.float32]:
        """Per-hop f32 event times of one request: ``[t_0 .. t_H]`` (the
        arrival and every re-arrival) plus the f32 sum of wire delays —
        the exact values the fleet run binned and accumulated."""
        t = np.float32(req.arrival_time)
        times = [t]
        dsum = np.float32(0.0)
        for hop in self.hops.get(req.rid, ()):
            d = self._delay32(hop)
            t = np.float32(t + d)
            dsum = np.float32(dsum + d)
            times.append(t)
        return times, dsum

    # -- Chrome trace export -------------------------------------------------
    def chrome_trace(self, requests: Optional[Sequence] = None,
                     topology=None) -> dict:
        """The run as Chrome-trace-event JSON (Perfetto-viewable).

        One ``pid`` per MEC node; per node a ``strategy`` track with the
        queue/serve spans and instants, and a ``wire`` track with the
        referral spans ending at each hop's re-arrival.  ``requests``
        splits the queue span from the serve span (start = completion −
        proc/speed, with ``topology`` supplying node speeds); without it
        the serve span covers admission to completion.
        """
        ev: List[dict] = []
        nodes = set()
        proc = {}
        if requests is not None:
            for r in requests:
                proc[r.rid] = r.service.proc_time

        def track(pid: int, tid: int, name: str):
            nodes.add(pid)
            ev.append(dict(ph="M", pid=pid, tid=tid, name="thread_name",
                           args=dict(name=name)))

        seen_tracks = set()

        def span(pid, tid, tname, name, ts, dur, args=None):
            if (pid, tid) not in seen_tracks:
                seen_tracks.add((pid, tid))
                track(pid, tid, tname)
            ev.append(dict(ph="X", pid=pid, tid=tid, name=name,
                           ts=float(ts), dur=float(max(dur, 0.0)),
                           cat="mec", args=args or {}))

        def instant(pid, tid, tname, name, ts, args=None):
            if (pid, tid) not in seen_tracks:
                seen_tracks.add((pid, tid))
                track(pid, tid, tname)
            ev.append(dict(ph="i", pid=pid, tid=tid, name=name,
                           ts=float(ts), s="t", cat="mec",
                           args=args or {}))

        for rid, term in self.terminal.items():
            if term.kind == "discard":
                instant(term.node, 0, "strategy", f"discard r{rid}",
                        term.now, dict(rid=rid))
                continue
            node, t_admit = term.node, term.now
            done = self.completions.get(rid)
            if done is None:
                continue
            _, t_done = done
            t_start = t_admit
            if rid in proc:
                spd = topology.speed(node) if topology is not None else 1.0
                t_start = max(t_admit, t_done - proc[rid] / spd)
            if t_start > t_admit:
                span(node, 0, "strategy", f"queue r{rid}", t_admit,
                     t_start - t_admit, dict(rid=rid))
            span(node, 0, "strategy", f"serve r{rid}", t_start,
                 t_done - t_start, dict(rid=rid, forced=term.forced))
        for rid, hops in self.hops.items():
            for h, hop in enumerate(hops):
                dur = float(self._span32(hop))
                span(hop.src, 1, "wire", f"fwd r{rid}.h{h}", hop.now, dur,
                     dict(rid=rid, dst=hop.dst))
        for pid in sorted(nodes):
            ev.append(dict(ph="M", pid=pid, name="process_name",
                           args=dict(name=f"mec-node-{pid}")))
            ev.append(dict(ph="M", pid=pid, name="process_sort_index",
                           args=dict(sort_index=pid)))
        return dict(traceEvents=ev, displayTimeUnit="ms",
                    # the reference's tag: the export equals its, key for key
                    otherData=dict(generator="repro.telemetry",
                                   time_unit="UT-as-us"))

    def write(self, path: str, requests: Optional[Sequence] = None,
              topology=None) -> dict:
        """Serialize :meth:`chrome_trace` to ``path``; returns the dict."""
        trace = self.chrome_trace(requests, topology)
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace

    # -- the time-binned summary --------------------------------------------
    def summary(self, requests: Sequence, topology, n_buckets: int,
                horizon: float) -> TelemetrySummary:
        """The host run binned exactly like the device telemetry cube.

        ``requests`` is the workload the orchestrator ran (fresh-arrival
        times and services); ``topology`` supplies node count and speeds
        for the busy/depth intervals.  Counter and occupancy binning
        replays the f32 event chain (see module docstring), so against a
        device run with ``TelemetryConfig(n_buckets, horizon)`` the
        integer halves of the summary agree exactly.
        """
        K = topology.n_nodes
        w = bucket_width(horizon, n_buckets)
        counts = np.zeros((K, n_buckets, N_KINDS), np.int32)
        nb1 = n_buckets - 1

        inv_w = reciprocal(w)

        def bucket(t32) -> int:
            return min(int(np.float32(t32) * inv_w), nb1)

        # fresh arrivals + per-hop chains: counters
        chains: Dict[int, List[np.float32]] = {}
        dsums: Dict[int, np.float32] = {}
        for r in requests:
            times, dsum = self.event_chain(r)
            chains[r.rid] = times
            dsums[r.rid] = dsum
            counts[r.origin_node, bucket(times[0]), KIND_ARRIVAL] += 1
            for h, hop in enumerate(self.hops.get(r.rid, ())):
                counts[hop.src, bucket(times[h]), KIND_FORWARD] += 1
                counts[hop.dst, bucket(times[h + 1]), KIND_REARRIVAL] += 1
            term = self.terminal.get(r.rid)
            if term is not None:
                kind = KIND_SERVE if term.kind == "serve" else KIND_DISCARD
                counts[term.node, bucket(times[-1]), kind] += 1

        # occupancy high water: replay arrival events in the fleet run's
        # merge order — fresh (heap-preloaded, lowest seqs) win timestamp
        # ties, re-arrivals order by (time, push order) — sampling the
        # in-flight referral count after each event, exactly where the
        # scan samples ev_n
        events: List[Tuple[np.float32, int, int, int, int]] = []
        fwd_seq = {pair: s for s, pair in enumerate(self.forward_order)}
        for i, r in enumerate(requests):
            events.append((chains[r.rid][0], 0, i, r.rid, 0))
        for (rid, h), s in fwd_seq.items():
            events.append((chains[rid][h + 1], 1, s, rid, h + 1))
        events.sort(key=lambda e: (e[0], e[1], e[2]))
        occ_hwm = np.zeros((n_buckets,), np.int32)
        occ = 0
        for t, cls, _, rid, hop in events:
            if cls == 1:
                occ -= 1                       # the re-arrival pops its event
            if (rid, hop) in fwd_seq:
                occ += 1                       # ... and may push the next one
            b = bucket(t)
            occ_hwm[b] = max(occ_hwm[b], occ)

        # derived integrals from the terminal intervals, f32 like the device
        served, admit_t, start_t, done_t, node = [], [], [], [], []
        for r in requests:
            term = self.terminal.get(r.rid)
            comp = self.completions.get(r.rid)
            if term is None or term.kind != "serve" or comp is None:
                continue
            k, t_done = comp
            ps = np.float32(np.float32(r.service.proc_time)
                            / np.float32(topology.speed(k)))
            a32 = np.float32(np.float32(r.arrival_time) + dsums[r.rid])
            c32 = np.float32(t_done)
            served.append(True)
            admit_t.append(a32)
            start_t.append(np.float32(c32 - ps))
            done_t.append(c32)
            node.append(k)
        valid = np.asarray(served, bool) if served else np.zeros((0,), bool)
        admit_t = np.asarray(admit_t, np.float32)
        start_t = np.asarray(start_t, np.float32)
        done_t = np.asarray(done_t, np.float32)
        node = np.asarray(node, np.int32) if node else np.zeros((0,), np.int32)
        depth = interval_histogram_np(admit_t, start_t, node, valid, K, w,
                                      n_buckets) * inv_w
        busy = interval_histogram_np(start_t, done_t, node, valid, K, w,
                                     n_buckets)
        return TelemetrySummary(counts=counts, queue_depth=depth,
                                busy_time=busy, occupancy_hwm=occ_hwm,
                                bucket_width=float(w),
                                horizon=float(horizon))


# ---------------------------------------------------------------------------
# Chrome-trace schema validation (CI's telemetry smoke job)
# ---------------------------------------------------------------------------
_PHASES_WITH_DUR = {"X"}
_KNOWN_PHASES = {"X", "i", "M", "B", "E"}


def validate_chrome_trace(trace: dict) -> int:
    """Structural check of a Chrome-trace-event JSON object.

    Raises ``ValueError`` on the first violation; returns the number of
    trace events otherwise.  Covers the subset the recorder emits (and
    Perfetto requires): a ``traceEvents`` list whose entries carry a
    known ``ph``, a ``pid``, a numeric non-negative ``ts`` for timed
    phases, and a numeric non-negative ``dur`` for complete events.
    """
    if not isinstance(trace, dict):
        raise ValueError(f"trace must be a dict, got {type(trace).__name__}")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace['traceEvents'] must be a list")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = e.get("ph")
        if ph not in _KNOWN_PHASES:
            raise ValueError(f"traceEvents[{i}] has unknown ph={ph!r}")
        if "pid" not in e:
            raise ValueError(f"traceEvents[{i}] missing pid")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"traceEvents[{i}] bad ts={ts!r}")
            if "name" not in e:
                raise ValueError(f"traceEvents[{i}] missing name")
        if ph in _PHASES_WITH_DUR:
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}] bad dur={dur!r}")
    return len(events)
