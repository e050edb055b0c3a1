"""Event-time fleet simulator in PyTorch (the port of
``repro/fleetsim/core.py``).

The whole fleet is held as stacked ``(num_nodes, capacity)`` head-pointer
ledger tensors next to per-node ``head``/``nq``/``busy``/``load``
vectors, and the run advances one *event* per step — the earlier of

* the next **fresh arrival**, streamed from the arrival-sorted request
  tensor through a cursor (fresh arrivals win every timestamp tie: the
  host heap numbers them before the run), and
* the head of the **re-arrival buffer**, a sorted device event queue
  (:func:`repro_torch.core.torch_queue.event_push` / ``event_pop``)
  holding every referral at its wire-delayed arrival time —

processed as a single hop: retire every completion due strictly before
the event, score the event's node (``batched_feasible`` scores the whole
fleet through the hand-written ``event_select`` kernel), route an
infeasible request and push its re-arrival at ``t + transfer_delay``,
then apply admission through the closed-form cascade ``insert_at`` and
record the terminal outcome.

Where JAX runs a ``lax.scan`` of ``max_events`` steps, this is a Python
loop that stops at the first step with no live event (every later step
would be a no-op), then drains the ledgers; events still pending at
``max_events`` count into ``event_overflow`` exactly as in the scan.
Each step makes one host read — the merge verdict, the buffer head's
identity and whether a completion is due — so the event's request, node
and hop are host ints from then on; the ``_retire`` loop reads its
condition once more per further iteration.  Everything that depends on
the ledgers (feasibility, routing, admission) stays on the device, and
its arithmetic follows the JAX step operation for operation, so
per-request outcomes match the reference exactly.

JAX's ``mode="drop"`` scatter of retired completions at index ``R``
becomes a write into a dump slot at ``R`` of the completion buffer,
sliced off at the end.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import torch_queue as tq
from repro_torch.device import DeviceLike
from repro_torch.fleetsim.arrays import (RequestArrays, TopologyArrays,
                                         event_bound, to_device)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.netsim.link import NetParams

POLICIES = ("random", "power_of_two", "least_loaded", "round_robin",
            "batched_feasible", "trace")

# outcome codes (per request)
PENDING, MET, LATE, DISCARDED, OVERFLOW = 0, 1, 2, 3, 4

_MET_EPS = 1e-9          # same slack as Request.met_deadline

# per-request terminal record, one int32: bits [0,8) forwards used, bit 8
# discarded, bit 9 overflow, bits [10,..) serving node + 1 (0 == none)
_INFO_DISC, _INFO_OVF, _INFO_SERVED = 1 << 8, 1 << 9, 10

I32 = torch.int32


class SimParams(NamedTuple):
    """Per-run parameters: the forwarding rng seed (read by the stochastic
    policies, not yet ported) and the SLA scale on relative deadlines."""
    seed: int = 0
    sla_scale: float = 1.0

    @classmethod
    def make(cls, seed: int = 0, sla_scale: float = 1.0) -> "SimParams":
        return cls(int(seed), float(sla_scale))


class EventState(NamedTuple):
    """Fleet ledgers + the event plane + per-request outcome buffers.
    Device scalars are (1,) tensors; ``cursor`` is read on the host."""
    # head-pointer ledgers: live blocks of node k occupy [head[k], +nq[k])
    starts: torch.Tensor               # (K, N) f32
    ends: torch.Tensor                 # (K, N) f32
    sizes: torch.Tensor                # (K, N) f32
    slot_rid: torch.Tensor             # (K, N) i32 request index per block
    head: torch.Tensor                 # (K,) i32 retired-slot count
    nq: torch.Tensor                   # (K,) i32 live block count
    busy: torch.Tensor                 # (K,) f32 time the CPU frees
    load: torch.Tensor                 # (K,) f32 pending ledger work
    rr: torch.Tensor                   # (1,) i32 round-robin pointer
    cursor: int                        # next fresh arrival index
    ev_time: torch.Tensor              # (B,) f32, +BIG past ev_n
    ev_rid: torch.Tensor               # (B,) i32 request index
    ev_meta: torch.Tensor              # (B,) i32 node << hop_bits | hops
    ev_n: torch.Tensor                 # (1,) i32 buffered event count
    ev_dropped: torch.Tensor           # (1,) i32 pushes lost to a full buffer
    sat_events: torch.Tensor           # (1,) i32 events that met a full window
    completion: torch.Tensor           # (R + 1,) f32, slot R is the dump
    reqinfo: torch.Tensor              # (R,) i32 packed terminal record
    transfer: torch.Tensor             # (R,) f32 wire time on referrals


class FleetMetrics(NamedTuple):
    """Headline aggregates + the per-request arrays they reduce, plus the
    host-side counts of the run (``events``: live event steps;
    ``retire_iterations``: ``_retire`` loop bodies, drain included)."""
    total: torch.Tensor
    processed: torch.Tensor
    met_deadline: torch.Tensor
    forwards: torch.Tensor
    discarded: torch.Tensor
    overflow: torch.Tensor           # forced pushes dropped: no free slot
    window_saturation: torch.Tensor  # events that consulted a full window
    mean_response_time: torch.Tensor
    end_time: torch.Tensor
    outcome: torch.Tensor
    completion: torch.Tensor
    served_by: torch.Tensor
    forwards_used: torch.Tensor
    transfer_time: torch.Tensor
    transfer_used: torch.Tensor
    event_overflow: torch.Tensor     # events dropped or left at max_events
    events: int
    retire_iterations: int

    @property
    def met_rate(self):
        return self.met_deadline / max(1, int(self.total))


class _Run(NamedTuple):
    """What stays fixed through one run."""
    topo: TopologyArrays
    policy: str
    max_forwards: int
    discard_on_exhaust: bool
    capacity: int
    depth: int
    R: int
    priced: bool
    lat: torch.Tensor                # (K, K), zeros for an unpriced run
    inv_bw: torch.Tensor
    cols: torch.Tensor               # (R, 4) f32 arrival, d_abs, proc, payload
    origin: torch.Tensor             # (R,) i32
    origin_h: list                   # the same, on the host
    degree_h: list                   # (K,) out-degrees, on the host
    targets_h: Optional[list]        # (R, M) recorded choices (trace)
    hop_bits: int
    row_base: torch.Tensor           # (K,) i64 k * N
    row_cols: torch.Tensor           # (K, W) i64 k * N + w
    cols_w: torch.Tensor             # (W,) i64
    ids_k: torch.Tensor              # (K,) i64
    yes: torch.Tensor                # (1,) True
    no: torch.Tensor                 # (1,) False


# ---------------------------------------------------------------------------
# fast-forward: retire completions due strictly before t (work-conserving
# pop chain), recording completion times by slot rid.  Also the drain.
# ---------------------------------------------------------------------------
def _due(state: EventState, t) -> torch.Tensor:
    return (state.busy < t) & (state.nq > 0)


def _pop_heads(state: EventState, mask: torch.Tensor,
               run: _Run) -> EventState:
    N = state.starts.shape[1]
    flat = run.row_base + torch.clamp(state.head, max=N - 1)
    head_size = state.sizes.view(-1)[flat]
    new_busy = torch.where(mask, state.busy + head_size, state.busy)
    rid = torch.where(mask, state.slot_rid.view(-1)[flat], run.R)

    # -BIG keeps the retired prefix below every live value, so the row
    # stays sorted and counts / prefix sums stay valid
    def clear(a, v):
        a.view(-1).index_put_((flat,), torch.where(mask, v, a.view(-1)[flat]))

    clear(state.starts, -tq.BIG)
    clear(state.ends, -tq.BIG)
    clear(state.sizes, 0.0)
    state.completion.index_put_((rid,), new_busy)
    m = mask.to(I32)
    return state._replace(head=state.head + m, nq=state.nq - m,
                          busy=new_busy,
                          load=state.load - torch.where(mask, head_size, 0.0))


def _retire(state: EventState, t, run: _Run, mask=None, due=None
            ) -> Tuple[EventState, int]:
    """Pop every head due before ``t``; returns (state, iterations).
    ``mask``/``due`` pass in a first check the caller already made."""
    if mask is None:
        mask = _due(state, t)
        due = bool(mask.any())
    iters = 0
    while due:
        state = _pop_heads(state, mask, run)
        iters += 1
        mask = _due(state, t)
        due = bool(mask.any())
    return state, iters


# ---------------------------------------------------------------------------
# routing policies, consulted at true event time
# ---------------------------------------------------------------------------
def _pick(row: torch.Tensor, i) -> torch.Tensor:
    """``row[i]`` as a (1,) tensor, for a host int or a (1,) index tensor."""
    return row[i:i + 1] if isinstance(i, int) else row.index_select(0, i)


def _route_next(run: _Run, load, cur: int, hop: int, rid: int, feas_all,
                rr):
    """Forwarding target of node ``cur`` at hop ``hop`` — a host int for
    ``trace``, else a (1,) i32 tensor; returns ``(next_node,
    advanced_rr)`` (callers commit ``advanced_rr`` only on a forward)."""
    policy = run.policy
    if policy == "trace":
        row = run.targets_h[rid]
        return max(row[min(hop, len(row) - 1)], 0), rr
    adj_row = run.topo.adj[cur]
    inf = float("inf")
    if policy == "round_robin":
        # stable-id pointer: probe rr, rr+1, ... (mod K), skip non-neighbors
        K = adj_row.shape[0]
        cands = (rr + run.ids_k) % K
        off = torch.argmax(adj_row[cands].to(torch.uint8), 0, keepdim=True)
        return cands.index_select(0, off).to(I32), ((rr + off + 1) % K).to(I32)
    if policy == "least_loaded":
        # ties go to the lowest node id (argmin returns the first minimum)
        return torch.argmin(torch.where(adj_row, load, inf), 0,
                            keepdim=True).to(I32), rr
    if policy == "batched_feasible":
        # least-loaded neighbor that can still admit (the kernel's mask),
        # least-loaded neighbor when none can; ties to the lowest id
        ok = adj_row & feas_all
        best_ok = torch.argmin(torch.where(ok, load, inf), 0, keepdim=True)
        best_any = torch.argmin(torch.where(adj_row, load, inf), 0,
                                keepdim=True)
        return torch.where(ok.any(0, keepdim=True), best_ok,
                           best_any).to(I32), rr
    raise ValueError(f"fleetsim policy {policy!r} is not routed here")


# ---------------------------------------------------------------------------
# one event end to end; None when no event is live
# ---------------------------------------------------------------------------
def _estep(state: EventState, run: _Run
           ) -> Optional[Tuple[EventState, int]]:
    R, W, N, hb = run.R, run.depth, run.capacity, run.hop_bits
    topo = run.topo

    # -- the two candidate events: next fresh arrival vs re-arrival head.
    # Fresh arrivals win timestamp ties (the host heap numbers them first)
    ci = state.cursor
    avail_a = ci < R
    ca = min(ci, R - 1)
    fa = run.cols[ca]                        # arrival, d_abs, proc, payload
    t_b, meta_b0 = state.ev_time[:1], state.ev_meta[:1]
    avail_b = state.ev_n > 0
    if avail_a:
        take_fresh = (fa[:1] <= t_b) | ~avail_b
        t = torch.where(take_fresh, fa[:1], t_b)
    else:
        take_fresh, t = run.no, t_b
    due = _due(state, t)
    # the step's one host read: the merge verdict, the buffer head's
    # identity, and whether a completion is due before the event — the
    # event's identity (request, node, hop) is then known on the host
    take_h, avail_b_h, due_h, rid_b, meta_b = torch.cat([
        take_fresh, avail_b, due.any(0, keepdim=True), state.ev_rid[:1],
        meta_b0]).tolist()
    if not (avail_a or avail_b_h):
        return None
    if take_h:
        rid, cur, hops = ci, run.origin_h[ci], 0
        state = state._replace(cursor=ci + 1)
    else:
        rid, cur, hops = rid_b, meta_b >> hb, meta_b & ((1 << hb) - 1)
        ev_time, (ev_rid, ev_meta), ev_n = tq.event_pop(
            state.ev_time, (state.ev_rid, state.ev_meta), state.ev_n, run.yes)
        state = state._replace(ev_time=ev_time, ev_rid=ev_rid,
                               ev_meta=ev_meta, ev_n=ev_n)
    row = run.cols[rid]
    d, p, pay = row[1:2], row[2:3], row[3:4]

    # -- retire completions due strictly before the event; everything
    # below, the fused scoring included, sees the post-retire ledgers
    state, retired = _retire(state, t, run, due, due_h)
    busy_c = state.busy[cur:cur + 1]      # a view: read before the writes
    cpu_free_c = torch.maximum(t, busy_c)
    ps_c = p / topo.speeds[cur:cur + 1]

    feas_all = None
    if run.policy == "batched_feasible":
        # the whole fleet's live windows scored in one kernel launch; the
        # kernel re-derives the merge from the same candidate scalars and
        # agrees with the host read above
        w0_all = torch.clamp(state.head, 0, N - W)
        cols = w0_all[:, None] + run.cols_w
        win_all = lambda a: torch.gather(a, 1, cols)
        rb = run.cols[rid_b]
        sel = kops.event_select(
            fa[0:1], run.origin[ca:ca + 1], fa[1:2], fa[2:3], fa[3:4],
            run.yes if avail_a else run.no,
            t_b, meta_b0 >> hb, rb[1:2], rb[2:3], rb[3:4], avail_b,
            win_all(state.starts), win_all(state.ends), win_all(state.sizes),
            state.nq, state.head - w0_all, topo.speeds, state.busy,
            run.lat, run.inv_bw)
        feas_all, j_all, cap_all = sel[3], sel[5], sel[6]

    # -- admission test at the event's node, over its live window
    head_c = state.head[cur:cur + 1]
    w0c = torch.clamp(head_c, 0, N - W)
    hrel_c = head_c - w0c
    flat = run.row_cols[cur] + w0c

    def win_row(buf):
        return buf.view(-1)[flat]

    starts_w, ends_w, sizes_w = (win_row(state.starts), win_row(state.ends),
                                 win_row(state.sizes))
    nq_c = state.nq[cur:cur + 1]
    if feas_all is not None:
        ok, j, cap = (feas_all[cur:cur + 1], j_all[cur:cur + 1],
                      cap_all[cur:cur + 1])
    else:
        ok, j, cap, _ = kref.fleet_search_ref(
            starts_w[None], ends_w[None], sizes_w[None], nq_c, ps_c, d,
            cpu_free_c, hrel_c)

    # -- decide: forward while hops remain, else force or discard
    fwd = forced_req = disc_evt = None
    if hops < run.max_forwards and run.degree_h[cur] > 0:
        fwd = ~ok
    elif run.discard_on_exhaust:
        disc_evt = ~ok
    else:
        forced_req = ~ok

    # -- forward: pick the target now and defer the re-arrival to
    # t + transfer_delay through a stable sorted insert
    if fwd is not None:
        nxt, rr_adv = _route_next(run, state.load, cur, hops, rid, feas_all,
                                  state.rr)
        key = t
        if run.priced:
            # latency + payload · inv_bw, fused as the reference compiles it
            delay = kref.fma32(pay, _pick(run.inv_bw[cur], nxt),
                               _pick(run.lat[cur], nxt))
            key = t + delay
        ev_time, (ev_rid, ev_meta), ev_n, dropped = tq.event_push(
            state.ev_time, (state.ev_rid, state.ev_meta), state.ev_n, key,
            (rid, (nxt << hb) | (hops + 1)), fwd)
        state = state._replace(ev_time=ev_time, ev_rid=ev_rid,
                               ev_meta=ev_meta, ev_n=ev_n,
                               ev_dropped=state.ev_dropped + dropped.to(I32))
        if run.policy == "round_robin":
            state = state._replace(rr=torch.where(fwd, rr_adv, state.rr))

    # -- apply at cur, within its window (torch_queue.insert_at)
    fill = hrel_c + nq_c
    room = fill < W
    forced_ok = run.no if forced_req is None else forced_req & room
    sat_evt = fill >= W      # a full live window may diverge from the host
    idle = busy_c < t
    sr_w = win_row(state.slot_rid)
    n_starts, n_ends, n_sizes, admitted, (n_sr,) = tq.insert_at(
        starts_w, ends_w, sizes_w, hrel_c, nq_c, ok, forced_ok, j, cap, ps_c,
        cpu_free_c, meta=(sr_w,), meta_vals=(rid,))
    # idle CPU: the host pushes then immediately pops — the request starts
    # at its (wire-delayed) arrival and never enters the ledger
    start_now = admitted & idle
    queue_it = admitted & ~idle
    c_now = t + ps_c

    def put(buf, new, old):
        buf.view(-1).index_put_((flat,), torch.where(queue_it, new, old))

    put(state.starts, n_starts, starts_w)
    put(state.ends, n_ends, ends_w)
    put(state.sizes, n_sizes, sizes_w)
    put(state.slot_rid, n_sr, sr_w)

    # -- the packed terminal record and the per-node / per-request writes
    terminal = admitted
    info = admitted.to(I32) * ((cur + 1) << _INFO_SERVED) + hops
    if disc_evt is not None:
        terminal = terminal | disc_evt
        info = info + disc_evt.to(I32) * _INFO_DISC
    if forced_req is not None:
        ovf_evt = forced_req & ~room
        terminal = terminal | ovf_evt
        info = info + ovf_evt.to(I32) * _INFO_OVF
    r1 = slice(rid, rid + 1)
    state.reqinfo[r1] = torch.where(terminal, info, state.reqinfo[r1])
    state.completion[r1] = torch.where(start_now, c_now, state.completion[r1])
    if fwd is not None and run.priced:
        state.transfer[r1] += torch.where(fwd, delay, 0.0)
    c1 = slice(cur, cur + 1)
    state.nq[c1] += queue_it.to(I32)
    state.load[c1] += torch.where(queue_it, ps_c, 0.0)
    state.busy[c1] = torch.where(start_now, c_now, busy_c)
    state.sat_events.add_(sat_evt.to(I32))
    return state, retired


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def _simulate(reqs: RequestArrays, topo: TopologyArrays, params: SimParams,
              targets: torch.Tensor, net: Optional[NetParams], *,
              policy: str, max_forwards: int, discard_on_exhaust: bool,
              capacity: int, depth: int, max_events: Optional[int],
              event_buf: Optional[int]) -> FleetMetrics:
    R = reqs.arrival.shape[0]
    K = topo.speeds.shape[0]
    N = capacity
    dev = reqs.arrival.device
    f32 = torch.float32
    E = event_bound(R, max_forwards) if max_events is None else max_events
    B = min(R, 1024) if event_buf is None else event_buf
    hop_bits = max(max_forwards + 1, 2).bit_length()
    one_i = lambda: torch.zeros((1,), dtype=I32, device=dev)
    state = EventState(
        starts=torch.full((K, N), tq.BIG, dtype=f32, device=dev),
        ends=torch.full((K, N), tq.BIG, dtype=f32, device=dev),
        sizes=torch.zeros((K, N), dtype=f32, device=dev),
        slot_rid=torch.zeros((K, N), dtype=I32, device=dev),
        head=torch.zeros((K,), dtype=I32, device=dev),
        nq=torch.zeros((K,), dtype=I32, device=dev),
        busy=torch.zeros((K,), dtype=f32, device=dev),
        load=torch.zeros((K,), dtype=f32, device=dev),
        rr=one_i(), cursor=0,
        ev_time=torch.full((B,), tq.BIG, dtype=f32, device=dev),
        ev_rid=torch.zeros((B,), dtype=I32, device=dev),
        ev_meta=torch.zeros((B,), dtype=I32, device=dev),
        ev_n=one_i(), ev_dropped=one_i(), sat_events=one_i(),
        completion=torch.zeros((R + 1,), dtype=f32, device=dev),
        reqinfo=torch.zeros((R,), dtype=I32, device=dev),
        transfer=torch.zeros((R,), dtype=f32, device=dev),
    )
    d_abs = kref.fma32(reqs.rel_deadline,
                       torch.full_like(reqs.arrival, params.sla_scale),
                       reqs.arrival)
    payload = (reqs.payload if reqs.payload is not None
               else torch.zeros_like(reqs.arrival))
    zero_net = torch.zeros((K, K), dtype=f32, device=dev)
    row_base = torch.arange(K, device=dev) * N
    cols_w = torch.arange(depth, device=dev)
    run = _Run(
        topo=topo, policy=policy, max_forwards=max_forwards,
        discard_on_exhaust=discard_on_exhaust, capacity=capacity,
        depth=depth, R=R, priced=net is not None,
        lat=zero_net if net is None else net.latency,
        inv_bw=zero_net if net is None else net.inv_bw,
        cols=torch.stack([reqs.arrival, d_abs, reqs.proc, payload], dim=1),
        origin=reqs.origin, origin_h=reqs.origin.tolist(),
        degree_h=topo.degree.tolist(),
        targets_h=targets.tolist() if policy == "trace" else None,
        hop_bits=hop_bits, row_base=row_base,
        row_cols=row_base[:, None] + cols_w, cols_w=cols_w,
        ids_k=torch.arange(K, device=dev),
        yes=torch.ones((1,), dtype=torch.bool, device=dev),
        no=torch.zeros((1,), dtype=torch.bool, device=dev))

    events = retire_iters = 0
    for _ in range(E):
        out = _estep(state, run)
        if out is None:
            break
        state, it = out
        events += 1
        retire_iters += it
    unprocessed = (R - state.cursor) + state.ev_n
    state, it = _retire(state, float("inf"), run)            # drain
    retire_iters += it

    info = state.reqinfo
    completion = state.completion[:R]
    transfer = state.transfer
    nfwd = info & ((1 << 8) - 1)
    disc = (info & _INFO_DISC) != 0
    ovf = (info & _INFO_OVF) != 0
    served_by = (info >> _INFO_SERVED) - 1
    has_c = completion > 0
    met = has_c & (completion <= d_abs + _MET_EPS)
    outcome = torch.where(
        disc, DISCARDED,
        torch.where(ovf, OVERFLOW,
                    torch.where(met, MET, torch.where(has_c, LATE, PENDING))
                    )).to(I32)
    n_proc = has_c.sum(dtype=I32)
    resp = torch.where(has_c, completion - reqs.arrival, 0.0).sum()
    end_time = torch.maximum(completion.amax().clamp(min=0.0),
                             reqs.arrival.amax().clamp(min=0.0))
    return FleetMetrics(
        total=torch.tensor(R, dtype=I32, device=dev),
        processed=n_proc,
        met_deadline=met.sum(dtype=I32),
        forwards=nfwd.sum(dtype=I32),
        discarded=disc.sum(dtype=I32),
        overflow=ovf.sum(dtype=I32),
        window_saturation=state.sat_events.reshape(()),
        mean_response_time=resp / torch.clamp(n_proc, min=1),
        end_time=end_time,
        outcome=outcome,
        completion=completion,
        served_by=served_by,
        forwards_used=nfwd,
        transfer_time=transfer.sum(),
        transfer_used=transfer,
        event_overflow=(state.ev_dropped + unprocessed).reshape(()),
        events=events,
        retire_iterations=retire_iters,
    )


def simulate(reqs: RequestArrays, topo: TopologyArrays,
             params: Optional[SimParams] = None, *,
             policy: str = "batched_feasible", max_forwards: int = 2,
             discard_on_exhaust: bool = False, capacity: int = 256,
             depth: Optional[int] = None, targets=None,
             net: Optional[NetParams] = None,
             max_events: Optional[int] = None,
             event_buf: Optional[int] = None,
             telemetry=None, device: DeviceLike = None) -> FleetMetrics:
    """Run the fleet simulation on ``device`` (``None`` means CUDA, and
    raises without it; ``"cpu"`` runs the kernels' plain versions).

    Same contract as ``repro.fleetsim.simulate``: ``reqs``/``topo`` are
    the packed arrays of :mod:`repro_torch.fleetsim.arrays` (or the JAX
    package's, numpy or tensors); ``capacity`` is the per-node slot count
    (a block keeps its slot for the whole run, so size it at the node's
    total admissions), ``depth`` the live-window width the per-step math
    runs over, ``max_events`` the step bound (default ``R *
    (max_forwards + 1)``) and ``event_buf`` the re-arrival buffer
    (default ``min(R, 1024)``).  Undersizing is never silent: see
    ``overflow``, ``window_saturation`` and ``event_overflow``.
    ``targets`` replays recorded forwarding choices (``policy="trace"``,
    shape (R, max_forwards)); ``net`` prices every referral hop
    ``latency[u, v] + payload · inv_bw[u, v]``.

    The default policy is ``batched_feasible`` — the main path, scored
    by the ``event_select`` kernel.  Not yet ported (ROADMAP.md, open
    items): ``random``/``power_of_two`` (item 1, bit-exact threefry) and
    ``telemetry`` (item 2).
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown fleetsim policy {policy!r}; "
                         f"options: {sorted(POLICIES)}")
    if policy in ("random", "power_of_two"):
        raise NotImplementedError(
            f"policy {policy!r} draws from jax.random's threefry stream; the "
            "port needs a bit-exact threefry first (ROADMAP.md open item 1)")
    if telemetry is not None:
        raise NotImplementedError("telemetry is not ported yet (ROADMAP.md "
                                  "open item 2)")
    if max_forwards >= (1 << 8):
        raise ValueError("max_forwards must be < 256 (packed terminal "
                         f"record), got {max_forwards}")
    if net is not None and reqs.payload is None:
        raise ValueError("net= requires RequestArrays.payload (pass "
                         "payload=zeros for a latency-only network)")
    reqs, topo, net = to_device(reqs, topo, net, device)
    R = reqs.arrival.shape[0]
    if R == 0:
        raise ValueError("simulate needs at least one request")
    dev = reqs.arrival.device
    if targets is None:
        targets = torch.full((R, max(max_forwards, 1)), -1, dtype=I32,
                             device=dev)
    else:
        targets = torch.as_tensor(targets, dtype=I32, device=dev)
    depth = capacity if depth is None else min(depth, capacity)
    return _simulate(reqs, topo, params or SimParams.make(), targets, net,
                     policy=policy, max_forwards=max_forwards,
                     discard_on_exhaust=discard_on_exhaust,
                     capacity=capacity, depth=depth, max_events=max_events,
                     event_buf=event_buf)


def simulate_fn(**_):
    """The JAX package's vmappable entry point; the port will take an
    explicit leading cell axis instead (ROADMAP.md open item 3)."""
    raise NotImplementedError("simulate_fn (sweeps over a leading cell "
                              "axis) is not ported yet (ROADMAP.md open "
                              "item 3)")
