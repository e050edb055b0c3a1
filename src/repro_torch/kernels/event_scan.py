"""Wrapper of the Hopper ``event_scan`` kernel (``csrc/event_scan.cu``): a
whole event-time fleet simulation, or a sweep of C of them, in one launch.

The kernel replaces the TPU kernel ``repro/kernels/event_select.py``
together with the reference's ``lax.scan`` over ``_estep``
(``repro/fleetsim/core.py``), the threefry draws of its ``random`` and
``power_of_two`` routing included (``csrc/threefry.cuh``), the carried
half of its telemetry cube and the ``vmap`` of ``simulate_fn`` over
sweep cells (one block a cell); its plain version is the eager per-event
loop of :mod:`repro_torch.fleetsim.core` (with
:mod:`repro_torch.fleetsim.rng` for the draws), one cell after another.
This wrapper checks shape, dtype, device and contiguity, allocates the
final ``EventState`` tensors, the telemetry cube and the counts with
``torch.empty`` (the kernel writes them whole, the initial state
included), launches on PyTorch's current stream and raises on a refused
launch.  It never synchronises and never falls back: a CPU tensor is
refused here.  ``event_scan.launches`` counts the launches and
``event_scan.telemetry_launches`` those of the instantiation that
carries the telemetry cube (a launch without telemetry runs the code
without it).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build
from repro_torch.telemetry.timeline import reciprocal

EPS = 1e-6
# the routing policies the kernel runs, as csrc/event_scan.cu numbers them
POLICIES = {"least_loaded": 0, "round_robin": 1, "batched_feasible": 2,
            "trace": 3, "random": 4, "power_of_two": 5}
# what counts[] holds after the launch
COUNTS = ("events", "retire_iterations", "unprocessed", "cursor", "error",
          "scored")
ERRORS = {1: "an origin node outside [0, K)",
          2: "a forwarding target (a recorded choice under trace, a "
             "neighbours entry) outside [0, K)"}
# dynamic shared memory a block may take on Hopper, less the kernel's own
SHARED_LIMIT = 227 * 1024 - 1024

_P = ctypes.c_void_p
_POINTERS = ("cols", "origin", "targets", "adj", "degree", "speeds", "lat",
             "inv_bw", "neighbors", "starts", "ends", "sizes", "slot_rid",
             "head", "nq", "busy", "load", "rr", "ev_time", "ev_rid",
             "ev_meta", "ev_n", "ev_dropped", "sat_events", "completion",
             "reqinfo", "transfer", "counts", "ring_time", "ring_rid",
             "ring_meta", "tel_counts", "tel_occ", "seeds")
_STRIDES = ("cols_cell", "net_cell")
_INTS = ("R", "K", "N", "W", "B", "M", "D", "E", "max_forwards", "hop_bits",
         "policy", "discard", "priced", "ring_in_shared", "NB")


class _ScanArgs(ctypes.Structure):
    """``ScanArgs`` of csrc/event_scan.cu, field for field."""
    _fields_ = ([(n, _P) for n in _POINTERS]
                + [(n, ctypes.c_longlong) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("eps", ctypes.c_float), ("tel_inv_w", ctypes.c_float)])


class ScanOut(NamedTuple):
    """The final ``EventState`` tensors of each cell, each with a leading
    ``(C,)``; ``counts``: the (C, 6) int64 ``COUNTS`` (``scored``: the
    live ledger blocks the cell's scoring read, summed over its steps);
    with telemetry the carried cube, ``tel_counts`` (C, K, NB, 5) and
    ``tel_occ`` (C, NB) int32, else None."""
    starts: torch.Tensor
    ends: torch.Tensor
    sizes: torch.Tensor
    slot_rid: torch.Tensor
    head: torch.Tensor
    nq: torch.Tensor
    busy: torch.Tensor
    load: torch.Tensor
    rr: torch.Tensor
    ev_time: torch.Tensor
    ev_rid: torch.Tensor
    ev_meta: torch.Tensor
    ev_n: torch.Tensor
    ev_dropped: torch.Tensor
    sat_events: torch.Tensor
    completion: torch.Tensor
    reqinfo: torch.Tensor
    transfer: torch.Tensor
    counts: torch.Tensor
    tel_counts: Optional[torch.Tensor] = None
    tel_occ: Optional[torch.Tensor] = None


def shared_bytes(K: int, B: int, ring_in_shared: bool) -> int:
    """Dynamic shared memory of a launch: nine (K,) per-node arrays and,
    when it is held there, the (B,) ring of (time, rid, meta)."""
    return 32 * K + (K + 3) // 4 * 4 + (12 * B if ring_in_shared else 0)


def _lib():
    lib = build.load("event_scan")
    fn = lib.event_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_ScanArgs), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return fn


def event_scan(cols: torch.Tensor, origin: torch.Tensor,
               targets: torch.Tensor, adj: torch.Tensor,
               degree: torch.Tensor, speeds: torch.Tensor,
               latency: torch.Tensor, inv_bw: torch.Tensor,
               neighbors: torch.Tensor, *, policy: str, max_forwards: int,
               discard_on_exhaust: bool, capacity: int, depth: int,
               event_buf: int, max_events: int, priced: bool, hop_bits: int,
               seed: Union[int, Sequence[int]] = 0,
               telemetry: Optional[Tuple[int, float]] = None) -> ScanOut:
    """Launch the kernel over C cells, one block each.

    ``cols`` is the (R, 4) f32 request table ``(arrival, d_abs, proc,
    payload)`` in arrival order, or (C, R, 4) with one table a cell;
    ``origin`` (R,) int32, ``targets`` (R, M) int32 recorded choices (read
    by ``trace``), ``adj`` (K, K) bool, ``degree`` (K,) int32, ``speeds``
    (K,) f32, ``latency`` / ``inv_bw`` (K, K) f32 (zeros for an unpriced
    run), or (C, K, K) with one network a cell, ``neighbors`` (K, D)
    int32, each row's ``degree`` neighbours ascending, then padding (read
    by ``random`` and ``power_of_two``).  ``seed`` is the ``PRNGKey``
    seed of the stochastic policies (taken mod 2**32), or a sequence of C,
    one a cell; C is 1 for an int.  ``capacity`` is the ledger width N,
    ``depth`` the live window W, ``event_buf`` the re-arrival buffer B,
    ``max_events`` the step bound, ``hop_bits`` the width of the hop
    count in a buffered event's meta.  ``telemetry`` is ``(n_buckets,
    width)``, the f32 bucket width, for the instantiation that carries
    the telemetry cube (it bins ``t · f32(1 / width)``, as
    :func:`repro_torch.telemetry.timeline.bucket_of`); ``None`` launches
    the one without it.
    """
    dev = cols.device
    seeds = [seed] if isinstance(seed, int) else [int(x) for x in seed]
    C = len(seeds)
    R, K, M = cols.shape[-2], speeds.shape[0], targets.shape[1]
    D = neighbors.shape[1] if neighbors.dim() == 2 else 0
    N, W, B, E = capacity, depth, event_buf, max_events
    f32, i32 = torch.float32, torch.int32
    n_cols = cols.shape[0] if cols.dim() == 3 else 1
    n_net = latency.shape[0] if latency.dim() == 3 else 1
    lead = lambda n, t: (n,) if t.dim() == 3 else ()
    build.check_tensors("event_scan", dev, (
        ("cols", cols, f32, lead(n_cols, cols) + (R, 4)),
        ("origin", origin, i32, (R,)),
        ("targets", targets, i32, (R, M)), ("adj", adj, torch.bool, (K, K)),
        ("degree", degree, i32, (K,)), ("speeds", speeds, f32, (K,)),
        ("latency", latency, f32, lead(n_net, latency) + (K, K)),
        ("inv_bw", inv_bw, f32, lead(n_net, latency) + (K, K)),
        ("neighbors", neighbors, i32, (K, D))))
    if policy not in POLICIES:
        raise ValueError(f"event_scan runs the policies {sorted(POLICIES)}, "
                         f"not {policy!r}")
    if n_cols not in (1, C) or n_net not in (1, C):
        raise ValueError(f"event_scan: {C} cells (seeds), but {n_cols} "
                         f"request tables and {n_net} networks: each is 1 "
                         "(shared) or one a cell")
    NB, width = telemetry if telemetry is not None else (0, 1.0)
    if not (R >= 1 and K >= 1 and M >= 1 and D >= 1 and 1 <= W <= N
            and B >= 0 and 0 <= E < 2 ** 31 and K * N < 2 ** 31
            and 1 <= C < 2 ** 31 and (telemetry is None or NB >= 1)):
        raise ValueError(f"event_scan: no run of R={R}, K={K}, M={M}, "
                         f"D={D}, N={N}, W={W}, B={B}, max_events={E}, "
                         f"cells={C}, telemetry={telemetry}")
    if cols.data_ptr() % 16:
        raise ValueError("event_scan reads each row of cols as one 16-byte "
                         "vector: cols must be 16-byte aligned")
    if dev.type != "cuda":
        raise ValueError(f"event_scan launches on CUDA tensors, got {dev}")
    ring_in_shared = shared_bytes(K, B, True) <= SHARED_LIMIT
    if shared_bytes(K, B, False) > SHARED_LIMIT:
        raise ValueError(f"event_scan: K={K} nodes exceed the shared memory "
                         "of one block")

    empty = lambda shape, dt: torch.empty((C,) + shape, dtype=dt, device=dev)
    out = ScanOut(
        starts=empty((K, N), f32), ends=empty((K, N), f32),
        sizes=empty((K, N), f32), slot_rid=empty((K, N), i32),
        head=empty((K,), i32), nq=empty((K,), i32), busy=empty((K,), f32),
        load=empty((K,), f32), rr=empty((1,), i32),
        ev_time=empty((B,), f32), ev_rid=empty((B,), i32),
        ev_meta=empty((B,), i32), ev_n=empty((1,), i32),
        ev_dropped=empty((1,), i32), sat_events=empty((1,), i32),
        completion=empty((R + 1,), f32), reqinfo=empty((R,), i32),
        transfer=empty((R,), f32), counts=empty((len(COUNTS),), torch.int64),
        tel_counts=None if telemetry is None else empty((K, NB, 5), i32),
        tel_occ=None if telemetry is None else empty((NB,), i32))
    ring = [None] * 3 if ring_in_shared else \
        [empty((B,), f32), empty((B,), i32), empty((B,), i32)]
    # each seed's low 32 bits, as the int32 of the same bit pattern
    u32 = [(x & 0xFFFFFFFF) - ((x & 0x80000000) << 1) for x in seeds]
    tensors = dict(cols=cols, origin=origin, targets=targets, adj=adj,
                   degree=degree, speeds=speeds, lat=latency, inv_bw=inv_bw,
                   neighbors=neighbors,
                   ring_time=ring[0], ring_rid=ring[1], ring_meta=ring[2],
                   seeds=torch.tensor(u32, dtype=i32, device=dev),
                   **out._asdict())
    args = _ScanArgs(
        *(None if tensors[n] is None else tensors[n].data_ptr()
          for n in _POINTERS),
        R * 4 if n_cols > 1 else 0, K * K if n_net > 1 else 0,
        R, K, N, W, B, M, D, E, max_forwards, hop_bits, POLICIES[policy],
        int(discard_on_exhaust), int(priced), int(ring_in_shared), NB, EPS,
        float(reciprocal(width)))
    build.raise_on("event_scan", _lib()(ctypes.byref(args), C,
                                        int(telemetry is not None),
                                        *build.stream_of(dev)))
    _wrapper.launches += 1
    _wrapper.telemetry_launches += telemetry is not None
    return out


event_scan.launches = 0
event_scan.telemetry_launches = 0
# counted through this name: a caller that wraps the module's event_scan
# (to keep its arguments) still counts on the wrapper itself
_wrapper = event_scan
