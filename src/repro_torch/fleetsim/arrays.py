"""Array views of the orchestration plane's host objects, and the carry
across to torch (the port's copy of ``repro/fleetsim/arrays.py``).

* :class:`RequestArrays` — one row per request, sorted by arrival time;
  the row index is the dense request id every per-request output keys on.
* :class:`TopologyArrays` — adjacency, padded neighbor lists, per-node
  speeds.

:func:`pack_requests` and :func:`topology_arrays` build numpy arrays
exactly as the JAX package does; :func:`to_device` carries either
package's arrays onto a torch device with the same dtypes (f32 times,
int32 ids, bool adjacency).  This system has no weights: identical input
arrays are what both packages must consume.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.request import Request
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.netsim.link import NetParams
from repro_torch.orchestration.topology import Topology


class RequestArrays(NamedTuple):
    """One request per row, arrival-sorted (the scan order)."""
    arrival: np.ndarray        # (R,) f32 arrival time
    proc: np.ndarray           # (R,) f32 unscaled worst-case processing time
    rel_deadline: np.ndarray   # (R,) f32 relative SLA deadline
    origin: np.ndarray         # (R,) i32 origin node id
    service: np.ndarray        # (R,) i32 index into the service name table
    payload: np.ndarray = None  # (R,) f32 frame size in MB (wire cost;
    #                             may be None without a NetParams)


class TopologyArrays(NamedTuple):
    """Adjacency + padded neighbor lists of a Topology."""
    adj: np.ndarray            # (K, K) bool, no self loops
    neighbors: np.ndarray      # (K, maxdeg) i32, row i padded with i
    degree: np.ndarray         # (K,) i32
    speeds: np.ndarray         # (K,) f32


def event_bound(n_requests: int, max_forwards: int) -> int:
    """Worst-case event count of a fleet run: every request arrives at
    most ``max_forwards + 1`` times."""
    return n_requests * (max_forwards + 1)


def pack_requests(requests: Sequence[Request], dtype=np.float32,
                  payload_fn=None
                  ) -> Tuple[RequestArrays, Tuple[str, ...], List[int]]:
    """Request objects -> (arrays, service name table, host rid per row).
    Rows keep the caller's ``(arrival_time, rid)`` order."""
    if payload_fn is None:
        from repro_torch.netsim.link import default_payload as payload_fn
    names = sorted({r.service.name for r in requests})
    name_id = {s: i for i, s in enumerate(names)}
    arrays = RequestArrays(
        arrival=np.array([r.arrival_time for r in requests], dtype),
        proc=np.array([r.service.proc_time for r in requests], dtype),
        rel_deadline=np.array([r.service.deadline for r in requests], dtype),
        origin=np.array([r.origin_node for r in requests], np.int32),
        service=np.array([name_id[r.service.name] for r in requests],
                         np.int32),
        payload=np.array([payload_fn(r.service) for r in requests], dtype),
    )
    return arrays, tuple(names), [r.rid for r in requests]


def topology_arrays(topology: Topology, dtype=np.float32) -> TopologyArrays:
    """Topology -> TopologyArrays (neighbor rows padded with the own id)."""
    K = topology.n_nodes
    adj = np.zeros((K, K), bool)
    maxdeg = max((topology.degree(i) for i in range(K)), default=0)
    neighbors = np.tile(np.arange(K, dtype=np.int32)[:, None],
                        (1, max(maxdeg, 1)))
    degree = np.zeros((K,), np.int32)
    for i in range(K):
        nbrs = topology.neighbors(i)
        degree[i] = len(nbrs)
        for j, v in enumerate(nbrs):
            adj[i, v] = True
            neighbors[i, j] = v
    return TopologyArrays(adj=adj, neighbors=neighbors, degree=degree,
                          speeds=np.asarray(topology.speeds, dtype))


_REQ_DTYPES = (torch.float32, torch.float32, torch.float32, torch.int32,
               torch.int32, torch.float32)
_TOPO_DTYPES = (torch.bool, torch.int32, torch.int32, torch.float32)


def to_device(reqs: RequestArrays, topo: TopologyArrays,
              net: Optional[NetParams] = None, device: DeviceLike = None
              ) -> Tuple[RequestArrays, TopologyArrays, Optional[NetParams]]:
    """Carry packed arrays (numpy, either package's, or tensors) onto
    ``device`` as torch tensors: f32 times and prices, int32 ids, bool
    adjacency.  ``device=None`` means CUDA and raises without it."""
    dev = resolve_device(device)

    def put(a, dtype):
        return None if a is None else torch.as_tensor(
            np.asarray(a) if not torch.is_tensor(a) else a,
            dtype=dtype, device=dev).contiguous()

    reqs = RequestArrays(*(put(a, dt) for a, dt in zip(reqs, _REQ_DTYPES)))
    topo = TopologyArrays(*(put(a, dt) for a, dt in zip(topo, _TOPO_DTYPES)))
    if net is not None:
        net = NetParams(*(put(a, torch.float32) for a in net))
    return reqs, topo, net
