"""Wired 5G-MEC network model: what a referral costs (the port's copy of
the parts of ``repro/netsim/link.py`` the fleet simulator needs).

A referral over the edge ``(u, v)`` costs ``latency[u, v] + payload ·
inv_bw[u, v]`` UT; a request's payload is its camera frame
(``pixels × bytes_per_pixel`` in MB).  :class:`NetParams` holds the
``(K, K)`` latency / inverse-bandwidth arrays the simulator prices each
hop with; non-edges and the diagonal are 0.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np

from repro_torch.core.request import Service
from repro_torch.orchestration.topology import Topology

#: frame-size model: 24-bit RGB, payloads in MB (1e6 bytes)
BYTES_PER_PIXEL = 3.0

MatrixLike = Union[float, Sequence[Sequence[float]], np.ndarray]


def default_payload(service: Service) -> float:
    """Payload of one request in MB: the service's frame at 24bpp."""
    return service.pixels * BYTES_PER_PIXEL / 1e6


class NetParams(NamedTuple):
    """``latency[u, v]`` in UT and ``inv_bw[u, v]`` in UT per MB
    (``0`` = infinite bandwidth), both (K, K) f32 with a zero diagonal."""
    latency: np.ndarray
    inv_bw: np.ndarray


# (latency UT, bandwidth MB/UT) per link class, calibrated to the paper's
# scales (proc 20-180 UT, deadlines 4000-9000 UT)
PROFILES: Dict[str, Dict[str, float]] = {
    "zero": dict(latency=0.0, bandwidth=math.inf,
                 backhaul_latency=0.0, backhaul_bandwidth=math.inf,
                 uplink_latency=0.0, uplink_bandwidth=math.inf),
    "campus": dict(latency=5.0, bandwidth=1.25,
                   backhaul_latency=30.0, backhaul_bandwidth=0.3125,
                   uplink_latency=2.0, uplink_bandwidth=0.625),
    "metro": dict(latency=15.0, bandwidth=0.5,
                  backhaul_latency=60.0, backhaul_bandwidth=0.125,
                  uplink_latency=4.0, uplink_bandwidth=0.5),
    "wan": dict(latency=80.0, bandwidth=0.125,
                backhaul_latency=160.0, backhaul_bandwidth=0.0625,
                uplink_latency=8.0, uplink_bandwidth=0.25),
}


def _as_matrix(value: MatrixLike, n: int, name: str) -> np.ndarray:
    if np.isscalar(value):
        return np.full((n, n), float(value), np.float64)
    m = np.asarray(value, np.float64)
    if m.shape != (n, n):
        raise ValueError(f"{name} must be scalar or ({n}, {n}), "
                         f"got shape {m.shape}")
    return m


class LinkModel:
    """Per-edge latency + bandwidth over a :class:`Topology`, with a
    per-service payload model (``payloads`` overrides it by service
    name)."""

    def __init__(self, topology: Topology,
                 latency: MatrixLike = 0.0,
                 bandwidth: MatrixLike = math.inf, *,
                 payloads: Optional[Dict[str, float]] = None,
                 bytes_per_pixel: float = BYTES_PER_PIXEL,
                 name: str = "custom"):
        n = topology.n_nodes
        self.topology = topology
        self.name = name
        self.payloads = dict(payloads or {})
        self.bytes_per_pixel = float(bytes_per_pixel)
        lat = _as_matrix(latency, n, "latency")
        bw = _as_matrix(bandwidth, n, "bandwidth")
        if (lat < 0).any():
            raise ValueError("link latency must be non-negative")
        if (bw <= 0).any():
            raise ValueError("link bandwidth must be positive")
        edge = np.zeros((n, n), bool)
        for u, v in topology.edges():
            edge[u, v] = edge[v, u] = True
        # non-edges and the diagonal are priced 0: nothing forwards across
        # them, and zeros keep the device tensors inf/NaN-free
        self._lat = np.where(edge, lat, 0.0)
        with np.errstate(divide="ignore"):
            self._inv_bw = np.where(edge, np.where(np.isinf(bw), 0.0,
                                                   1.0 / bw), 0.0)

    def payload_of(self, service: Service) -> float:
        """Request payload in MB (override table, else the frame model)."""
        got = self.payloads.get(service.name)
        if got is not None:
            return float(got)
        return service.pixels * self.bytes_per_pixel / 1e6

    def net_params(self, dtype=np.float32) -> NetParams:
        """The (K, K) arrays the fleet simulator prices hops with."""
        return NetParams(latency=self._lat.astype(dtype),
                         inv_bw=self._inv_bw.astype(dtype))

    @classmethod
    def zero(cls, topology: Topology) -> "LinkModel":
        """The free network."""
        return cls(topology, 0.0, math.inf, name="zero")

    @classmethod
    def preset(cls, topology: Topology, profile: str = "campus",
               cloud_nodes: Sequence[int] = ()) -> "LinkModel":
        """A named link profile over ``topology``; edges touching a
        ``cloud_nodes`` id get the profile's backhaul pricing."""
        if profile not in PROFILES:
            raise ValueError(f"unknown link profile {profile!r}; "
                             f"options: {sorted(PROFILES)}")
        p = PROFILES[profile]
        n = topology.n_nodes
        lat = np.full((n, n), p["latency"], np.float64)
        bw = np.full((n, n), p["bandwidth"], np.float64)
        for c in cloud_nodes:
            lat[c, :] = lat[:, c] = p["backhaul_latency"]
            bw[c, :] = bw[:, c] = p["backhaul_bandwidth"]
        return cls(topology, lat, bw, name=profile)

    @classmethod
    def campus(cls, topology: Topology,
               cloud_nodes: Sequence[int] = ()) -> "LinkModel":
        """The paper's venue: one campus aggregation network."""
        return cls.preset(topology, "campus", cloud_nodes)
