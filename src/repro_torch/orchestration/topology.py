"""Cluster topology: which nodes can forward to which, and how fast each is
(the port's copy of ``repro/orchestration/topology.py``).

* **neighbor graph** — an undirected graph over node ids; a router only
  ever forwards to ``topology.neighbors(node)``.  Constructors cover
  :meth:`full_mesh` (the paper), :meth:`ring`, :meth:`star` and
  :meth:`two_tier` (edge sites backed by a cloud tier).
* **per-node speed** — node ``i`` processes a request in
  ``proc_time / speed(i)``; ``1.0`` is the paper's homogeneous baseline.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple


class Topology:
    """Undirected neighbor graph + per-node speed factors."""

    def __init__(self, n_nodes: int,
                 edges: Optional[Iterable[Tuple[int, int]]] = None,
                 speeds: Optional[Sequence[float]] = None,
                 name: str = "custom"):
        if n_nodes < 1:
            raise ValueError(f"need at least one node, got {n_nodes}")
        self.n_nodes = n_nodes
        self.name = name
        if speeds is None:
            speeds = [1.0] * n_nodes
        if len(speeds) != n_nodes:
            raise ValueError(f"{len(speeds)} speeds for {n_nodes} nodes")
        if any(s <= 0 for s in speeds):
            raise ValueError("speeds must be positive")
        self._speeds = tuple(float(s) for s in speeds)

        adj: Dict[int, set] = {i: set() for i in range(n_nodes)}
        if edges is None:                      # full mesh
            for i in range(n_nodes):
                adj[i] = set(range(n_nodes)) - {i}
        else:
            for u, v in edges:
                if not (0 <= u < n_nodes and 0 <= v < n_nodes):
                    raise ValueError(f"edge ({u}, {v}) out of range")
                if u == v:
                    continue
                adj[u].add(v)
                adj[v].add(u)
        # sorted tuples => deterministic candidate order
        self._neighbors = tuple(tuple(sorted(adj[i])) for i in range(n_nodes))

    def neighbors(self, node_id: int) -> Tuple[int, ...]:
        """Forwarding candidates of ``node_id``, ascending, self excluded."""
        return self._neighbors[node_id]

    def speed(self, node_id: int) -> float:
        return self._speeds[node_id]

    @property
    def speeds(self) -> Tuple[float, ...]:
        return self._speeds

    @property
    def homogeneous(self) -> bool:
        return all(s == 1.0 for s in self._speeds)

    def degree(self, node_id: int) -> int:
        return len(self._neighbors[node_id])

    def edges(self) -> Tuple[Tuple[int, int], ...]:
        """Canonical (u < v) edge list."""
        return tuple((u, v) for u in range(self.n_nodes)
                     for v in self._neighbors[u] if u < v)

    def __repr__(self) -> str:
        return (f"Topology({self.name!r}, n={self.n_nodes}, "
                f"edges={len(self.edges())}, "
                f"speeds={'homogeneous' if self.homogeneous else self._speeds})")

    @classmethod
    def full_mesh(cls, n_nodes: int,
                  speeds: Optional[Sequence[float]] = None) -> "Topology":
        """Every node is a neighbor of every other node (the paper's model)."""
        return cls(n_nodes, edges=None, speeds=speeds, name="full_mesh")

    @classmethod
    def ring(cls, n_nodes: int,
             speeds: Optional[Sequence[float]] = None) -> "Topology":
        """Node ``i`` is connected to ``i±1 (mod n)``."""
        edges = [(i, (i + 1) % n_nodes) for i in range(n_nodes)]
        return cls(n_nodes, edges=edges, speeds=speeds, name="ring")

    @classmethod
    def star(cls, n_nodes: int, hub: int = 0,
             speeds: Optional[Sequence[float]] = None) -> "Topology":
        """All leaves connect only to ``hub``."""
        edges = [(hub, i) for i in range(n_nodes) if i != hub]
        return cls(n_nodes, edges=edges, speeds=speeds, name="star")

    @classmethod
    def two_tier(cls, n_edge: int, n_cloud: int = 1,
                 edge_speed: float = 1.0,
                 cloud_speed: float = 4.0) -> "Topology":
        """Edge sites ``0 .. n_edge-1`` each connect to every cloud node
        ``n_edge ..``; cloud nodes form a mesh; edge sites do not talk to
        each other directly."""
        n = n_edge + n_cloud
        edges = [(e, n_edge + c) for e in range(n_edge) for c in range(n_cloud)]
        edges += [(n_edge + a, n_edge + b)
                  for a in range(n_cloud) for b in range(a + 1, n_cloud)]
        speeds = [edge_speed] * n_edge + [cloud_speed] * n_cloud
        return cls(n, edges=edges, speeds=speeds, name="two_tier")
