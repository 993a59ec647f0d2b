"""Decentralized communication topologies as mixing matrices, a numpy copy
of ``fedml_tpu/topology/topology.py``.

Reference: fedml_core/distributed/topology/ — ``BaseTopologyManager``
(base_topology_manager.py:4: generate topology, in/out neighbor index and
weight queries), ``SymmetricTopologyManager`` (symmetric_topology_manager.py:
21-52: ring + Watts-Strogatz random extra links, row-normalized weights),
``AsymmetricTopologyManager`` (directed variant with extra out-edges).

On the device the whole neighbor message exchange collapses into one matmul:
``new_params = W @ stacked_params`` over the client axis
(``algorithms/decentralized.py``), so the topology *is* its row-stochastic
matrix.
"""

from __future__ import annotations

import numpy as np


class BaseTopologyManager:
    """Mixing-matrix topology. ``topology[i, j]`` is the weight node i puts on
    node j's model; rows sum to 1."""

    def __init__(self, n: int):
        self.n = n
        self.topology = np.zeros((n, n), dtype=np.float32)

    def generate_topology(self):
        raise NotImplementedError

    # neighbor queries mirror the reference API (base_topology_manager.py:4)
    def get_in_neighbor_idx_list(self, node_index: int) -> list[int]:
        return [j for j in range(self.n) if self.topology[j, node_index] > 0 and j != node_index]

    def get_out_neighbor_idx_list(self, node_index: int) -> list[int]:
        return [j for j in range(self.n) if self.topology[node_index, j] > 0 and j != node_index]

    def get_in_neighbor_weights(self, node_index: int) -> list[float]:
        return [float(self.topology[j, node_index]) for j in range(self.n)]

    def get_out_neighbor_weights(self, node_index: int) -> list[float]:
        return [float(self.topology[node_index, j]) for j in range(self.n)]

    def mixing_matrix(self) -> np.ndarray:
        return self.topology


class SymmetricTopologyManager(BaseTopologyManager):
    """Undirected ring + random Watts-Strogatz-style extra links
    (symmetric_topology_manager.py:21-52)."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        super().__init__(n)
        self.neighbor_num = neighbor_num
        self.seed = seed

    def generate_topology(self):
        rng = np.random.RandomState(self.seed)
        adj = np.eye(self.n, dtype=np.float32)
        # ring base: each node links to neighbor_num/2 on each side
        half = max(1, self.neighbor_num // 2)
        for i in range(self.n):
            for d in range(1, half + 1):
                adj[i, (i + d) % self.n] = 1
                adj[i, (i - d) % self.n] = 1
        # random rewiring extras (WS beta=0.5 spirit)
        extras = max(0, self.neighbor_num - 2 * half)
        for i in range(self.n):
            for _ in range(extras):
                j = rng.randint(self.n)
                adj[i, j] = adj[j, i] = 1
        # symmetrize then row-normalize
        adj = np.maximum(adj, adj.T)
        self.topology = adj / adj.sum(axis=1, keepdims=True)
        return self.topology


class AsymmetricTopologyManager(BaseTopologyManager):
    """Directed: symmetric ring base plus random out-edges, row-normalized
    (asymmetric_topology_manager.py:7+)."""

    def __init__(self, n: int, undirected_neighbor_num: int = 2, out_directed_neighbor: int = 2, seed: int = 0):
        super().__init__(n)
        self.undirected = undirected_neighbor_num
        self.extra_out = out_directed_neighbor
        self.seed = seed

    def generate_topology(self):
        rng = np.random.RandomState(self.seed)
        adj = np.eye(self.n, dtype=np.float32)
        half = max(1, self.undirected // 2)
        for i in range(self.n):
            for d in range(1, half + 1):
                adj[i, (i + d) % self.n] = 1
                adj[i, (i - d) % self.n] = 1
        adj = np.maximum(adj, adj.T)
        for i in range(self.n):
            for _ in range(self.extra_out):
                adj[i, rng.randint(self.n)] = 1
        self.topology = adj / adj.sum(axis=1, keepdims=True)
        return self.topology


def ring_topology(n: int) -> np.ndarray:
    """Plain ring with uniform 1/3 weights — the decentralized_framework
    default (algorithm_api.py:56-65 uses SymmetricTopologyManager(n, 2))."""
    t = SymmetricTopologyManager(n, 2)
    return t.generate_topology()


def time_varying_directed(n: int, round_idx: int, out_degree: int = 2) -> np.ndarray:
    """Column-stochastic random directed graph for Push-Sum
    (client_pushsum.py time-varying graphs)."""
    rng = np.random.RandomState(round_idx)
    adj = np.eye(n, dtype=np.float32)
    for i in range(n):
        targets = rng.choice(n, out_degree, replace=False)
        for j in targets:
            adj[j, i] = 1  # i sends to j: column i spreads
    return adj / adj.sum(axis=0, keepdims=True)
