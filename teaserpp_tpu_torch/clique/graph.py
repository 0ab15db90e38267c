"""Inlier graph: the pair-mask adjacency, the host ``Graph`` and the
max-clique facade.

Counterpart of ``teaserpp_tpu/clique/graph.py``. ``adjacency_from_pair_mask``
scatters the scale stage's K-vector TIM inlier mask into a dense symmetric
adjacency on the device (reference: the edge-insert loop at
registration.cc:614-619). ``Graph`` is a numpy copy of the JAX package's
(reference graph.h:29-207). ``MaxCliqueSolver`` mirrors graph.cc:12-125:
PMC_EXACT runs the port's host branch-and-bound (``clique/exact.py``),
KCORE_HEU the k-core peel with its threshold shortcut, PMC_HEU the greedy
heuristic, the last two on the solver's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from teaserpp_tpu_torch.clique import exact as _exact
from teaserpp_tpu_torch.clique.heuristic import heuristic_max_clique
from teaserpp_tpu_torch.clique.kcore import core_numbers
from teaserpp_tpu_torch.device import DeviceLike, resolve_device
from teaserpp_tpu_torch.ops.tims import _pair_index
from teaserpp_tpu_torch.params import CliqueSolverMode, MaxCliqueSolverParams


def adjacency_from_pair_mask(pair_mask: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter a (..., K) upper-triangle pair mask, K = n(n-1)/2, into a
    (..., n, n) bool symmetric adjacency."""
    i, j = _pair_index(n, pair_mask.device)
    adj = torch.zeros((*pair_mask.shape[:-1], n, n), dtype=torch.bool,
                      device=pair_mask.device)
    adj[..., i, j] = pair_mask
    return adj | adj.transpose(-1, -2)


class Graph:
    """Undirected graph over measurement indices (reference graph.h:29-207).

    Backed by a dense numpy bool adjacency; the list API is a view of it.
    """

    def __init__(self, adj: Optional[np.ndarray] = None):
        if adj is None:
            self._adj = np.zeros((0, 0), dtype=bool)
        else:
            adj = np.asarray(adj, dtype=bool)
            if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
                raise ValueError(f"adjacency must be square, got {adj.shape}")
            self._adj = adj.copy()
            np.fill_diagonal(self._adj, False)

    def populateVertices(self, num_vertices: int) -> None:
        """Resize to ``num_vertices`` vertices (reference graph.h:67)."""
        n_old = self._adj.shape[0]
        if num_vertices <= n_old:
            self._adj = self._adj[:num_vertices, :num_vertices].copy()
            return
        grown = np.zeros((num_vertices, num_vertices), dtype=bool)
        grown[:n_old, :n_old] = self._adj
        self._adj = grown

    def numVertices(self) -> int:
        return self._adj.shape[0]

    def numEdges(self) -> int:
        return int(self._adj.sum()) // 2

    def addVertex(self, v: int) -> None:
        if v >= self.numVertices():
            self.populateVertices(v + 1)

    def addEdge(self, u: int, v: int) -> None:
        self._adj[u, v] = True
        self._adj[v, u] = True

    def removeEdge(self, u: int, v: int) -> None:
        self._adj[u, v] = False
        self._adj[v, u] = False

    def hasEdge(self, u: int, v: int) -> bool:
        return bool(self._adj[u, v])

    def hasVertex(self, v: int) -> bool:
        return 0 <= v < self.numVertices()

    def getVertices(self) -> List[int]:
        return list(range(self.numVertices()))

    def getEdges(self, v: int) -> List[int]:
        return np.nonzero(self._adj[v])[0].tolist()

    def getAdjMatrix(self) -> np.ndarray:
        """Dense adjacency matrix export (reference graph.h:158)."""
        return self._adj.copy()

    @classmethod
    def from_edges(cls, num_vertices: int, edges: Sequence) -> "Graph":
        g = cls()
        g.populateVertices(num_vertices)
        for u, v in edges:
            g.addEdge(u, v)
        return g


class MaxCliqueSolver:
    """Max-clique facade (reference graph.cc:12-125 / graph.h:212-290).

    ``device`` (CUDA unless named) runs the KCORE_HEU peel and the PMC_HEU
    greedy search; PMC_EXACT is host C++ whatever the device.
    """

    CLIQUE_SOLVER_MODE = CliqueSolverMode  # reference-style nested enum alias

    def __init__(self, params: Optional[MaxCliqueSolverParams] = None,
                 device: DeviceLike = None):
        self.params = params or MaxCliqueSolverParams()
        self.device = resolve_device(device)

    def findMaxClique(self, graph: Graph) -> List[int]:
        adj = graph.getAdjMatrix()
        n = adj.shape[0]
        if n == 0:
            return []
        mode = self.params.solver_mode

        if mode == CliqueSolverMode.PMC_EXACT:
            # dense bitset search below adj_limit vertices, the sparse CSR one
            # above (reference graph.cc:114-121 switches at 20000)
            if n >= self.params.adj_limit:
                indptr, indices = _exact.adjacency_to_csr(adj)
                clique, _timed_out = _exact.exact_max_clique_sparse(
                    indptr, indices, n,
                    time_limit=self.params.time_limit,
                    num_threads=self.params.num_threads,
                )
            else:
                clique, _timed_out = _exact.exact_max_clique(
                    adj,
                    time_limit=self.params.time_limit,
                    num_threads=self.params.num_threads,
                )
            return sorted(clique)

        adj_dev = torch.from_numpy(adj).to(self.device)
        core = None
        if mode == CliqueSolverMode.KCORE_HEU:
            core = core_numbers(adj_dev[None])[0]
            core_np = core.cpu().numpy()
            max_core = int(core_np.max())
            # the top k-core when it is a large enough share of the vertices
            # (reference graph.cc:66-81)
            if (
                self.params.kcore_heuristic_threshold != 1
                and max_core > self.params.kcore_heuristic_threshold * n
            ):
                return [int(v) for v in np.nonzero(core_np >= max_core)[0]]

        # heuristic answer (reference graph.cc:89-91)
        heu = heuristic_max_clique(
            adj_dev, num_seeds=self.params.heuristic_num_seeds, core=core
        )
        return [int(v) for v in np.nonzero(heu.mask.cpu().numpy())[0]]
