"""Serial Dijkstra baseline (host), the gold standard of the solvers.

A copy of `raytracer_tpu/solvers/dijkstra.py`: scipy.sparse.csgraph's
Dijkstra on exactly the edge weights the device solvers use (the ELL
weights of ops/weights.py), so BFM-vs-Dijkstra equality tests are
meaningful to machine precision.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra as _csgraph_dijkstra

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.graph import csr_to_ell
from ..ops.weights import edge_weights_dual, edge_weights_scalar
from .types import Dijkstra

# Halo twin merges behave like zero-cost directed edges; an epsilon this
# small is absorbed below float64 resolution when added to any real time.
_HALO_EPS = 1e-300


def weight_matrix(
    A: sp.csr_matrix,
    halo: np.ndarray,
    gr,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
) -> sp.csr_matrix:
    """Directed weighted graph: W[i, j] = travel time of edge j -> i,
    built from the same ELL weights as the device solver, plus the halo
    twin links as (near-)zero-cost edges."""
    ell = csr_to_ell(A, node_pad=1, degree_pad=1)
    U = np.asarray(U)
    if U.ndim == 2:
        w = edge_weights_dual(gr, ell, U, dtype=np.dtype(config.dtype))
    else:
        w = edge_weights_scalar(gr, ell, U, dtype=np.dtype(config.dtype))

    n = ell.n
    rows = np.repeat(np.arange(ell.n_pad), ell.k).reshape(ell.nbr.shape)
    m = ell.mask & (rows < n)
    data = w[m].astype(np.float64)
    i = rows[m]
    j = ell.nbr[m]

    halo = np.asarray(halo)
    if halo.size:
        # dist[dst] can take dist[src]: edge src -> dst
        i = np.concatenate([i, halo[:, 1]])
        j = np.concatenate([j, halo[:, 0]])
        data = np.concatenate([data, np.full(halo.shape[0], _HALO_EPS)])

    return sp.csr_matrix((data, (i, j)), shape=(n, n))


# API-parity alias: the reference's `weights` builds the same precomputed
# sparse edge-weight matrix (src/SSSP/weights.jl:1-18)
weights = weight_matrix


def dijkstra(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
) -> Dijkstra:
    """Exact SSSP on the same graph/weights as `bfm` (gold standard)."""
    W = weight_matrix(A, halo, gr, U, config)
    # pull-based weights W[i, j] = cost j->i; csgraph follows row->col, so
    # transpose to propagate from the source outwards.
    dist, pred = _csgraph_dijkstra(W.T, directed=True, indices=source, return_predecessors=True)
    prev = np.where(pred < 0, np.arange(W.shape[0]), pred)
    return Dijkstra(prev=prev.astype(np.int64), dist=dist)
