"""Graph layouts of the generic-graph solvers (host NumPy).

A copy of `raytracer_tpu/ops/graph.py`.  The canonical device layout is
a padded ELL matrix: every node gets exactly K neighbour slots (its CSR
row, then self-pointing padding), so one relaxation is a static-shape
gather and row minimum (ops/relax.py, kernel csrc/ell_bfm.cu).
`rcm_permutation` is the reverse Cuthill-McKee order that the banded
solver (ops/banded.py) packs its diagonals in; `tile_permutation` a
cheap (theta, r) order; `sparse_adjacency_list` and `adjacency_list`
the reference's flat and dense adjacency containers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ELLGraph:
    """Padded ELL adjacency.

    nbr  : (n_pad, K) int32, neighbour ids; padding slots self-point (row i
           stores i) so gathers stay in-bounds and are no-ops.
    mask : (n_pad, K) bool, True for real neighbour slots.
    n    : true node count (n_pad >= n + 1; at least one dummy row exists
           for masked scatters).
    """

    nbr: np.ndarray
    mask: np.ndarray
    n: int

    @property
    def n_pad(self) -> int:
        return self.nbr.shape[0]

    @property
    def k(self) -> int:
        return self.nbr.shape[1]

    @property
    def degrees(self) -> np.ndarray:
        return self.mask.sum(axis=1)


def csr_to_ell(A: sp.csr_matrix, node_pad: int = 1024, degree_pad: int = 8) -> ELLGraph:
    """Pack a CSR adjacency matrix into a padded ELL layout.

    Rows are padded to a multiple of `node_pad` (+1 dummy row minimum) and
    the neighbour axis to a multiple of `degree_pad`.
    """
    n = A.shape[0]
    deg = np.diff(A.indptr)
    k = _round_up(max(int(deg.max()), 1), degree_pad)
    n_pad = _round_up(n + 1, node_pad)

    nbr = np.repeat(np.arange(n_pad, dtype=np.int32)[:, None], k, axis=1)
    mask = np.zeros((n_pad, k), dtype=bool)

    # scatter CSR columns into the fixed-width rows
    rows = np.repeat(np.arange(n), deg)
    offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    nbr[rows, offs] = A.indices
    mask[rows, offs] = True
    return ELLGraph(nbr=nbr, mask=mask, n=n)


def permute_graph(A: sp.csr_matrix, perm: np.ndarray) -> sp.csr_matrix:
    """Symmetric permutation A[perm][:, perm]."""
    n = A.shape[0]
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    coo = A.tocoo()
    out = sp.csr_matrix((coo.data, (inv[coo.row], inv[coo.col])), shape=A.shape)
    out.sort_indices()
    return out


def rcm_permutation(A: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee node order (reference: src/SSSP/rcm.jl:2-46).

    Returns `perm` with new_index -> old_index semantics (node perm[i] of
    the old numbering becomes node i).
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True), dtype=np.int64)


def tile_permutation(gr) -> np.ndarray:
    """Tile-blocked node order for HBM locality (RCM replacement).

    Sorts nodes by (layer-ish radius band, theta, r) so that nodes that are
    graph neighbours land in nearby rows, keeping each node tile's gather
    window small.  theta is taken modulo 2*pi to fold the seam-crossing
    secondary nodes back next to their geometric neighbours.
    """
    th = np.mod(gr.theta, 2 * np.pi)
    return np.asarray(np.lexsort((gr.r, th)), dtype=np.int64)


def nodal_degree(A: sp.csr_matrix) -> np.ndarray:
    """Per-node degree (reference: src/topology/topology.jl:70-77)."""
    return np.diff(A.indptr)


@dataclasses.dataclass(frozen=True)
class SparseAdjacencyList:
    """Flat CSR-style adjacency (reference SparseAdjencyList,
    src/topology/topology.jl:89-111): `list` concatenated neighbours,
    `deg` per-node degree, `idx` per-node start offsets (0-based)."""

    list: np.ndarray
    deg: np.ndarray
    idx: np.ndarray


def sparse_adjacency_list(A: sp.csr_matrix) -> SparseAdjacencyList:
    return SparseAdjacencyList(
        list=A.indices.astype(np.int32),
        deg=np.diff(A.indptr).astype(np.int32),
        idx=A.indptr[:-1].astype(np.int32),
    )


@dataclasses.dataclass(frozen=True)
class AdjacencyList:
    """Dense padded adjacency matrix + degrees (reference AdjencyList,
    src/topology/topology.jl:1-68).  Superseded by ELLGraph on device."""

    G: np.ndarray
    N: np.ndarray


def adjacency_list(A: sp.csr_matrix) -> AdjacencyList:
    ell = csr_to_ell(A, node_pad=1, degree_pad=1)
    G = np.where(ell.mask, ell.nbr, 0)[: A.shape[0]]
    return AdjacencyList(G=G.T.astype(np.int32), N=np.diff(A.indptr).astype(np.int32))


def pad_halo(halo: np.ndarray):
    """(halo_src, halo_dst) int32 of an (H, 2) twin table, padded with
    (0, 0) rows to a multiple of 8 (8 rows for an empty table), as the
    JAX package packs it for its solvers."""
    halo = np.asarray(halo)
    n_rows = 0 if halo.size == 0 else halo.shape[0]
    hpad = max(_round_up(n_rows, 8), 8)
    hsrc = np.zeros(hpad, dtype=np.int32)
    hdst = np.zeros(hpad, dtype=np.int32)
    if n_rows:
        hsrc[:n_rows] = halo[:, 0]
        hdst[:n_rows] = halo[:, 1]
    return hsrc, hdst


def halo_by_destination(halo_src: np.ndarray, halo_dst: np.ndarray,
                        n_pad: int):
    """The twin-merge rows grouped by destination, for the kernels that
    give each destination one thread (or warp): (didx, hoff, hsrc) with
    didx (n_pad,) int32 the destination's group (-1 for a node that is no
    destination), hoff (D+1,) int32 the group offsets and hsrc int32 the
    rows' sources, in table order within a group.  Rows whose source is
    their destination (the (0, 0) padding) are left out: such a row never
    changes a value."""
    hs = np.asarray(halo_src, dtype=np.int64).ravel()
    hd = np.asarray(halo_dst, dtype=np.int64).ravel()
    keep = hs != hd
    hs, hd = hs[keep], hd[keep]
    order = np.argsort(hd, kind="stable")
    dests, counts = np.unique(hd[order], return_counts=True)
    hoff = np.zeros(len(dests) + 1, dtype=np.int32)
    np.cumsum(counts, out=hoff[1:])
    didx = np.full(n_pad, -1, dtype=np.int32)
    didx[dests] = np.arange(len(dests), dtype=np.int32)
    return didx, hoff, hs[order].astype(np.int32)
