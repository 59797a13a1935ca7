"""The 2-D annulus graph, built again from the configuration alone.

A frozen NumPy copy of the upstream mesher's construction (RayTracer.jl
`src/GridAnnulus.jl`: `init_annulus`, the unique-edge variant): the polar
lattice with the discontinuity radii forced into every column, quad
elements and a triangle fan to the core point, secondary nodes every
`spacing` km on each element edge, element neighbours constrained to
their velocity layer, discontinuity nodes doubled into twins with a halo
table, and the node graph of the element incidence (star 1).

It is the reference's own copy: it imports nothing of the program, so a
fault in the program's builders shows as a graph that differs from this
one.  Node numbering is the upstream's; `twin_class` (0 regular, 1 / 2 a
twin made by the element in its own / the previous column) tells apart
the two coincident twins of a corner node.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp


class AnnulusMesh(NamedTuple):
    x: np.ndarray
    z: np.ndarray
    r: np.ndarray
    theta: np.ndarray
    twin_class: np.ndarray
    A: sp.csr_matrix        # symmetric node adjacency, sorted indices
    halo: np.ndarray        # (H, 2) (node, twin) pairs, both directions


def _ragged_arange(counts):
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def _element_neighbours(e2n, off, n_shared):
    """Elements sharing a node among [0, n_shared) (the core point is
    left out, as the upstream's incidence loop over elements does)."""
    nel = len(off) - 1
    rows = np.repeat(np.arange(nel, dtype=np.int64), np.diff(off))
    keep = e2n < n_shared
    inc = sp.csr_matrix((np.ones(int(keep.sum()), np.int32),
                         (rows[keep], e2n[keep])), shape=(nel, n_shared))
    adj = (inc @ inc.T).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()
    return adj.indices.astype(np.int64), adj.indptr.astype(np.int64)


def _primary(ntheta, nr, R, r_inner, disc_radii):
    rl = np.asarray(disc_radii, np.float64)
    nr_tot = nr + len(rl)
    nn = nr_tot * ntheta
    nels = (nr_tot - 1) * ntheta
    dtheta = 2 * np.pi / ntheta
    r_col = np.sort(np.concatenate([rl, np.linspace(r_inner, R, nr)]))
    r = np.empty(nn + 1)
    th = np.empty(nn + 1)
    cols = np.arange(ntheta)
    r[:nn] = np.tile(r_col, ntheta)
    th[:nn] = np.repeat(cols * dtheta, nr_tot)
    r[nn] = 0.0
    th[nn] = 0.0
    it = np.repeat(cols, nr_tot - 1)
    k = np.tile(np.arange(nr_tot - 1), ntheta)
    n1 = it * nr_tot + k
    n2 = ((it + 1) % ntheta) * nr_tot + k
    quads = np.stack([n1, n2, n2 + 1, n1 + 1], axis=1).astype(np.int64)
    tris = np.stack([np.full(ntheta, nn, np.int64), cols * nr_tot,
                     ((cols + 1) % ntheta) * nr_tot], axis=1)
    e2n = np.concatenate([quads.reshape(-1), tris.reshape(-1)])
    off = np.concatenate([np.arange(nels + 1, dtype=np.int64) * 4,
                          4 * nels + 3 * np.arange(1, ntheta + 1,
                                                   dtype=np.int64)])
    is_quad = np.concatenate([np.ones(nels, bool), np.zeros(ntheta, bool)])
    nbr, nbr_off = _element_neighbours(e2n, off, nn)
    return th, r, e2n, off, is_quad, nbr, nbr_off, nr_tot


_QUAD_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
_TRI_EDGES = np.array([[0, 1], [1, 2], [2, 0]])


def _edges(e2n, off, is_quad, n):
    """Unique element edges (sorted node pairs) and the elements that
    share each, edge-major."""
    q = np.flatnonzero(is_quad)
    t = np.flatnonzero(~is_quad)
    V4 = e2n[off[q][:, None] + np.arange(4)]
    V3 = e2n[off[t][:, None] + np.arange(3)]
    pairs = np.concatenate([V4[:, _QUAD_EDGES].reshape(-1, 2),
                            V3[:, _TRI_EDGES].reshape(-1, 2)])
    owner = np.concatenate([np.repeat(q, 4), np.repeat(t, 3)])
    pairs.sort(axis=1)
    key = pairs[:, 0] * np.int64(n) + pairs[:, 1]
    ukey, inv = np.unique(key, return_inverse=True)
    edges = np.stack([ukey // n, ukey % n], axis=1)
    order = np.argsort(inv, kind="stable")
    cnt = np.bincount(inv, minlength=len(ukey)).astype(np.int64)
    e_off = np.zeros(len(ukey) + 1, np.int64)
    np.cumsum(cnt, out=e_off[1:])
    return edges, owner[order], e_off


def _secondary(th, r, e2n, off, is_quad, ntheta, nr_tot, spacing):
    """Nodes every `spacing` km along each edge (arc length on a
    circumferential edge, chord on a radial one), appended to every
    element sharing the edge."""
    n0 = len(r)
    nel = len(off) - 1
    edges, e2el, e_off = _edges(e2n, off, is_quad, n0)
    icenter = nr_tot * ntheta
    period = 2 * np.pi
    eps = 2 * np.pi - (1 - 1 / ntheta)
    th1, th2 = th[edges[:, 0]].copy(), th[edges[:, 1]].copy()
    r1, r2 = r[edges[:, 0]], r[edges[:, 1]]
    has_c = (edges[:, 0] == icenter) | (edges[:, 1] == icenter)
    wrap = ~has_c & (np.abs(th1 - th2) >= eps)
    s1 = wrap & (th1 < th2)
    s2 = wrap & ~s1
    th1 = np.where(s1, th1 + period, th1)
    th2 = np.where(s2, th2 + period, th2)
    thmax = np.maximum(th1, th2)
    th1 = np.where(has_c, thmax, th1)
    th2 = np.where(has_c, thmax, th2)
    radial = th1 == th2
    L = np.where(radial, np.abs(r2 - r1), r1 * np.abs(th2 - th1))
    npts = (L // spacing).astype(np.int64)
    total = int(npts.sum())
    edge_of = np.repeat(np.arange(len(edges)), npts)
    starts = np.concatenate([[0], np.cumsum(npts)[:-1]])
    j = np.arange(total) - np.repeat(starts, npts) + 1
    frac = j / (npts[edge_of] + 1)
    th_mid = th1[edge_of] + (th2[edge_of] - th1[edge_of]) * frac
    r_mid = r1[edge_of] + (r2[edge_of] - r1[edge_of]) * frac
    sz0 = np.diff(off)
    pair_edge = np.repeat(np.arange(len(edges), dtype=np.int64),
                          np.diff(e_off))
    add_cnt = npts[pair_edge]
    rep_el = np.repeat(e2el, add_cnt)
    add_ids = (n0 + np.repeat(starts[pair_edge], add_cnt)
               + _ragged_arange(add_cnt))
    order = np.argsort(rep_el, kind="stable")
    cnt_el = np.bincount(rep_el, minlength=nel).astype(np.int64)
    off_new = np.zeros(nel + 1, np.int64)
    np.cumsum(sz0 + cnt_el, out=off_new[1:])
    e2n_new = np.empty(off_new[-1], np.int64)
    e2n_new[np.repeat(off_new[:-1], sz0) + _ragged_arange(sz0)] = e2n
    e2n_new[np.repeat(off_new[:-1] + sz0, cnt_el)
            + _ragged_arange(cnt_el)] = add_ids[order]
    return (np.concatenate([th, th_mid]), np.concatenate([r, r_mid]),
            e2n_new, off_new)


def _constrain(r, e2n, off, is_quad, nbr, nbr_off, layer_radii):
    """Drop element-neighbour links that cross a layer boundary; an
    element's layer is that of the mean radius of its primary vertices
    (0.33, not 1/3, for a triangle, as upstream)."""
    i0 = off[:-1]
    ra, rb, rc = r[e2n[i0]], r[e2n[i0 + 1]], r[e2n[i0 + 2]]
    rd = r[e2n[np.minimum(i0 + 3, len(e2n) - 1)]]
    center = np.where(is_quad, (ra + rb + rc + rd) * 0.25,
                      (ra + rb + rc) * 0.33)
    rl = np.asarray(layer_radii)
    layer = np.ones(center.shape, np.int64)
    for i in range(len(rl) - 1):
        layer = np.where((rl[i] > center) & (center > rl[i + 1]), i + 2,
                         layer)
    nel = len(off) - 1
    el_of = np.repeat(np.arange(nel, dtype=np.int64), np.diff(nbr_off))
    keep = layer[nbr] == layer[el_of]
    cnt = np.bincount(el_of[keep], minlength=nel).astype(np.int64)
    new_off = np.zeros(nel + 1, np.int64)
    np.cumsum(cnt, out=new_off[1:])
    return nbr[keep], new_off


def _twins(th, r, e2n, off, is_quad, ntheta, nr_tot, disc_radii,
           twin_offset):
    """Every quad whose third vertex lies on a discontinuity gets fresh
    twin nodes, `twin_offset` km inward, for its nodes on that radius;
    the halo pairs each twin with its original, both ways."""
    rl = np.asarray(disc_radii, np.float64)
    n = len(r)
    dtheta = 2 * np.pi / ntheta
    sizes = np.diff(off)
    top = e2n[np.minimum(off[:-1] + 2, len(e2n) - 1)]
    hit = r[top][:, None] == rl[None, :]
    eligible = is_quad & hit.any(axis=1)
    b_r = np.where(eligible, rl[np.argmax(hit, axis=1)], np.nan)
    pos = r[e2n] == np.repeat(b_r, sizes)
    el_of_pos = np.repeat(np.arange(len(off) - 1, dtype=np.int64), sizes)
    idx = e2n[pos]
    ntw = len(idx)
    e2n = e2n.copy()
    e2n[pos] = n + np.arange(ntw, dtype=np.int64)
    elem_col = el_of_pos[pos] // (nr_tot - 1)
    node_col = np.floor(np.mod(th[idx], 2 * np.pi) / dtheta
                        + 1e-6).astype(np.int64) % ntheta
    cls = np.zeros(n + ntw, np.int8)
    cls[n:] = np.where(node_col == elem_col, 1, 2)
    twin_ids = n + np.arange(ntw)
    halo = np.concatenate([np.stack([idx, twin_ids], axis=1),
                           np.stack([twin_ids, idx], axis=1)])
    th2 = np.concatenate([th, th[idx]])
    r2 = np.concatenate([r, r[idx] - twin_offset])
    return th2, r2, e2n, cls, halo


def _adjacency(e2n, off, nbr, nbr_off, n):
    """Nodes joined by an element or a (constrained) neighbour element:
    inc^T (I + N) inc with the diagonal dropped."""
    nel = len(off) - 1
    rows = np.repeat(np.arange(nel, dtype=np.int64), np.diff(off))
    inc = sp.csr_matrix((np.ones(len(rows), np.int32), (rows, e2n)),
                        shape=(nel, n))
    nrows = np.repeat(np.arange(nel, dtype=np.int64), np.diff(nbr_off))
    N = sp.csr_matrix((np.ones(len(nrows), np.int32), (nrows, nbr)),
                      shape=(nel, nel))
    eadj = sp.identity(nel, dtype=np.int32, format="csr") + N
    eadj.data[:] = 1
    A = (inc.T @ (eadj @ inc)).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    A.sort_indices()
    return A


def build_annulus(ntheta: int, nr: int, spacing: float, R: float,
                  r_inner: float, disc_depths, twin_offset: float
                  ) -> AnnulusMesh:
    disc = tuple(R - d for d in disc_depths)
    th, r, e2n, off, is_quad, nbr, nbr_off, nr_tot = _primary(
        ntheta, nr, R, r_inner, disc)
    th, r, e2n, off = _secondary(th, r, e2n, off, is_quad, ntheta, nr_tot,
                                 spacing)
    nbr, nbr_off = _constrain(r, e2n, off, is_quad, nbr, nbr_off,
                              (R,) + disc)
    th, r, e2n, cls, halo = _twins(th, r, e2n, off, is_quad, ntheta, nr_tot,
                                   disc, twin_offset)
    A = _adjacency(e2n, off, nbr, nbr_off, len(r))
    x, z = r * np.sin(th), r * np.cos(th)
    return AnnulusMesh(x=x, z=z, r=r, theta=th, twin_class=cls, A=A,
                       halo=halo)
