"""2-D annulus (Earth cross-section) mesh + graph builder.

Host-side NumPy, a copy of `raytracer_tpu/models/annulus.py`: primary
polar lattice with the 7 AK135 discontinuity radii forced into the
radial column, quad elements + triangle fan to the core point, secondary
nodes subdividing every element edge, layer constraining of element
neighbours, and discontinuity node doubling with a halo (twin) table.

  * `edge_connectivity` dedupes edges by sorted node pair.  The reference
    mesher (src/GridAnnulus.jl:515-595) writes slot 1 regardless of which
    edge matched and so creates duplicated coincident secondary nodes;
    `init_annulus(faithful=True)` reproduces them
    (`edge_connectivity_faithful`), the default builds the intended
    unique-edge set.
  * element neighbours exclude links through the core-centre point, as
    the reference's incidence loop over `1:nel` does.
  * `node_adjacency` takes the native C++ builder of `..native`
    (native/graphbuild.cpp, compiled with g++ at first use) and, where no
    g++ is on PATH, the scipy triple product `_node_adjacency_scipy`,
    which builds the same matrix.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..config import DISCONTINUITY_RADII, LAYER_RADII, R, R_INNER, TWIN_OFFSET
from ..utils.coords import polar2cartesian


@dataclasses.dataclass
class Grid2D:
    """Annulus grid (reference struct: src/GridAnnulus.jl:9-21).

    x, z        : cartesian node coordinates
    theta, r    : polar node coordinates (theta may exceed 2*pi for nodes
                  generated on seam-crossing edges, as in the reference)
    e2n         : per-element node lists (vertices first, then secondary)
    ntheta, nr  : lattice dimensions (nr already includes the 7 forced radii)
    nel, nnods  : element / node counts
    neighbours  : per-element neighbour element lists
    is_quad     : bool per element (True = quad, False = triangle)
    """

    x: np.ndarray
    z: np.ndarray
    theta: np.ndarray
    r: np.ndarray
    e2n: List[np.ndarray]
    ntheta: int
    nr: int
    nel: int
    nnods: int
    neighbours: List[np.ndarray]
    is_quad: np.ndarray
    # 0 = regular node; 1/2 = discontinuity twin created by the element in
    # its own / the previous theta column (used by the circulant layout to
    # disambiguate geometrically coincident twins)
    twin_class: Optional[np.ndarray] = None
    # flat CSR-style views of e2n / neighbours (single contiguous array +
    # offsets).  The builders construct these directly and derive the
    # ragged lists as views; anything built from a raw list computes them
    # lazily on first use.  The hot host paths (graph build, element
    # scans) consume the flat form - per-element Python loops over ~1e5
    # ragged arrays were the dominant mesh-build cost on this 1-core host.
    e2n_flat: Optional[np.ndarray] = None
    e2n_off: Optional[np.ndarray] = None
    nbr_flat: Optional[np.ndarray] = None
    nbr_off: Optional[np.ndarray] = None
    # column angular pitch.  None (the default) means the standard full
    # annulus, dtheta = 2*pi/ntheta.  Periodic *wedge* meshes (the O(M)
    # circulant fast path, models/fast_annulus.py) carry the FULL mesh's
    # pitch here while spanning only ntheta_wedge columns.
    dtheta: Optional[float] = None

    @property
    def dtheta_val(self) -> float:
        return 2 * np.pi / self.ntheta if self.dtheta is None else self.dtheta

    @property
    def period(self) -> float:
        """Angular period of the mesh (2*pi for a full annulus)."""
        return (2 * np.pi if self.dtheta is None
                else self.ntheta * self.dtheta)

    def __len__(self) -> int:
        return self.nnods

    def flat_e2n(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.e2n_flat is None:
            self.e2n_flat, self.e2n_off = _ragged_to_flat(self.e2n)
        return self.e2n_flat, self.e2n_off

    def flat_neighbours(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.nbr_flat is None:
            self.nbr_flat, self.nbr_off = _ragged_to_flat(self.neighbours)
        return self.nbr_flat, self.nbr_off


def _ragged_to_flat(lists) -> Tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in lists], out=off[1:])
    flat = (np.ascontiguousarray(np.concatenate(lists), dtype=np.int64)
            if off[-1] else np.empty(0, np.int64))
    return flat, off


class RaggedView:
    """Lazy list-of-arrays view over a flat (data, offsets) pair.

    Duck-types as the List[np.ndarray] the ragged e2n/neighbours fields
    historically were (len, indexing, iteration, slicing) but costs O(1)
    to construct - np.split at ~1e5 elements costs ~0.3 s on this host
    and most builds never touch the ragged form at all.
    """

    __slots__ = ("flat", "off")

    def __init__(self, flat: np.ndarray, off: np.ndarray):
        self.flat = flat
        self.off = off

    def __len__(self) -> int:
        return len(self.off) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        return self.flat[self.off[i]:self.off[i + 1]]

    def __iter__(self):
        flat, off = self.flat, self.off
        for i in range(len(off) - 1):
            yield flat[off[i]:off[i + 1]]


def _flat_to_ragged(flat: np.ndarray, off: np.ndarray) -> RaggedView:
    """Lazy list-like of views into `flat` (no copies)."""
    return RaggedView(flat, off)


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for counts c."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def primary_grid(ntheta: int, nr: int, r_out: float = R,
                 dtheta: Optional[float] = None) -> Grid2D:
    """Primary polar lattice + core point (src/GridAnnulus.jl:72-142).

    The radial column is nr + 7 values: linspace(R_INNER, r_out, nr) merged
    with the 7 discontinuity radii, sorted ascending.  Nodes are laid out
    column-major in theta: node (it, ir) -> it * nr_tot + ir; the core
    centre point is the last node.

    dtheta (default 2*pi/ntheta) overrides the column pitch; a non-default
    value builds a periodic WEDGE spanning ntheta*dtheta radians — the
    columns are geometrically identical to the first ntheta columns of the
    full annulus with that pitch (the O(M) circulant builder's input).
    """
    rl = np.array(DISCONTINUITY_RADII, dtype=np.float64)
    nr_tot = nr + len(rl)

    nn = nr_tot * ntheta
    nels = (nr_tot - 1) * ntheta
    dtheta_in = dtheta
    dtheta = 2 * np.pi / ntheta if dtheta is None else dtheta

    r_column = np.sort(np.concatenate([rl, np.linspace(R_INNER, r_out, nr_tot - len(rl))]))

    r_nodes = np.empty(nn + 1, dtype=np.float64)
    th_nodes = np.empty(nn + 1, dtype=np.float64)
    cols = np.arange(ntheta)
    r_nodes[:nn] = np.tile(r_column, ntheta)
    th_nodes[:nn] = np.repeat(cols * dtheta, nr_tot)
    r_nodes[nn] = 0.0   # core centre
    th_nodes[nn] = 0.0

    # quad elements: element (it, k) = it*(nr_tot-1)+k has nodes
    # [bottom-left, bottom-right, top-right, top-left] with wrap at the seam
    it = np.repeat(cols, nr_tot - 1)
    k = np.tile(np.arange(nr_tot - 1), ntheta)
    n1 = it * nr_tot + k
    n2 = ((it + 1) % ntheta) * nr_tot + k
    quads = np.stack([n1, n2, n2 + 1, n1 + 1], axis=1).astype(np.int64)

    # triangle fan to the core point: [centre, base_i, base_{i+1}]
    tris = np.stack(
        [np.full(ntheta, nn, dtype=np.int64), cols * nr_tot, ((cols + 1) % ntheta) * nr_tot],
        axis=1,
    )

    e2n_flat = np.concatenate([quads.reshape(-1), tris.reshape(-1)])
    e2n_off = np.concatenate([np.arange(nels + 1, dtype=np.int64) * 4,
                              4 * nels + 3 * np.arange(1, ntheta + 1,
                                                       dtype=np.int64)])
    e2n = _flat_to_ragged(e2n_flat, e2n_off)
    is_quad = np.concatenate([np.ones(nels, bool), np.zeros(ntheta, bool)])

    nbr_flat, nbr_off = element_neighbours_flat(e2n_flat, e2n_off,
                                                nnods_shared=nn)

    x, z = polar2cartesian(th_nodes, r_nodes)
    return Grid2D(
        x=x, z=z, theta=th_nodes, r=r_nodes, e2n=e2n,
        ntheta=ntheta, nr=nr_tot, nel=len(e2n), nnods=nn + 1,
        neighbours=_flat_to_ragged(nbr_flat, nbr_off), is_quad=is_quad,
        e2n_flat=e2n_flat, e2n_off=e2n_off,
        nbr_flat=nbr_flat, nbr_off=nbr_off,
        dtheta=dtheta_in,
    )


def element_neighbours_flat(e2n_flat: np.ndarray, e2n_off: np.ndarray,
                            nnods_shared: int) -> Tuple[np.ndarray, np.ndarray]:
    """Elements sharing >=1 node among nodes [0, nnods_shared), flat form.

    Equivalent of src/GridAnnulus.jl:473-507.  The shared-node range
    excludes the core centre point (see module docstring).
    """
    nel = len(e2n_off) - 1
    sizes = np.diff(e2n_off)
    rows = np.repeat(np.arange(nel, dtype=np.int64), sizes)
    keep = e2n_flat < nnods_shared
    inc = sp.csr_matrix(
        (np.ones(int(keep.sum()), dtype=np.int32),
         (rows[keep], e2n_flat[keep])),
        shape=(nel, nnods_shared),
    )
    adj = (inc @ inc.T).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()
    return adj.indices.astype(np.int64), adj.indptr.astype(np.int64)


def element_neighbours(e2n: List[np.ndarray], nnods_shared: int) -> List[np.ndarray]:
    """Ragged-list wrapper around element_neighbours_flat."""
    flat, off = _ragged_to_flat(e2n)
    nbr_flat, nbr_off = element_neighbours_flat(flat, off, nnods_shared)
    return _flat_to_ragged(nbr_flat, nbr_off)


# local edge maps (src/GridAnnulus.jl:519-524)
_QUAD_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
_TRI_EDGES = np.array([[0, 1], [1, 2], [2, 0]])


def edge_connectivity(gr: Grid2D):
    """Unique mesh edges and the elements sharing them.

    Returns (edges, edge2el) where edges is (E, 2) with node indices sorted
    ascending per edge and edge2el maps edge id -> list of element ids.
    Intended semantics of src/GridAnnulus.jl:515-595 (see module docstring
    for the deviation from its buggy slot bookkeeping).
    """
    edges, e2el_flat, e2el_off = edge_connectivity_flat(gr)
    return edges, _flat_to_ragged(e2el_flat, e2el_off)


def edge_connectivity_flat(gr: Grid2D):
    """edge_connectivity in flat form: (edges, edge2el_flat, edge2el_off).

    Fully vectorised: primary vertices are the first 4 (quad) / 3 (tri)
    entries of each element, so the local-edge tables apply to
    rectangular vertex arrays; edges dedupe through a scalar
    a*nnods+b key (same lexicographic order as np.unique(pairs, axis=0),
    so edge ids - and therefore secondary-node numbering - are unchanged).
    """
    flat, off = gr.flat_e2n()
    qidx = np.flatnonzero(gr.is_quad)
    tidx = np.flatnonzero(~gr.is_quad)
    V4 = flat[off[qidx][:, None] + np.arange(4)] if len(qidx) else \
        np.empty((0, 4), np.int64)
    V3 = flat[off[tidx][:, None] + np.arange(3)] if len(tidx) else \
        np.empty((0, 3), np.int64)
    pairs = np.concatenate([V4[:, _QUAD_EDGES].reshape(-1, 2),
                            V3[:, _TRI_EDGES].reshape(-1, 2)])
    owner = np.concatenate([np.repeat(qidx, 4), np.repeat(tidx, 3)])
    pairs.sort(axis=1)

    key = pairs[:, 0] * np.int64(gr.nnods) + pairs[:, 1]
    ukey, inverse = np.unique(key, return_inverse=True)
    edges = np.stack([ukey // gr.nnods, ukey % gr.nnods], axis=1)
    order = np.argsort(inverse, kind="stable")
    owner_sorted = owner[order]
    counts = np.bincount(inverse, minlength=len(ukey)).astype(np.int64)
    e2el_off = np.zeros(len(ukey) + 1, np.int64)
    np.cumsum(counts, out=e2el_off[1:])
    return edges, owner_sorted, e2el_off


def edge_connectivity_faithful(gr: Grid2D):
    """Bug-faithful replication of the reference's edge bookkeeping.

    The reference edge_connectivity (src/GridAnnulus.jl:515-595) has two
    intertwined defects that this function reproduces exactly:

      * the neighbour-marking loop `for i in 1:nedge: if issubset(...)`
        tests a condition independent of `i`, so it always writes
        `el2edge[1, ieln]` (slot 1) regardless of WHICH local edge of the
        neighbour actually coincides - later elements therefore re-create
        geometric edges whose true slot is not 1 (every radial edge is
        created twice, once per adjacent column);
      * `issubset(edge, edge_neighbour)` only checks that both endpoints
        are vertices of the neighbour, not that the neighbour has that
        edge, so corner configurations (e.g. the k=0 quads against the
        core triangle fan) can mark-and-suppress a slot whose edge is
        only created much later by a different element.

    The resulting duplicate coincident secondary nodes are what give the
    reference mesher its node counts (205,021 at 180x63 spacing 20,
    against 150,121 for the intended unique-edge mesh); travel times are
    unaffected because duplicates are coincident and share parents.

    Returns (edges, edge2el) like edge_connectivity, WITH duplicates.
    """
    nel = gr.nel
    verts = [frozenset(int(v) for v in nodes) for nodes in gr.e2n]
    local_edges = [nodes[_QUAD_EDGES if gr.is_quad[e] else _TRI_EDGES]
                   for e, nodes in enumerate(gr.e2n)]

    slot0_mark = np.zeros(nel, dtype=bool)   # el2edge[1, :] != 0 in the ref
    edges_out = []
    edge2el = []
    for iel in range(nel):
        led = local_edges[iel]
        nbrs = gr.neighbours[iel]
        for iedge in range(len(led)):
            if iedge == 0 and slot0_mark[iel]:
                continue
            a, b = int(led[iedge, 0]), int(led[iedge, 1])
            pair = (a, b) if a < b else (b, a)
            parents = [iel]
            for ieln in nbrs:
                if a in verts[ieln] and b in verts[ieln]:
                    slot0_mark[ieln] = True
                    parents.append(int(ieln))
            edges_out.append(pair)
            edge2el.append(np.asarray(parents, dtype=np.int64))
    return np.asarray(edges_out, dtype=np.int64), edge2el


def secondary_nodes(gr: Grid2D, spacing: float = 20.0, faithful: bool = False) -> Grid2D:
    """Subdivide every element edge with nodes every `spacing` km.

    Vectorised equivalent of src/GridAnnulus.jl:607-698: per edge of length
    L (arc length for circumferential edges, chord for radial ones),
    floor(L/spacing) interior points are placed at uniform parametric
    fractions and appended to the node set; each new node joins the
    element->node list of every element sharing the edge.

    faithful=True walks the reference's duplicated edge list
    (edge_connectivity_faithful) instead of the unique one, reproducing
    its coincident duplicate secondary nodes and node counts.
    """
    if faithful:
        edges, edge2el = edge_connectivity_faithful(gr)
        e2el_flat, e2el_off = _ragged_to_flat(edge2el)
    else:
        edges, e2el_flat, e2el_off = edge_connectivity_flat(gr)
    th, r = gr.theta, gr.r
    icenter = gr.nr * gr.ntheta  # core centre node id
    period = gr.period
    if gr.dtheta is None:
        eps = 2 * np.pi - (1 - 1 / gr.ntheta)  # seam-wrap threshold (ref :621)
    else:
        # periodic wedge: regular edges span <= 1 column pitch, seam edges
        # span (ntheta-1) pitches - any threshold in between detects them
        eps = period - 1.5 * gr.dtheta_val

    th1, th2 = th[edges[:, 0]].copy(), th[edges[:, 1]].copy()
    r1, r2 = r[edges[:, 0]], r[edges[:, 1]]

    # seam wrap fix + centre-edge collapse (src/GridAnnulus.jl:710-725);
    # `th1 < th2` == the reference's `th1 < pi` test on a full annulus
    # (a wrap pair always has one endpoint near 0 and one near 2*pi) and
    # generalises to wedge periods
    has_center = (edges[:, 0] == icenter) | (edges[:, 1] == icenter)
    wrap = ~has_center & (np.abs(th1 - th2) >= eps)
    shift1 = wrap & (th1 < th2)
    shift2 = wrap & ~shift1
    th1 = np.where(shift1, th1 + period, th1)
    th2 = np.where(shift2, th2 + period, th2)
    thmax = np.maximum(th1, th2)
    th1 = np.where(has_center, thmax, th1)
    th2 = np.where(has_center, thmax, th2)

    # edge length: radial edges use chord (= |r2-r1|), others arc length
    radial = th1 == th2
    L = np.where(radial, np.abs(r2 - r1), r1 * np.abs(th2 - th1))
    npoints = (L // spacing).astype(np.int64)

    total = int(npoints.sum())
    edge_of = np.repeat(np.arange(len(edges)), npoints)
    offsets = np.concatenate([[0], np.cumsum(npoints)[:-1]])
    j = np.arange(total) - np.repeat(offsets, npoints) + 1  # 1..npoints per edge
    frac = j / (npoints[edge_of] + 1)

    th_mid = th1[edge_of] + (th2[edge_of] - th1[edge_of]) * frac
    r_mid = r1[edge_of] + (r2[edge_of] - r1[edge_of]) * frac

    nnods0 = gr.nnods

    # append new nodes to every element sharing their edge - flat-form
    # equivalent of the sequential append loop: within an element the
    # appended ids are edge-ascending (stable sort by element preserves
    # the edge-major pair order), exactly like the loop produced
    flat, off = gr.flat_e2n()
    sz0 = np.diff(off)
    pair_cnt = np.diff(e2el_off)                 # elements per edge
    pair_edge = np.repeat(np.arange(len(edges), dtype=np.int64), pair_cnt)
    add_cnt = npoints[pair_edge]                 # new nodes per (edge, el)
    rep_el = np.repeat(e2el_flat, add_cnt)
    add_ids = (nnods0 + np.repeat(offsets[pair_edge], add_cnt)
               + _ragged_arange(add_cnt))
    order = np.argsort(rep_el, kind="stable")
    cnt_el = np.bincount(rep_el, minlength=gr.nel).astype(np.int64)
    sz_new = sz0 + cnt_el
    off_new = np.zeros(gr.nel + 1, np.int64)
    np.cumsum(sz_new, out=off_new[1:])
    flat_new = np.empty(off_new[-1], dtype=np.int64)
    flat_new[np.repeat(off_new[:-1], sz0) + _ragged_arange(sz0)] = flat
    flat_new[np.repeat(off_new[:-1] + sz0, cnt_el)
             + _ragged_arange(cnt_el)] = add_ids[order]

    th_new = np.concatenate([th, th_mid])
    r_new = np.concatenate([r, r_mid])
    x, z = polar2cartesian(th_new, r_new)
    return Grid2D(
        x=x, z=z, theta=th_new, r=r_new,
        e2n=_flat_to_ragged(flat_new, off_new),
        ntheta=gr.ntheta, nr=gr.nr, nel=gr.nel, nnods=len(x),
        neighbours=gr.neighbours, is_quad=gr.is_quad,
        e2n_flat=flat_new, e2n_off=off_new,
        nbr_flat=gr.nbr_flat, nbr_off=gr.nbr_off,
        dtheta=gr.dtheta,
    )


def _element_centers(gr: Grid2D) -> np.ndarray:
    """Mean radius of the primary vertices of each element.

    Matches src/GridAnnulus.jl:304-311 including the 0.33 (not 1/3)
    triangle factor.
    """
    flat, off = gr.flat_e2n()
    i0 = off[:-1]
    r0, r1, r2 = gr.r[flat[i0]], gr.r[flat[i0 + 1]], gr.r[flat[i0 + 2]]
    # a triangle with no secondary nodes has exactly 3 entries; clamp the
    # 4th read (its value is masked out below)
    r3 = gr.r[flat[np.minimum(i0 + 3, len(flat) - 1)]]
    return np.where(gr.is_quad, (r0 + r1 + r2 + r3) * 0.25,
                    (r0 + r1 + r2) * 0.33)


def find_boundary(center: np.ndarray, rlayer=LAYER_RADII) -> np.ndarray:
    """Layer id of a radius (vectorised src/GridAnnulus.jl:374-381).

    Returns 1 for radii below the deepest boundary, i+1 (1-based) for radii
    between rlayer[i-1] and rlayer[i].
    """
    rl = np.asarray(rlayer)
    center = np.asarray(center)
    out = np.ones(center.shape, dtype=np.int64)
    for i in range(len(rl) - 1):
        between = (rl[i] > center) & (center > rl[i + 1])
        out = np.where(between, i + 2, out)
    return out


def constrain2layers(gr: Grid2D) -> None:
    """Drop element-neighbour links crossing a velocity discontinuity.

    In-place, like src/GridAnnulus.jl:296-321.  Element layer ids come from
    the mean radius of the primary vertices.
    """
    layer = find_boundary(_element_centers(gr))
    nbr_flat, nbr_off = gr.flat_neighbours()
    el_of = np.repeat(np.arange(gr.nel, dtype=np.int64), np.diff(nbr_off))
    keep = layer[nbr_flat] == layer[el_of]
    new_flat = nbr_flat[keep]
    cnt = np.bincount(el_of[keep], minlength=gr.nel).astype(np.int64)
    new_off = np.zeros(gr.nel + 1, np.int64)
    np.cumsum(cnt, out=new_off[1:])
    gr.nbr_flat, gr.nbr_off = new_flat, new_off
    gr.neighbours = _flat_to_ragged(new_flat, new_off)


def discontinuous_boundaries(gr: Grid2D, spacing: float) -> Tuple[Grid2D, np.ndarray]:
    """Double nodes on the 7 discontinuities; build the halo twin table.

    Matches src/GridAnnulus.jl:910-968: scanning elements in order, every
    element whose third vertex radius lies on a discontinuity (i.e. the
    element sits just *below* it) gets its boundary-radius nodes replaced by
    fresh twin nodes offset 0.05 km inward.  Each (element, node) occurrence
    yields its own twin, exactly as the reference counter does.  The halo
    table holds both (original, twin) and (twin, original) rows.
    """
    rl = np.array(DISCONTINUITY_RADII, dtype=np.float64)
    r = gr.r
    nnods = gr.nnods
    dtheta = gr.dtheta_val

    # vectorised equivalent of the reference's sequential element scan:
    # twin ids are assigned in (element, node-position) order, which is
    # exactly the flat e2n storage order
    flat, off = gr.flat_e2n()
    sizes = np.diff(off)
    top = flat[np.minimum(off[:-1] + 2, len(flat) - 1)]
    hit = r[top][:, None] == rl[None, :]                 # (nel, 7)
    eligible = gr.is_quad & hit.any(axis=1)
    # rl value of the FIRST match, like the loop's hit[0]
    b_r = np.where(eligible, rl[np.argmax(hit, axis=1)], np.nan)

    pos_mask = (r[flat] == np.repeat(b_r, sizes))        # NaN never equal
    el_of_pos = np.repeat(np.arange(gr.nel, dtype=np.int64), sizes)
    idx = flat[pos_mask]                                 # originals, in order
    ntw = len(idx)

    flat_new = flat.copy()
    flat_new[pos_mask] = nnods + np.arange(ntw, dtype=np.int64)
    gr.e2n_flat, gr.e2n_off = flat_new, off
    gr.e2n = _flat_to_ragged(flat_new, off)

    # column owning each twin = column of its theta; the creating
    # element's column distinguishes left/right twins of corner nodes
    elem_col = el_of_pos[pos_mask] // (gr.nr - 1)
    node_col = np.floor(np.mod(gr.theta[idx], gr.period) / dtheta
                        + 1e-6).astype(np.int64) % gr.ntheta
    twin_cls = np.where(node_col == elem_col, 1, 2)
    th_twin = gr.theta[idx]
    r_twin = gr.r[idx] - TWIN_OFFSET
    x_twin, z_twin = polar2cartesian(th_twin, r_twin)

    halo = np.empty((2 * ntw, 2), dtype=np.int64)
    twin_ids = nnods + np.arange(ntw)
    halo[:ntw, 0] = idx
    halo[:ntw, 1] = twin_ids
    halo[ntw:, 0] = twin_ids
    halo[ntw:, 1] = idx

    twin_class = np.zeros(nnods + ntw, dtype=np.int8)
    twin_class[nnods:] = np.asarray(twin_cls, dtype=np.int8)

    gr2 = Grid2D(
        x=np.concatenate([gr.x, x_twin]),
        z=np.concatenate([gr.z, z_twin]),
        theta=np.concatenate([gr.theta, th_twin]),
        r=np.concatenate([gr.r, r_twin]),
        e2n=gr.e2n,
        ntheta=gr.ntheta, nr=gr.nr, nel=gr.nel,
        nnods=nnods + ntw,
        neighbours=gr.neighbours, is_quad=gr.is_quad,
        twin_class=twin_class,
        e2n_flat=gr.e2n_flat, e2n_off=gr.e2n_off,
        nbr_flat=gr.nbr_flat, nbr_off=gr.nbr_off,
        dtheta=gr.dtheta,
    )
    return gr2, halo


def node_adjacency(gr: Grid2D, star: int = 1) -> sp.csr_matrix:
    """Node->node adjacency implied by the element-incidence relaxation.

    The reference never flattens this: its relax kernel walks
    elements-of-node -> nodes-of-element two-hop lists with a redundancy
    Set per node (src/SSSP/bfm.jl:113-159, element incidence built at
    src/GridAnnulus.jl:420-452).  Flattening to a deduplicated CSR matrix
    at build time is the TPU-first choice: the device sees only dense,
    static-shape gathers.

    star=0: neighbours = nodes sharing an element (unconstrained_element_
            incidence, src/GridAnnulus.jl:454-471).
    star=1: also nodes of layer-constrained neighbouring elements
            (element_incidence, src/GridAnnulus.jl:420-452) - the default
            used by init_annulus.
    star>1: further powers of the element-neighbour expansion
            (add_star_levels!, src/GridAnnulus.jl:248-258 analogue).

    Uses the native C++ union-merge builder (native/graphbuild.cpp; the
    scipy triple product below performs ~100x more work summing
    duplicate contributions); both produce identical matrices (tested).
    Without g++ on PATH it takes the scipy product; a failed build with
    g++ present raises.
    """
    from ..native import node_adjacency_native_flat

    e2n_flat, e2n_off = gr.flat_e2n()
    nbr_flat, nbr_off = gr.flat_neighbours()
    A = node_adjacency_native_flat(e2n_flat, e2n_off, nbr_flat, nbr_off,
                                   gr.nnods, star)
    if A is not None:
        return A
    return _node_adjacency_scipy(gr, star)


def _node_adjacency_scipy(gr: Grid2D, star: int = 1) -> sp.csr_matrix:
    """The scipy twin of node_adjacency (the same matrix)."""
    rows = np.concatenate([np.full(len(nodes), e, dtype=np.int64) for e, nodes in enumerate(gr.e2n)])
    cols = np.concatenate(gr.e2n)
    inc = sp.csr_matrix((np.ones(len(rows), np.int32), (rows, cols)), shape=(gr.nel, gr.nnods))

    if star == 0:
        eadj = sp.identity(gr.nel, dtype=np.int32, format="csr")
    else:
        nrows = np.concatenate(
            [np.full(len(nbrs), e, dtype=np.int64) for e, nbrs in enumerate(gr.neighbours)]
        ) if gr.nel else np.empty(0, np.int64)
        ncols = np.concatenate(gr.neighbours) if gr.nel else np.empty(0, np.int64)
        nbr = sp.csr_matrix((np.ones(len(nrows), np.int32), (nrows, ncols)), shape=(gr.nel, gr.nel))
        eadj = sp.identity(gr.nel, dtype=np.int32, format="csr") + nbr
        for _ in range(star - 1):
            eadj = eadj @ nbr + eadj
        eadj.data[:] = 1

    A = (inc.T @ (eadj @ inc)).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    A.sort_indices()
    A.data = np.ones(len(A.data), dtype=bool)
    return A


def init_annulus(ntheta: int, nr: int, spacing: float = 20.0, star: int = 1,
                 faithful: bool = False, dtheta: Optional[float] = None):
    """Build grid, adjacency and halo table (src/GridAnnulus.jl:57-70).

    Returns (gr, A, halo): the grid, the node-adjacency CSR matrix (the
    flattened equivalent of the reference's element-incidence graph G) and
    the (2*ntwins, 2) halo twin table.

    faithful=True replicates the reference mesher's duplicated secondary
    nodes (see edge_connectivity_faithful) for mesh-vs-mesh accuracy
    comparisons against the Julia CPU output; default False builds the
    intended deduplicated graph of the same physical task.

    dtheta != None builds a periodic WEDGE of ntheta columns at the given
    pitch (see primary_grid) - the O(M) circulant builder's substrate
    (models/fast_annulus.py); normal callers leave it None.
    """
    gr = primary_grid(ntheta, nr, R, dtheta=dtheta)
    gr = secondary_nodes(gr, spacing=spacing, faithful=faithful)
    constrain2layers(gr)
    gr, halo = discontinuous_boundaries(gr, spacing)
    A = node_adjacency(gr, star=star)
    return gr, A, halo


def closest_point(gr: Grid2D, px: float, pz: float, system: str = "cartesian") -> int:
    """Index of the grid node closest to (px, pz) (src/GridAnnulus.jl:823-840).

    With system='polar' the scan runs in raw (theta, r) coordinates, exactly
    like the reference (Euclidean metric on the polar components).
    """
    if system == "cartesian":
        vx, vz = gr.x, gr.z
    elif system == "polar":
        vx, vz = gr.theta, gr.r
    else:
        raise ValueError("system must be 'cartesian' or 'polar'")
    return int(np.argmin((vx - px) ** 2 + (vz - pz) ** 2))


def circle(n: int, radius: float, pop_end: bool = True, system: str = "cartesian"):
    """n points on a circle (src/GridAnnulus.jl:842-856)."""
    t = np.linspace(0, 2 * np.pi, n)
    if system == "cartesian":
        x, z = radius * np.sin(t), radius * np.cos(t)
    else:
        x, z = t, np.full(n, float(radius))
    if pop_end:
        x, z = x[:-1], z[:-1]
    return x, z


def point_ids(gr: Grid2D) -> np.ndarray:
    """Label nodes 'outter'/'inner'/'inside' (src/GridAnnulus.jl:727-748)."""
    rmin, rmax = gr.r.min(), gr.r.max()
    out = np.full(gr.nnods, "inside", dtype=object)
    out[gr.r == rmax] = "outter"
    out[gr.r == rmin] = "inner"
    return out
