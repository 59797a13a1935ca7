"""PyTorch port: the generic-graph host builders equal the JAX package's.

The port keeps its own copies of the ELL layout and its helpers
(ops/graph.py), the edge weights (ops/weights.py, evaluated on the real
slots only), `node_adjacency` and the Delaunay mesher; these tests hold
every copy equal, bit for bit and dtype for dtype, to the original on the
16x6 annulus (with its halo twins), the small Delaunay mesh and its
structured and unstructured variants.
"""
import numpy as np
import pytest
import scipy.sparse as sp

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.models import annulus as jann
from raytracer_tpu.models import delaunay as jdel
from raytracer_tpu.ops import graph as jgraph
from raytracer_tpu.ops import weights as jw
from raytracer_tpu_torch.models import annulus as pann
from raytracer_tpu_torch.models import delaunay as pdel
from raytracer_tpu_torch.ops import graph as pgraph
from raytracer_tpu_torch.ops import relax as prelax
from raytracer_tpu_torch.ops import weights as pw
from jax_mappings import below_the_map_limit  # noqa: F401,E402


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b, equal_nan=True), what


def _same_csr(A, B):
    assert A.shape == B.shape
    _same(A.indptr, B.indptr, "indptr")
    _same(A.indices, B.indices, "indices")
    _same(A.data, B.data, "data")


@pytest.fixture(scope="module")
def annulus():
    gr, A, halo = rt.init_annulus(16, 6, spacing=200.0)
    prof = rt.velocity_profile("ak135")
    Vp = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r, prof.Vp))
    Vs = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r, prof.Vs))
    U2 = rt.dual_velocity(gr.r, rt.LinearInterpolation(prof.r, prof.Vp))
    return gr, A, halo, {"Vp": Vp, "Vs": Vs, "dual": U2}


@pytest.fixture(scope="module")
def delaunay():
    jg = jdel.add_midpoints(jdel.triangle_annulus_2d(nr=12, spacing=500.0))
    pg = pdel.add_midpoints(pdel.triangle_annulus_2d(nr=12, spacing=500.0))
    return jg, pg


@pytest.mark.parametrize("pads", [(1024, 8), (1, 1), (512, 4), (64, 16)],
                         ids=lambda p: f"node{p[0]}_deg{p[1]}")
def test_csr_to_ell(annulus, pads):
    _, A, _, _ = annulus
    je = jgraph.csr_to_ell(A, node_pad=pads[0], degree_pad=pads[1])
    pe = pgraph.csr_to_ell(A, node_pad=pads[0], degree_pad=pads[1])
    _same(pe.nbr, je.nbr, "nbr")
    _same(pe.mask, je.mask, "mask")
    assert (pe.n, pe.n_pad, pe.k) == (je.n, je.n_pad, je.k)
    _same(pe.degrees, je.degrees, "degrees")


def test_rcm_and_permute_graph(annulus):
    _, A, _, _ = annulus
    perm = pgraph.rcm_permutation(A)
    _same(perm, jgraph.rcm_permutation(A), "rcm")
    _same_csr(pgraph.permute_graph(A, perm), jgraph.permute_graph(A, perm))


def test_tile_permutation_and_degree(annulus):
    gr, A, _, _ = annulus
    _same(pgraph.tile_permutation(gr), jgraph.tile_permutation(gr), "tile")
    _same(pgraph.nodal_degree(A), jgraph.nodal_degree(A), "degree")


def test_adjacency_lists(annulus):
    _, A, _, _ = annulus
    ps, js = pgraph.sparse_adjacency_list(A), jgraph.sparse_adjacency_list(A)
    for f in ("list", "deg", "idx"):
        _same(getattr(ps, f), getattr(js, f), f)
    pa, ja = pgraph.adjacency_list(A), jgraph.adjacency_list(A)
    _same(pa.G, ja.G, "G")
    _same(pa.N, ja.N, "N")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("vel", ["Vp", "Vs", "dual"])
def test_edge_weights_annulus(annulus, vel, dtype):
    """The real-slot evaluation gives the JAX package's full-slot floats,
    the S-wave zero-velocity core (+inf weights) included."""
    gr, A, _, U = annulus
    ell = pgraph.csr_to_ell(A)
    jell = jgraph.csr_to_ell(A)
    fn = "edge_weights_dual" if vel == "dual" else "edge_weights_scalar"
    got = getattr(pw, fn)(gr, ell, U[vel], dtype=np.dtype(dtype))
    want = getattr(jw, fn)(gr, jell, U[vel], dtype=np.dtype(dtype))
    _same(got, want, f"{fn} {vel} {dtype}")
    if vel == "Vs":
        assert np.isinf(got[ell.mask]).any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_edge_weights_3d(dtype):
    g = rt.grid3d((1.4, 1.4, rt.R - 600.0), (1.7, 1.7, rt.R), (6, 5, 4))
    A = rt.nodal_incidence3d(g)
    prof = rt.velocity_profile("ak135")
    U = rt.LinearInterpolation(prof.r, prof.Vp)(g.r)
    got = pw.edge_weights_scalar(g, pgraph.csr_to_ell(A), U,
                                 dtype=np.dtype(dtype))
    want = jw.edge_weights_scalar(g, jgraph.csr_to_ell(A), U,
                                  dtype=np.dtype(dtype))
    _same(got, want, f"3-D weights {dtype}")


def test_edge_weights_delaunay(delaunay):
    jg, pg = delaunay
    A = pann.node_adjacency(pg, star=0)
    prof = rt.velocity_profile("ak135")
    U = rt.interpolate_velocity(jg.r, rt.LinearInterpolation(prof.r, prof.Vp))
    _same(pw.edge_weights_scalar(pg, pgraph.csr_to_ell(A), U),
          jw.edge_weights_scalar(jg, jgraph.csr_to_ell(A), U), "weights")


@pytest.mark.parametrize("star", [0, 1, 2])
def test_node_adjacency(annulus, star):
    gr, _, _, _ = annulus
    pgr, _, _ = pt.init_annulus(16, 6, spacing=200.0)
    _same_csr(pann.node_adjacency(pgr, star=star),
              jann.node_adjacency(gr, star=star))


@pytest.mark.parametrize("star", [0, 1])
def test_node_adjacency_delaunay(delaunay, star):
    jg, pg = delaunay
    _same_csr(pann.node_adjacency(pg, star=star),
              jann.node_adjacency(jg, star=star))


def _same_grid(pg, jg):
    for f in ("x", "z", "theta", "r", "is_quad"):
        _same(getattr(pg, f), getattr(jg, f), f)
    assert (pg.ntheta, pg.nr, pg.nel, pg.nnods) == \
        (jg.ntheta, jg.nr, jg.nel, jg.nnods)
    assert len(pg.e2n) == len(jg.e2n)
    for a, b in zip(pg.e2n, jg.e2n):
        _same(a, b, "e2n")
    assert len(pg.neighbours) == len(jg.neighbours)
    for a, b in zip(pg.neighbours, jg.neighbours):
        _same(a, b, "neighbours")


MESHES = {
    "layered": dict(nr=12, spacing=500.0),
    "layered_unaligned": dict(nr=8, spacing=700.0, layered=False),
    "structured": dict(mesh_type="structured", nsurf=40, nx=15, nz=15),
    "unstructured": dict(mesh_type="unstructured", nsurf=30,
                         max_area=400_000.0),
}


@pytest.mark.parametrize("mode", sorted(MESHES))
def test_triangle_annulus_2d(mode):
    _same_grid(pdel.triangle_annulus_2d(**MESHES[mode]),
               jdel.triangle_annulus_2d(**MESHES[mode]))


@pytest.mark.parametrize("npoints", [1, 2])
def test_add_midpoints(npoints):
    kw = MESHES["layered"]
    _same_grid(pdel.add_midpoints(pdel.triangle_annulus_2d(**kw), npoints),
               jdel.add_midpoints(jdel.triangle_annulus_2d(**kw), npoints))


def test_point_sets():
    _same(pdel.structured_convex_hull(40, 15, 15),
          jdel.structured_convex_hull(40, 15, 15), "structured")
    _same(pdel.unstructured_constrained_domain(30, 400_000.0),
          jdel.unstructured_constrained_domain(30, 400_000.0), "unstructured")
    _same(pdel.ring_points([1000.0, 3000.0], 500.0),
          jdel.ring_points([1000.0, 3000.0], 500.0), "rings")


def test_element_neighbours(delaunay):
    jg, _ = delaunay
    got = pann.element_neighbours(jg.e2n, jg.nnods - 1)
    want = jann.element_neighbours(jg.e2n, jg.nnods - 1)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b, "element neighbours")


def test_halo_by_destination(annulus):
    """The kernels' halo groups: every non-self row once, grouped by
    destination, in table order within a group."""
    _, _, halo, _ = annulus
    hs = np.concatenate([halo[:, 0], [0, 0, 5]]).astype(np.int32)
    hd = np.concatenate([halo[:, 1], [0, 0, halo[0, 1]]]).astype(np.int32)
    n_pad = 4096
    didx, hoff, hsrc = pgraph.halo_by_destination(hs, hd, n_pad)
    seen = []
    for d in range(n_pad):
        rows = [h for h in range(len(hs)) if hd[h] == d and hs[h] != d]
        if not rows:
            assert didx[d] == -1
            continue
        g = didx[d]
        assert list(hsrc[hoff[g]:hoff[g + 1]]) == [hs[h] for h in rows]
        seen += rows
    assert sorted(seen) == [h for h in range(len(hs)) if hs[h] != hd[h]]
    assert (didx[hd[hs != hd]] >= 0).all()


def test_row_degrees(annulus):
    """deg[i] is one past the last slot that does not point at row i: the
    CSR degree on an ELL of node_adjacency (no self loops)."""
    _, A, _, _ = annulus
    ell = pgraph.csr_to_ell(A)
    deg = prelax.row_degrees(ell.nbr)
    assert deg.dtype == np.int32
    _same(deg[: ell.n], np.diff(A.indptr).astype(np.int32), "deg")
    assert (deg[ell.n:] == 0).all()
    # a row whose last real neighbour is slot 2 of 4, a self slot between
    nbr = np.array([[1, 0, 2, 0], [1, 1, 1, 1], [0, 1, 2, 2]], np.int32)
    _same(prelax.row_degrees(nbr), np.array([3, 0, 2], np.int32), "deg")


def test_weights_of_a_graph_with_unsorted_rows():
    """csr_to_ell keeps each row's CSR order; the real-slot weights follow
    it on a matrix whose indices are not sorted."""
    rng = np.random.default_rng(3)
    n = 40
    rows = np.repeat(np.arange(n), 5)
    cols = rng.integers(0, n, rows.size)
    keep = rows != cols
    A = sp.csr_matrix((np.ones(keep.sum(), bool), (rows[keep], cols[keep])),
                      shape=(n, n))
    A.indices = A.indices.copy()
    for i in range(n):      # reverse every row's indices
        a, b = A.indptr[i], A.indptr[i + 1]
        A.indices[a:b] = A.indices[a:b][::-1]
    A.has_sorted_indices = False

    class G:
        x = rng.uniform(-1e3, 1e3, n)
        z = rng.uniform(-1e3, 1e3, n)
        r = np.hypot(x, z)

    U = rng.uniform(3.0, 9.0, n)
    _same(pw.edge_weights_scalar(G, pgraph.csr_to_ell(A), U),
          jw.edge_weights_scalar(G, jgraph.csr_to_ell(A), U), "weights")
