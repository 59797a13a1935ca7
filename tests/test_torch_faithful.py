"""PyTorch port: the reference-faithful mesh against the JAX package's.

`init_annulus(..., faithful=True)` reproduces the reference mesher's
duplicated coincident secondary nodes (`edge_connectivity_faithful`).
The port's copy is held bit for bit to the JAX package's at 16x6 and
36x12; at 180x50 spacing 50 its counts and digests (the quantities of
`benchmarks/faithful_digests.json`) are computed here by both packages
and compared; the port's float64 sweep on the faithful 36x12 mesh
equals the JAX package's in its round count, and its receiver walks
reach the source as often.
"""
import hashlib

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.models import annulus as j_ann
from raytracer_tpu_torch.models import annulus as p_ann
from raytracer_tpu_torch.ops.wrapped_t import supports_twrapped
from jax_mappings import below_the_map_limit  # noqa: F401,E402

MESHES = {"16x6": (16, 6, 200.0), "36x12": (36, 12, 100.0)}
FIELDS = ("x", "z", "theta", "r", "twin_class", "is_quad", "e2n_flat",
          "e2n_off", "nbr_flat", "nbr_off", "A", "halo")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers,
    and the twins' many small ops slow down badly when each worker's
    thread pool competes for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    nt, nr, spacing = MESHES[request.param]
    return (rt.init_annulus(nt, nr, spacing=spacing, faithful=True),
            pt.init_annulus(nt, nr, spacing=spacing, faithful=True))


def _field(mesh, name):
    gr, A, halo = mesh
    if name == "A":
        return np.concatenate([A.indptr, A.indices])
    if name == "halo":
        return halo
    if name in ("e2n_flat", "e2n_off"):
        return gr.flat_e2n()[name == "e2n_off"]
    if name in ("nbr_flat", "nbr_off"):
        return gr.flat_neighbours()[name == "nbr_off"]
    return getattr(gr, name)


@pytest.mark.parametrize("name", FIELDS)
def test_faithful_mesh_equals_the_jax_one(meshes, name):
    a, b = _field(meshes[0], name), _field(meshes[1], name)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_faithful_mesh_duplicates_the_secondary_nodes(meshes):
    """The faithful mesh holds more nodes than the deduplicated one of the
    same grid, and every extra node sits on a node of the deduplicated
    mesh (the duplicates are coincident)."""
    gr, A, halo = meshes[1]
    nt, nr, spacing = [v for v in MESHES.values() if v[0] == gr.ntheta][0]
    dd, _, _ = pt.init_annulus(nt, nr, spacing=spacing)
    assert gr.nnods > dd.nnods
    have = {(round(x, 6), round(z, 6)) for x, z in zip(dd.x, dd.z)}
    assert all((round(x, 6), round(z, 6)) in have for x, z in zip(gr.x, gr.z))


@pytest.mark.parametrize("faithful", [False, True],
                         ids=["unique", "faithful"])
def test_edge_connectivity_equals_the_jax_one(faithful):
    """edge_connectivity (unique edges) and edge_connectivity_faithful
    (the reference's duplicated list) on the 16x6 primary grid."""
    jg = j_ann.primary_grid(16, 6, rt.R)
    pg = p_ann.primary_grid(16, 6, pt.R)
    fn = "edge_connectivity_faithful" if faithful else "edge_connectivity"
    je, jel = getattr(j_ann, fn)(jg)
    pe, pel = getattr(p_ann, fn)(pg)
    np.testing.assert_array_equal(je, pe)
    assert len(jel) == len(pel)
    for a, b in zip(jel, pel):
        np.testing.assert_array_equal(a, b)
    if faithful:   # the duplicated edges
        assert len(pe) > len(np.unique(pe, axis=0))


def _digests(mesh):
    gr, A, halo = mesh

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    return {"nodes": gr.nnods, "edges": A.nnz, "halo_rows": len(halo),
            "r_sorted_sha256_16": digest(np.sort(np.round(gr.r, 6))),
            "degree_hist_sha256_16": digest(np.bincount(np.diff(A.indptr)))}


@pytest.fixture(scope="module")
def digests_180x50():
    return (_digests(rt.init_annulus(180, 50, spacing=50.0, faithful=True)),
            _digests(pt.init_annulus(180, 50, spacing=50.0, faithful=True)))


@pytest.mark.parametrize("key", ["nodes", "edges", "halo_rows",
                                 "r_sorted_sha256_16",
                                 "degree_hist_sha256_16"])
def test_faithful_180x50_digests_equal_the_jax_build(digests_180x50, key):
    """The quantities of the frozen Julia cross-check, computed here by
    both packages (71,101 nodes, 6,793,560 directed edges, 13,320 halo
    rows at this grid)."""
    j, p = digests_180x50
    assert p[key] == j[key]
    assert p["nodes"] == 71101 and p["edges"] == 6793560 \
        and p["halo_rows"] == 13320


def _reaching(prev, source, receivers) -> int:
    count = 0
    for node in receivers:
        seen = set()
        while node != source and node not in seen:
            seen.add(node)
            node = int(prev[node])
        count += node == source
    return count


@pytest.fixture(scope="module")
def faithful_solves():
    """The float64 sweep on the faithful 36x12 mesh (spacing 100), once a
    module: the JAX package's (interpret mode) and the port's CPU route."""
    gr, A, halo = pt.init_annulus(36, 12, spacing=100.0, faithful=True)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r,
                                                            prof.Vp))
    src = pt.closest_point(gr, 0.0, pt.R, system="polar")
    degs = np.arange(2.0, 152.0, 2.0)
    recs = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
            for d in np.concatenate([degs, 360.0 - degs[::-1]])]
    jgr, jA, jhalo = rt.init_annulus(36, 12, spacing=100.0, faithful=True)
    js = rt.AnnulusSolver(jgr, jA, jhalo, U, rt.SolverConfig(dtype="float64"),
                          method="sweep")
    jD = js.solve(src)
    ps = pt.AnnulusSolver(gr, A, halo, U, pt.SolverConfig(dtype="float64"),
                          method="sweep", device="cpu")
    pD = ps.solve(src)
    return dict(gr=gr, A=A, halo=halo, U=U, src=src, recs=recs, js=js,
                jD=jD, ps=ps, pD=pD)


def test_faithful_sweep_equals_the_jax_one(faithful_solves):
    """float64 (tol 0): the same field at every node in the JAX package's
    round count."""
    f = faithful_solves
    tol = pt.SolverConfig(dtype="float64").tol_value()
    np.testing.assert_allclose(f["pD"].dist, np.asarray(f["jD"].dist),
                               rtol=0, atol=tol)
    assert f["ps"].last_iterations == f["js"].last_iterations
    assert np.isfinite(f["pD"].dist).all()


def test_faithful_walks_reach_the_source_as_the_jax_ones(faithful_solves):
    """The zero-weight links of the duplicated nodes (ROADMAP C.9): as
    many of the 150 receiver walks reach the source as in the JAX
    package."""
    f = faithful_solves
    assert _reaching(f["pD"].prev, f["src"], f["recs"]) == \
        _reaching(np.asarray(f["jD"].prev), f["src"], f["recs"])


def test_faithful_routes_to_the_sweep_and_twrapped_agrees(faithful_solves):
    """auto takes the sweep on the faithful mesh (its circulant layout
    supports it); twrapped on the CPU lands on the sweep's float64 field
    at the receivers."""
    f = faithful_solves
    assert supports_twrapped(f["ps"].circulant)
    auto = pt.AnnulusSolver(f["gr"], f["A"], f["halo"], f["U"],
                            method="auto", device="cpu")
    assert auto.method == "sweep"
    tw = pt.AnnulusSolver(f["gr"], f["A"], f["halo"], f["U"],
                          pt.SolverConfig(dtype="float64"),
                          method="twrapped", device="cpu")
    d = tw.solve(f["src"], want_prev=False).dist
    np.testing.assert_allclose(d[f["recs"]], f["pD"].dist[f["recs"]],
                               rtol=0, atol=1e-9)


def test_circle_and_point_ids_equal_the_jax_ones():
    for pop_end in (True, False):
        for system in ("cartesian", "polar"):
            for a, b in zip(j_ann.circle(37, 3480.0, pop_end, system),
                            pt.circle(37, 3480.0, pop_end, system)):
                np.testing.assert_array_equal(a, b)
    gr, _, _ = pt.init_annulus(16, 6, spacing=200.0, faithful=True)
    jg, _, _ = rt.init_annulus(16, 6, spacing=200.0, faithful=True)
    np.testing.assert_array_equal(pt.point_ids(gr), rt.point_ids(jg))
    assert set(pt.point_ids(gr)) == {"outter", "inner", "inside"}
