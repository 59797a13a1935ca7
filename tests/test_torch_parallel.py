"""PyTorch port: the source-sharded tables and the sharded bend against
the JAX package.

The port's parallel/multisource.py and refine_shard.py run on one
8-rank gloo group on the CPU for the whole module (`launch.run_group`),
the JAX package's on the 8 virtual CPU devices of tests/conftest.py
while the ranks run (tests/torch_group.py: both once a run);
the cases are tests/test_parallel.py's, on the tiny annulus (16x6,
spacing 200) and a 6x6x5 3-D wedge, with 5 sources on 8 ranks (padding)
and the centre node.  Each rank runs the port's single-device engine on
its block, so a table equals the JAX package's sharded one as the
engines equal it: the ELL and circulant tables and the 3-D xla and sweep
tables bit for bit in float64 (the same additions and minima), the
theta-major and sweep tables (float32, whose Pallas kernels the JAX
package runs in interpret mode) within 1e-4 s, the float32 ulp at
~1000 s being 6e-5 s; the 3-D kernel engine within 1e-9 s.  The sharded
bend follows the JAX package's 50 steps within 1e-6 s and 1e-4 km, the
tolerance tests/test_torch_refine.py holds `refine_paths_batch` to, and
equals the port's unsharded bend.  Every rank returns the same table.
"""
import numpy as np
import pytest

import raytracer_tpu as rt
import raytracer_tpu.parallel as jpar
from raytracer_tpu.config import R, SolverConfig as JConfig
from raytracer_tpu.ops.circulant import build_circulant as jbuild
import raytracer_tpu_torch as pt
import raytracer_tpu_torch.parallel as ppar
from raytracer_tpu_torch.models.grid3d import grid3d
from raytracer_tpu_torch.parallel import launch, mesh as pm
from raytracer_tpu_torch.solvers import bfm as pbfm
from raytracer_tpu_torch.solvers.solve3d import prepare3d

import torch_group

J64, J32 = JConfig(dtype="float64"), JConfig(dtype="float32")
P64, P32 = pt.SolverConfig(dtype="float64"), pt.SolverConfig(dtype="float32")
WORLD = torch_group.WORLD
F32_ATOL = 1e-4
BEND = dict(m=48, iters=50, lr=3.0, quad=8)
BEND_TOL = (1e-6, 1e-4)        # s, km: test_torch_refine's 50-step lockstep


def _deg(gr, *degs):
    return [pt.closest_point(gr, np.deg2rad(d), R, system="polar")
            for d in degs]


@pytest.fixture(scope="module")
def tiny():
    """The tiny annulus and AK135 Vp in the port (the JAX fixture's
    twin: the host builders are copies, tests/test_torch_grid.py)."""
    gr, A, halo = pt.init_annulus(16, 6, spacing=200.0)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r,
                                                             prof.Vp))
    return gr, A, halo, U


def _wedge(mod):
    c0 = (np.deg2rad(70.0), np.deg2rad(70.0), R - 2000.0)
    c1 = (np.deg2rad(110.0), np.deg2rad(110.0), R)
    g = mod.grid3d(c0, c1, (6, 6, 5))
    prof = mod.velocity_profile()
    return g, mod.LinearInterpolation(prof.r, prof.Vp)(g.r)


@pytest.fixture(scope="module")
def fan(tiny):
    """Five SPM paths of the tiny annulus (from the port's circulant
    solve, as test_parallel takes the JAX one's)."""
    gr, A, halo, U = tiny
    solver = pt.AnnulusSolver(gr, A, halo, U, P64, method="circulant",
                              device="cpu")
    src = pt.closest_point(gr, 0.0, R, system="polar")
    D = solver.solve(src)
    return [np.stack([gr.x[p], gr.z[p]], axis=1)
            for p in (pt.recontruct_path(D.prev, src, r)
                      for r in _deg(gr, 30.0, 60.0, 90.0, 120.0, 150.0))]


def _jdeg(gr, *degs):
    return [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
            for d in degs]


def _references(tiny, fan, tiny_annulus, tiny_velocity):
    """The JAX package's results for every test, and the port's
    single-device bend and locator fields."""
    gr, A, halo = tiny_annulus
    mesh = jpar.make_mesh()
    out = {}
    g = rt.prepare(A, halo, gr, tiny_velocity, J64)
    out["ell"] = jpar.travel_time_table(
        g, _jdeg(gr, 0.0, 20.0, 45.0, 90.0, 135.0),
        _jdeg(gr, 30.0, 60.0, 180.0), J64, mesh)
    cg = jbuild(gr, A, halo, tiny_velocity, dtype=np.float64)
    out["circ"] = jpar.travel_time_table_circulant(
        cg, _jdeg(gr, 0.0, 60.0, 120.0), _jdeg(gr, 30.0, 180.0), J64, mesh)
    cg = jbuild(gr, A, halo, tiny_velocity, dtype=np.float32)
    srcs = _jdeg(gr, 0.0, 60.0, 120.0, 250.0, 333.0) + [cg.cmap.center]
    recs = _jdeg(gr, 30.0, 180.0) + [cg.cmap.center]
    for engine in ("twrapped", "sweep"):
        fn = getattr(jpar, f"travel_time_table_{engine}")
        out[engine] = fn(cg, srcs, recs, J32, mesh, interpret=True)
    from raytracer_tpu.solvers.solve3d import prepare3d as jprep

    g3, U3 = _wedge(rt)
    packed = jprep(g3, U3, J64)
    for engine in ("xla", "pallas", "sweep"):
        out[f"3d_{engine}"] = jpar.travel_time_table_3d(
            packed, [0, 17, len(g3) // 2, len(g3) - 1, 33],
            [1, len(g3) // 3, len(g3) - 2], J64, mesh, engine=engine,
            interpret=engine == "pallas")
    prof = rt.velocity_profile("ak135")
    Pj, tj = jpar.refine_paths_sharded(fan, prof.r, prof.Vp, mesh=mesh,
                                       **BEND)
    out["bend"] = (np.asarray(Pj), np.asarray(tj))
    out["bend_batch"] = pt.refine_paths_batch(fan, prof.r, prof.Vp,
                                              device="cpu", **BEND)
    pgr, pA, phalo, pU = tiny
    solver = pt.AnnulusSolver(pgr, pA, phalo, pU, P64, method="circulant",
                              device="cpu")
    out["locator_fields"] = pt.station_fields(
        solver, _deg(pgr, 0.0, 70.0, 150.0, 230.0, 310.0))
    return out


@pytest.fixture(scope="module")
def made(request, tmp_path_factory, tiny, fan, tiny_annulus, tiny_velocity):
    """Every sharded call of the module in one 8-rank gloo group, and the
    references, made while the ranks run."""
    gr, A, halo, U = tiny
    c = launch.call
    mesh = c(pm.make_mesh, device="cpu")
    g64 = c(pbfm.prepare, A, halo, gr, U, P64, device="cpu")
    cg64 = pt.build_circulant(gr, A, halo, U, dtype=np.float64)
    cg32 = pt.build_circulant(gr, A, halo, U, dtype=np.float32)
    srcs5 = _deg(gr, 0.0, 20.0, 45.0, 90.0, 135.0)
    srcs6 = _deg(gr, 0.0, 60.0, 120.0, 250.0, 333.0) + [cg32.cmap.center]
    recs3 = _deg(gr, 30.0, 180.0) + [cg32.cmap.center]
    g3, U3 = _wedge(pt)
    packed = prepare3d(g3, U3, P64, device="cpu")
    s3 = [0, 17, len(g3) // 2, len(g3) - 1, 33]
    r3 = [1, len(g3) // 3, len(g3) - 2]
    prof = pt.velocity_profile("ak135")
    stations = _deg(gr, 0.0, 70.0, 150.0, 230.0, 310.0)
    calls = {
        "size": c(getattr, mesh, "size"),
        "ell": c(ppar.travel_time_table, g64, srcs5,
                 _deg(gr, 30.0, 60.0, 180.0), P64, mesh),
        "recip": c(ppar.travel_time_table, g64, _deg(gr, 10.0, 110.0),
                   _deg(gr, 10.0, 110.0), P64, mesh),
        "state": c(ppar.solve_sharded, g64, srcs5[:3], P64, mesh),
        "circ": c(ppar.travel_time_table_circulant, cg64,
                  _deg(gr, 0.0, 60.0, 120.0), _deg(gr, 30.0, 180.0), P64,
                  mesh),
        "twrapped": c(ppar.travel_time_table_twrapped, cg32, srcs6, recs3,
                      P32, mesh),
        "sweep": c(ppar.travel_time_table_sweep, cg32, srcs6, recs3, P32,
                   mesh),
        "3d_xla": c(ppar.travel_time_table_3d, packed, s3, r3, P64, mesh),
        "3d_pallas": c(ppar.travel_time_table_3d, packed, s3, r3, P64, mesh,
                       engine="pallas"),
        "3d_sweep": c(ppar.travel_time_table_3d, packed, s3, r3, P64, mesh,
                      engine="sweep"),
        "fields": c(ppar.travel_time_table_circulant, cg64, stations,
                    np.arange(gr.nnods), P64, mesh),
        "bend": c(ppar.refine_paths_sharded, fan, prof.r, prof.Vp,
                  mesh=mesh, **BEND),
    }
    res, refs = torch_group.once(
        request, tmp_path_factory, "parallel", calls.values(),
        lambda: _references(tiny, fan, tiny_annulus, tiny_velocity))
    out = {}
    for i, k in enumerate(calls):
        got = [r[i] for r in res]
        for r in got[1:]:        # every rank returns the whole result
            if isinstance(r, tuple):
                for a, b in zip(r, got[0]):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))
            elif k != "state":
                np.testing.assert_array_equal(r, got[0])
        out[k] = got[0]
    return out, refs


@pytest.fixture(scope="module")
def port(made):
    return made[0]


@pytest.fixture(scope="module")
def want(made):
    return made[1]


def test_group_has_8_ranks(port):
    assert port["size"] == WORLD


def test_exports_are_the_jax_packages():
    names = {n for n in dir(jpar) if not n.startswith("_")
             and not isinstance(getattr(jpar, n), type(jpar))}
    mine = {n for n in dir(ppar) if not n.startswith("_")
            and not isinstance(getattr(ppar, n), type(ppar))}
    assert mine == names


def test_pad_sources():
    out = ppar.pad_sources(np.array([3, 4, 5]), 8)
    assert len(out) == 8
    assert list(out[:3]) == [3, 4, 5]
    assert np.all(out[3:] == 5)
    np.testing.assert_array_equal(out, jpar.pad_sources(np.array([3, 4, 5]),
                                                        8))


def test_sharded_table_matches_jax(tiny_annulus, port, want):
    gr, _, _ = tiny_annulus
    recs = _jdeg(gr, 30.0, 60.0, 180.0)
    np.testing.assert_array_equal(port["ell"], want["ell"])
    # the state keeps the padded source axis: 3 sources on 8 ranks
    st = port["state"]
    assert st.dist.shape[0] == WORLD
    np.testing.assert_array_equal(st.dist[:3, np.asarray(recs)].numpy(),
                                  want["ell"][:3])


def test_reciprocity(port):
    t = port["recip"]
    np.testing.assert_allclose(t[0, 1], t[1, 0], rtol=1e-10)


def test_sharded_circulant_table(port, want):
    assert port["circ"].shape == (3, 2) and port["circ"].dtype == np.float64
    np.testing.assert_array_equal(port["circ"], want["circ"])


@pytest.mark.parametrize("engine", ["twrapped", "sweep"])
def test_sharded_kernel_tables(port, want, engine):
    """5 sources plus the centre on 8 ranks, float32, against the JAX
    package's sharded table with its Pallas kernel in interpret mode."""
    got = port[engine]
    assert got.shape == want[engine].shape == (6, 3)
    np.testing.assert_allclose(got, want[engine], atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("engine", ["xla", "pallas", "sweep"])
def test_sharded_3d_table(port, want, engine):
    got = port[f"3d_{engine}"]
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want[f"3d_{engine}"], atol=1e-9, rtol=0)


def test_locate_with_sharded_station_fields(tiny, port, want):
    """The locator consumes the station fields of the port's sharded
    circulant table and recovers an on-grid event."""
    gr, A, halo, U = tiny
    stations = _deg(gr, 0.0, 70.0, 150.0, 230.0, 310.0)
    fields = np.asarray(port["fields"], np.float64)
    solver = pt.AnnulusSolver(gr, A, halo, U, P64, method="circulant",
                              device="cpu")
    np.testing.assert_array_equal(fields, want["locator_fields"])
    true = pt.closest_point(gr, np.deg2rad(120.0), R - 900.0, system="polar")
    loc = pt.locate(solver, stations, fields[:, true] + 3.0, refine=False,
                    fields=fields)
    np.testing.assert_allclose([gr.x[loc.node], gr.z[loc.node]],
                               [gr.x[true], gr.z[true]], atol=1.0)
    assert abs(loc.t0 - 3.0) < 1e-6


def test_sharded_bend_matches_jax(port, want):
    Pj, tj = want["bend"]
    Ps, ts = port["bend"]
    assert ts.shape == (5,) and Ps.shape == Pj.shape
    t_tol, p_tol = BEND_TOL
    assert float(np.abs(ts - tj).max()) <= t_tol
    assert float(np.abs(Ps - Pj).max()) <= p_tol
    Pb, tb = want["bend_batch"]
    np.testing.assert_array_equal(ts, tb)
    np.testing.assert_array_equal(Ps, Pb)
