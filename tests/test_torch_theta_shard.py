"""PyTorch port: the theta-sharded sweep solve against the JAX package.

The port's parallel/theta_shard.py runs on an 8-rank gloo group on the
CPU (one group for the module, `launch.run_group`), the JAX package's on
the 8 virtual CPU devices of tests/conftest.py while the ranks run
(tests/torch_group.py: both once a run), both on the 48x12 annulus
(spacing 150 km) in float64.  The block sweeps, the
fan's minimum, the halo carries and the vote are the JAX package's
arithmetic op for op, so the fields must be equal bit for bit and the
round counts equal on the same D (a swapped halo carry would still reach
the fixpoint at tol, but in another number of rounds).  The cases are
tests/test_theta_shard.py's: D = 8 and D = 4 (with receivers), an
indivisible mesh, the 2-D meshes 2x4 and 4x2, the staged PcP stages on
16x6 (D = 4), the sharded station fields on 24x8 (2x2); and D = 2 and
D = 1, where the two ring neighbours are one rank and the ring is the
block's own wrap.  Where the JAX package's own 2-D mesh cannot run in
float64 (ROADMAP C.14), its D = 2 theta-sharded solve of each row's
sources is the reference.
"""
import numpy as np
import pytest

import raytracer_tpu as rt
from raytracer_tpu.config import R, SolverConfig as JConfig
from raytracer_tpu.parallel import theta_shard as jts
from raytracer_tpu.solvers import phases as jph
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.parallel import launch, mesh as pm
from raytracer_tpu_torch.parallel import theta_shard as pts
from raytracer_tpu_torch.solvers import phases as pph

import jax
import torch_group

J64 = JConfig(dtype="float64")
P64 = pt.SolverConfig(dtype="float64")
WORLD = torch_group.WORLD


def _cpu_mesh(maker, *args, **kw):
    return launch.call(maker, *args, device="cpu", **kw)


def _sources(gr, cg):
    return [pt.closest_point(gr, 0.0, R, system="polar"),
            pt.closest_point(gr, np.deg2rad(113.0), 4000.0, system="polar"),
            cg.cmap.center]


@pytest.fixture(scope="module")
def grids():
    jgr, jcg, _ = rt.init_annulus_circulant(48, 12, 150.0, dtype=np.float64)
    gr, cg, _ = pt.init_annulus_circulant(48, 12, 150.0, dtype=np.float64)
    return jgr, jcg, gr, cg


def _staged_problem(name):
    """The PcP stages (down leg, reflected) on 16x6 in one package."""
    mod, pk = (rt, jph) if name == "jax" else (pt, pph)
    prof = rt.velocity_profile("ak135")
    gr, A, halo = mod.init_annulus(16, 6, spacing=200.0)
    U = mod.interpolate_velocity(gr.r, mod.LinearInterpolation(
        prof.r, prof.Vp))
    src = mod.closest_point(gr, 0.0, R, system="polar")
    k = pk.REFLECTORS["cmb"]
    if name == "jax":
        cg, ws, static, tables, lane, keep, hm = jph._phase_setup(
            A, halo, gr, U, k, J64, engine="sweep")
        st = [jph._phase_stages(static, tables, lane, keep, hm, "sweep",
                                reflected=r) for r in (False, True)]
    else:
        cg, ws, down, up = pph._phase_setup(A, halo, gr, U, k, P64,
                                            engine="sweep", device="cpu")
        st = [[down], [down, up]]
    return cg, ws, st, src


def _stations_problem(mod):
    prof = rt.velocity_profile("ak135")
    gr, A, halo = mod.init_annulus(24, 8, spacing=200.0)
    U = mod.interpolate_velocity(gr.r, mod.LinearInterpolation(
        prof.r, prof.Vp))
    cg = mod.build_circulant(gr, A, halo, U, dtype=np.float64)
    st = [mod.closest_point(gr, np.deg2rad(d), R, system="polar")
          for d in (20.0, 75.0, 130.0)]
    return gr, A, halo, U, cg, st


def _recs(gr):
    return [pt.closest_point(gr, np.deg2rad(d), R, system="polar")
            for d in (30.0, 90.0, 150.0)]


def _references(grids):
    """The JAX package's results for every test, and the port's
    single-device fixpoints."""
    jgr, jcg, gr, cg = grids
    srcs, recs = _sources(jgr, jcg), _recs(jgr)
    out = {f"d{D}": _jax_theta(jcg, srcs, D) for D in (8, 2, 1)}
    out["d4"] = _jax_theta(jcg, [srcs[0]], 4, receivers=recs)
    out["2x4"] = jts.solve_sweep_mesh_sharded(jcg, srcs, J64,
                                              mesh=jts.make_grid_mesh(2, 4))
    out["4x2"] = [_jax_theta(jcg, [s], 2, receivers=recs) for s in srcs[:2]]
    scg, sws, sst, ssrc = _staged_problem("jax")
    for r in (0, 1):
        out[f"staged{r}"] = jts.solve_sweep_staged_theta_sharded(
            scg, sws, sst[r], [ssrc], J64,
            mesh=jts.make_theta_mesh(jax.devices()[:4]))
    _, _, _, _, fcg, fst = _stations_problem(rt)
    out["fields"] = _jax_theta(fcg, fst, 2)[0]
    # the port's single-device routes, once for the module
    out["fixpoint"] = [
        pt.ops.circulant.solve_circulant(cg, s, P64, device="cpu")[0]
        for s in _sources(gr, cg)]
    pgr, pA, phalo, pU, _, pst = _stations_problem(pt)
    solver = pt.AnnulusSolver(pgr, pA, phalo, pU, P64, method="circulant",
                              device="cpu")
    out["locator_fields"] = pt.station_fields(solver, pst)
    return out


@pytest.fixture(scope="module")
def made(request, tmp_path_factory, grids):
    """Every sharded call of the module in one 8-rank gloo group, and the
    references, made while the ranks run."""
    _, _, gr, cg = grids
    srcs = _sources(gr, cg)
    recs = _recs(gr)
    c = launch.call
    scg, sws, sst, ssrc = _staged_problem("port")
    fcg, fst = _stations_problem(pt)[4:]
    calls = {
        "d8": c(pts.solve_sweep_theta_sharded, cg, srcs, P64,
                mesh=_cpu_mesh(pm.make_theta_mesh)),
        "d4": c(pts.solve_sweep_theta_sharded, cg, [srcs[0]], P64,
                mesh=_cpu_mesh(pm.make_theta_mesh, range(4)),
                receivers=recs),
        "d5": c(pts.solve_sweep_theta_sharded, cg, [0], P64,
                mesh=_cpu_mesh(pm.make_theta_mesh, range(5))),
        "d2": c(pts.solve_sweep_theta_sharded, cg, srcs, P64,
                mesh=_cpu_mesh(pm.make_theta_mesh, range(2))),
        "d1": c(pts.solve_sweep_theta_sharded, cg, srcs, P64,
                mesh=_cpu_mesh(pm.make_theta_mesh, range(1))),
        "2x4": c(pts.solve_sweep_mesh_sharded, cg, srcs, P64,
                 mesh=_cpu_mesh(pm.make_grid_mesh, 2)),
        "4x2": c(pts.solve_sweep_mesh_sharded, cg, srcs[:2], P64,
                 mesh=_cpu_mesh(pm.make_grid_mesh, 4, 2), receivers=recs),
        "staged0": c(pts.solve_sweep_staged_theta_sharded, scg, sws, sst[0],
                     [ssrc], P64, mesh=_cpu_mesh(pm.make_theta_mesh,
                                                 range(4))),
        "staged1": c(pts.solve_sweep_staged_theta_sharded, scg, sws, sst[1],
                     [ssrc], P64, mesh=_cpu_mesh(pm.make_theta_mesh,
                                                 range(4))),
        "fields": c(pts.station_fields_sharded, fcg, fst, P64,
                    mesh=_cpu_mesh(pm.make_grid_mesh, 2, 2, range(4))),
    }
    res, refs = torch_group.once(request, tmp_path_factory, "theta_shard",
                                 calls.values(), lambda: _references(grids))
    return {k: [r[i] for r in res] for i, k in enumerate(calls)}, refs


@pytest.fixture(scope="module")
def port(made):
    return made[0]


@pytest.fixture(scope="module")
def want(made):
    return made[1]


def _members(results):
    """The results of the ranks that ran the call, checked equal."""
    got = [r for r in results if r is not None]
    for r in got[1:]:
        if isinstance(r, tuple) and isinstance(r[0], np.ndarray):
            np.testing.assert_array_equal(r[0], got[0][0])
            assert r[1] == got[0][1]
        else:
            np.testing.assert_array_equal(r, got[0])
    return got[0]


def _jax_theta(jcg, srcs, n_dev, **kw):
    mesh = jts.make_theta_mesh(jax.devices()[:n_dev])
    return jts.solve_sweep_theta_sharded(jcg, srcs, J64, mesh=mesh, **kw)


@pytest.mark.parametrize("D", [8, 2, 1])
def test_matches_jax_and_its_rounds(port, want, D):
    vals, rounds = _members(port[f"d{D}"])
    assert sum(r is not None for r in port[f"d{D}"]) == D
    w, rounds_j = want[f"d{D}"]
    assert rounds == rounds_j
    np.testing.assert_array_equal(vals, w)
    # and the single-device fixpoint, as the JAX test holds its own
    for i, ref in enumerate(want["fixpoint"]):
        np.testing.assert_allclose(vals[i], ref, atol=2e-3, rtol=0)


def test_receiver_subset_and_small_mesh(port, want):
    vals, rounds = _members(port["d4"])
    w, rounds_j = want["d4"]
    assert vals.shape == (1, 3) and rounds == rounds_j
    np.testing.assert_array_equal(vals, w)


def test_indivisible_mesh_raises(port):
    err = _members(port["d5"])
    assert err[0] == "ValueError" and "not divisible" in err[1]


def test_2d_mesh_matches_jax(port, want):
    vals, rounds = _members(port["2x4"])
    w, rounds_j = want["2x4"]
    assert vals.shape == w.shape and rounds == rounds_j
    np.testing.assert_array_equal(vals, w)


def test_2d_mesh_receivers_and_tall_shape(port, want):
    """4 source rows x 2 theta columns.  The JAX package's 2-D mesh
    cannot be the reference here: its rows run while loops of different
    trip counts, and XLA's CPU collectives rendezvous across all 8
    devices, so the float64 solve aborts (ROADMAP C.14).  Each row is
    the D = 2 theta-sharded solve of its one source, which the JAX
    package gives on 2 devices; the rounds are the most over the rows
    (the pad rows re-solve the first source)."""
    vals, rounds = _members(port["4x2"])
    assert vals.shape == (2, 3)
    most = 0
    for i, (w, r) in enumerate(want["4x2"]):
        np.testing.assert_array_equal(vals[i], w[0])
        most = max(most, r)
    assert rounds == most


@pytest.mark.parametrize("reflected", [False, True])
def test_staged_phase_matches_jax(port, want, reflected):
    vals, rounds = _members(port[f"staged{int(reflected)}"])
    w, rounds_j = want[f"staged{int(reflected)}"]
    assert rounds == rounds_j
    assert np.array_equal(np.isfinite(vals), np.isfinite(w))
    np.testing.assert_array_equal(vals, w)


def test_station_fields_sharded_matches_jax(port, want):
    """2 station rows x 2 theta columns.  As in the tall 2-D case, the
    JAX package's 2-D mesh aborts in float64 (ROADMAP C.14); in float64
    (tol 0) a round that changes nothing is an exact fixpoint, so a
    station's field does not depend on the stations it shares a row
    with, and the JAX package's D = 2 theta-sharded fields of the three
    stations are the reference."""
    fields = _members(port["fields"])
    np.testing.assert_array_equal(fields, want["fields"])
    # the locator's own fields (the port's single-device route)
    np.testing.assert_allclose(fields, want["locator_fields"], atol=2e-3,
                               rtol=0)
