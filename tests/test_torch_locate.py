"""PyTorch port: 2-D event location (solvers/locate.py, ops/gridsearch.py).

On the 32x8 fixture of tests/test_locate.py (AK135 Vp, float64, seven
surface stations) the port's station fields, both grid searches and
every locator are held to the JAX package's, and the JAX behavioural
tests run on the port.

The tie rule.  Two nodes can tie to the last bit (a halo twin and its
partner carry the same times; on this fixture an on-grid event's misfit
is exactly 0 at three nodes), and two summation orders can flip a near
tie, so node ids from two searches are never required equal outright:
`gridsearch_check.search_agreement` holds the misfit at a pick within
1e-12 of the minimum (relative to m in the direct formula, to the size
of its terms in the expanded one), m and t0 to the reference's values at
that node, and the ids equal only where the best misfit beats the second
best by more than the tolerance.  Handing the JAX package's
fields (`fields=`) and search (`_search=`) to both locators makes the
Gauss-Newton step and the clamp the same host NumPy on the same numbers.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.config import SolverConfig
from raytracer_tpu.solvers import locate as jl
from raytracer_tpu_torch.config import SolverConfig as PortConfig
from raytracer_tpu_torch.ops import gridsearch as gs
from raytracer_tpu_torch.ops import gridsearch_check as gc
from raytracer_tpu_torch.solvers import locate as pl

STATION_DEGS = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 315.0]
RTOL = 1e-12
# tools/jax_locate_reference.py: the JAX package's own spread of a
# bend-mode location on this fixture (the three events below) under a
# one-ulp nudge of the polylines its 800-step bend starts from (km, s);
# a one-ulp nudge of the picks moves it by 2.3e-12 km only, since the
# picks do not reach the bend
JAX_BEND_LOCATE_SPREAD = (22.611508638011124, 0.7518848320751683)
BEND_EVENTS = [(73.1, 400.0), (141.7, 150.0), (222.3, 1000.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers,
    and the twins' many small ops slow down badly when each worker's
    thread pool competes for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coarse():
    """The JAX fixture and the port's solver on the same grid."""
    gr, A, halo = rt.init_annulus(32, 8, spacing=250.0)
    prof = rt.velocity_profile("ak135")
    U = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                              prof.Vp))
    jsolver = rt.AnnulusSolver(gr, A, halo, U, SolverConfig(dtype="float64"))
    stations = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                for d in STATION_DEGS]
    jfields = jl.station_fields(jsolver, stations)
    pgr, pA, phalo = pt.init_annulus(32, 8, spacing=250.0)
    psolver = pt.AnnulusSolver(pgr, pA, phalo, U,
                               PortConfig(dtype="float64"), device="cpu")
    return dict(gr=gr, jsolver=jsolver, psolver=psolver, stations=stations,
                jfields=jfields, pfields=pl.station_fields(psolver, stations),
                prof=prof)


@pytest.fixture(scope="module")
def fine():
    """Picks from a 2x finer forward grid (the JAX package's fields)."""
    grf, Af, halof = rt.init_annulus(64, 16, spacing=120.0)
    prof = rt.velocity_profile("ak135")
    cfg = SolverConfig(dtype="float64")
    out = dict(gr=grf)
    for wave in ("Vp", "Vs"):
        U = rt.interpolate_velocity(
            grf.r, rt.LinearInterpolation(prof.r, getattr(prof, wave)))
        st = [rt.closest_point(grf, np.deg2rad(d), rt.R, system="polar")
              for d in STATION_DEGS]
        out[wave] = jl.station_fields(rt.AnnulusSolver(grf, Af, halof, U,
                                                       cfg), st)
    return out


@pytest.fixture(scope="module")
def s_wave(coarse):
    """The port's and the JAX package's Vs solvers on the coarse grid."""
    gr, prof = coarse["gr"], coarse["prof"]
    Us = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                               prof.Vs))
    js = rt.AnnulusSolver(gr, coarse["jsolver"].A, coarse["jsolver"].halo,
                          Us, SolverConfig(dtype="float64"))
    ps = pt.AnnulusSolver(gr, coarse["psolver"].A, coarse["psolver"].halo,
                          Us, PortConfig(dtype="float64"), device="cpu")
    return js, ps


def _xy(gr, node):
    return np.array([np.asarray(gr.x)[node], np.asarray(gr.z)[node]])


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _on_grid_picks(coarse):
    true = rt.closest_point(coarse["gr"], np.deg2rad(123.0), rt.R - 600.0,
                            system="polar")
    return true, coarse["jfields"][:, true] + 7.5


def test_station_fields_match_jax(coarse):
    """The port's auto route (the sweep) against the JAX package's CPU
    route (circulant), and reciprocity on the port."""
    assert np.abs(coarse["pfields"] - coarse["jfields"]).max() < 1e-9
    gr, ps = coarse["gr"], coarse["psolver"]
    src = rt.closest_point(gr, np.deg2rad(70.0), rt.R - 900.0,
                           system="polar")
    D = ps.solve(src, want_prev=False)
    for k, s in enumerate(coarse["stations"]):
        assert abs(float(D.dist[s]) - coarse["pfields"][k, src]) < 1e-6


def test_on_grid_three_way_tie(coarse):
    """The fixture's on-grid event: misfit exactly 0 at nodes 174, 2789
    and 2828; the port picks one of them with misfit 0 and t0 7.5, under
    the tie rule against the JAX pick."""
    true, t_obs = _on_grid_picks(coarse)
    T, w2 = _t(coarse["jfields"]), _t(np.ones(7))
    rows = gc.misfit_rows(T, _t(t_obs)[None], w2, "direct", RTOL)
    zero = torch.nonzero(rows.m[0] == 0).ravel().tolist()
    assert true == 174 and zero == [174, 2789, 2828]
    j, t0, m = gs.grid_search(T, _t(t_obs)[None], w2)
    assert int(j) in zero and float(m) == 0.0
    assert abs(float(t0) - 7.5) < 1e-12
    jj = jl._grid_search_jit(coarse["jfields"], t_obs, np.ones(7))
    for pick in ((j, t0, m), [np.atleast_1d(np.asarray(v)) for v in jj]):
        assert gc.search_agreement(rows, *pick)["tied"] == 1


@pytest.mark.parametrize("mode", gs.MODES)
def test_search_matches_jax(coarse, mode):
    """64 noisy events (seed 0, 0.2 s, sigma 0.2) through the port's
    twin of each formula and the JAX function of that formula, both
    held to the same rows under the tie rule; ids equal wherever the
    rows rule out a tie."""
    gr = coarse["gr"]
    rng = np.random.default_rng(0)
    ev = rng.integers(0, gr.nnods, size=64)
    T_obs = coarse["jfields"][:, ev].T + rng.normal(0.0, 0.2, (64, 7))
    w2 = np.full(7, 25.0)
    T = _t(coarse["jfields"])
    rows = gc.misfit_rows(T, _t(T_obs), _t(w2), mode, RTOL)
    port = gs.grid_search(T, _t(T_obs), _t(w2), mode)
    if mode == "expanded":
        jax = jl._grid_search_catalogue_jit(coarse["jfields"], T_obs, w2)
        jax = [np.asarray(v) for v in jax]
    else:
        picks = [jl._grid_search_jit(coarse["jfields"], row, w2)
                 for row in T_obs]
        jax = [np.array([float(p[i]) for p in picks]) for i in range(3)]
    a = gc.search_agreement(rows, *port)
    b = gc.search_agreement(rows, *jax)
    assert a["same_node"] == b["same_node"] > 0
    free = gc.tie_free(rows)
    assert torch.equal(port[0][free], torch.tensor(jax[0])[free].long())


@pytest.mark.parametrize("mode", gs.MODES)
def test_search_odd_cases(mode):
    """Non-finite columns (m = inf), duplicated columns (the first index
    wins), an all-inf row (node 0) and K = 20, past the kernel's register
    tile: the twin against the JAX function on the same inputs."""
    rng = np.random.default_rng(4)
    K, n = 20, 301
    T = rng.uniform(10.0, 900.0, (K, n))
    T[3, 7] = np.inf
    T[:, 50] = np.inf
    T[:, 120] = T[:, 40]                 # exact duplicates
    T[:, 41] = T[:, 40]
    T_obs = T[:, [40, 41, 120, 9]].T + 5.0
    T_obs[3] += rng.normal(0.0, 0.3, K)
    w2 = rng.uniform(0.5, 2.0, K)
    j, t0, m = gs.grid_search(_t(T), _t(T_obs), _t(w2), mode)
    assert j[:3].tolist() == [40, 40, 40]
    assert np.all(np.abs(t0[:3].numpy() - 5.0) < 1e-9)
    if mode == "expanded":
        jax = [np.asarray(v) for v in
               jl._grid_search_catalogue_jit(T, T_obs, w2)]
    else:
        picks = [jl._grid_search_jit(T, row, w2) for row in T_obs]
        jax = [np.array([float(p[i]) for p in picks]) for i in range(3)]
    rows = gc.misfit_rows(_t(T), _t(T_obs), _t(w2), mode, RTOL)
    gc.search_agreement(rows, j, t0, m)
    gc.search_agreement(rows, *jax)
    np.testing.assert_array_equal(j.numpy(), jax[0])
    allinf = gs.grid_search(_t(np.full((3, 5), np.inf)), _t(np.ones((1, 3))),
                            _t(np.ones(3)), mode)
    assert int(allinf[0][0]) == 0 and float(allinf[2][0]) == np.inf


def test_grid_search_refuses_bad_arguments():
    T = torch.zeros((3, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="mode"):
        gs.grid_search(T, torch.zeros((1, 3)), torch.ones(3), "fast")
    with pytest.raises(ValueError, match="K, n"):
        gs.grid_search(T, torch.zeros((1, 4)), torch.ones(3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gs.grid_search(T.to("meta"), torch.zeros((1, 3)), torch.ones(3))


def _same(lp, lj, what):
    for f in dataclasses.fields(lj):
        a, b = getattr(lp, f.name), getattr(lj, f.name)
        assert np.allclose(a, b, rtol=0, atol=1e-9), (what, f.name, a, b)


def _noisy(coarse, seed, n_ev, noise):
    rng = np.random.default_rng(seed)
    ev = rng.integers(0, coarse["gr"].nnods, size=n_ev)
    return coarse["jfields"][:, ev].T + rng.normal(0.0, noise, (n_ev, 7))


@pytest.mark.parametrize("what", ["locate", "locate_phases", "locate_many",
                                  "locate_dd"])
def test_locators_match_jax(coarse, s_wave, what):
    """Every Location field within 1e-9 of the JAX package's on its
    fields (and, for `locate`, its search); refine and the dd system are
    host NumPy on the same numbers."""
    js, ps = coarse["jsolver"], coarse["psolver"]
    st, F = coarse["stations"], coarse["jfields"]
    sig = [0.3] * 7
    if what == "locate":
        for row in _noisy(coarse, 7, 3, 0.3):
            s = jl._grid_search_jit(F, row, 1.0 / np.square(sig))
            s = (int(s[0]), float(s[1]), float(s[2]))
            _same(pl.locate(ps, st, row, sigma=sig, fields=F, _search=s),
                  jl.locate(js, st, row, sigma=sig, fields=F, _search=s),
                  what)
    elif what == "locate_phases":
        jss, pss = s_wave
        Fs = jl.station_fields(jss, st[:4])
        true, t_obs = _on_grid_picks(coarse)
        picks = [t_obs + 0.1, Fs[:, true] + 7.65]
        for refine in (False, True):
            _same(pl.locate_phases([ps, pss], [st, st[:4]], picks,
                                   fields=[F, Fs], refine=refine),
                  jl.locate_phases([js, jss], [st, st[:4]], picks,
                                   fields=[F, Fs], refine=refine), what)
    else:
        T_obs = _noisy(coarse, 3, 9, 1.0) + 2.0
        fp = pl.locate_many if what == "locate_many" else pl.locate_dd
        fj = jl.locate_many if what == "locate_many" else jl.locate_dd
        for lp, lj in zip(fp(ps, st, T_obs, sigma=sig, fields=F),
                          fj(js, st, T_obs, sigma=sig, fields=F)):
            _same(lp, lj, what)


def test_on_grid_event_recovered_exactly(coarse):
    """The JAX behavioural test on the port's own fields."""
    gr, ps, st, F = (coarse[k] for k in ("gr", "psolver", "stations",
                                         "pfields"))
    true = rt.closest_point(gr, np.deg2rad(123.0), rt.R - 600.0,
                            system="polar")
    t_obs = F[:, true] + 7.5
    loc = pl.locate(ps, st, t_obs, refine=False, fields=F)
    assert np.linalg.norm(_xy(gr, loc.node) - _xy(gr, true)) < 1.0
    assert abs(loc.t0 - 7.5) < 1e-6 and loc.node_rms < 1e-8
    loc_r = pl.locate(ps, st, t_obs, refine=True, fields=F)
    assert np.linalg.norm([loc_r.x, loc_r.z] - _xy(gr, true)) < 5.0
    assert loc_r.rms <= loc.node_rms + 1e-9


def test_noisy_picks_stay_near_truth(coarse):
    gr, ps, st, F = (coarse[k] for k in ("gr", "psolver", "stations",
                                         "pfields"))
    true = rt.closest_point(gr, np.deg2rad(200.0), rt.R - 1200.0,
                            system="polar")
    rng = np.random.default_rng(7)
    t_obs = F[:, true] + 3.0 + rng.normal(0.0, 0.3, len(st))
    loc = pl.locate(ps, st, t_obs, sigma=[0.3] * len(st), fields=F)
    assert np.linalg.norm(np.array([loc.x, loc.z]) - _xy(gr, true)) < 500.0
    assert abs(loc.t0 - 3.0) < 2.0


def test_subgrid_refinement_beats_grid_search(coarse, fine):
    """Picks from the 2x finer grid, event off the coarse lattice; the
    port locates with its own station solves (fields=None)."""
    grf = fine["gr"]
    true = rt.closest_point(grf, np.deg2rad(73.1), rt.R - 400.0,
                            system="polar")
    loc = pl.locate(coarse["psolver"], coarse["stations"],
                    fine["Vp"][:, true], refine=True)
    t_true = _xy(grf, true)
    node_err = np.linalg.norm(_xy(coarse["gr"], loc.node) - t_true)
    ref_err = np.linalg.norm(np.array([loc.x, loc.z]) - t_true)
    assert ref_err < node_err and ref_err < 250.0


@pytest.fixture(scope="module")
def bent(coarse, fine):
    """The three events of the JAX bend test, located with bend=True by
    the port and the JAX package on the JAX fields and search, and by the
    port's plain Gauss-Newton."""
    js, ps, st, F = (coarse[k] for k in ("jsolver", "psolver", "stations",
                                         "jfields"))
    prof = coarse["prof"]
    out = []
    for deg, dep in BEND_EVENTS:
        true = rt.closest_point(fine["gr"], np.deg2rad(deg), rt.R - dep,
                                system="polar")
        t_obs = fine["Vp"][:, true]
        s = jl._grid_search_jit(F, t_obs, np.ones(7))
        s = (int(s[0]), float(s[1]), float(s[2]))
        kw = dict(fields=F, _search=s)
        out.append(dict(
            truth=_xy(fine["gr"], true),
            plain=pl.locate(ps, st, t_obs, **kw),
            port=pl.locate(ps, st, t_obs, bend=True,
                           profile=(prof.r, prof.Vp), **kw),
            jax=jl.locate(js, st, t_obs, bend=True,
                          profile=(prof.r, prof.Vp), **kw)))
    return out


def test_bend_mode_beats_plain_gauss_newton(bent):
    """The JAX behavioural test on the port: the bent model times strip
    the graph bias, so the mean position error shrinks."""
    err = lambda l, t: np.linalg.norm(np.array([l.x, l.z]) - t)
    for b in bent:
        assert b["port"].rms < 5.0
    assert np.mean([err(b["port"], b["truth"]) for b in bent]) < 0.8 * \
        np.mean([err(b["plain"], b["truth"]) for b in bent])


def test_bend_mode_within_twice_the_jax_spread(bent):
    """The 800-step bend is chaotic (the port's twin and the JAX package
    differ by ~1-2 km here), so a bent location is held to twice the JAX
    package's own spread under one-ulp nudges of the bend's input."""
    for b in bent:
        p, j = b["port"], b["jax"]
        assert p.node == j.node
        assert np.hypot(p.x - j.x, p.z - j.z) <= 2 * JAX_BEND_LOCATE_SPREAD[0]
        assert abs(p.t0 - j.t0) <= 2 * JAX_BEND_LOCATE_SPREAD[1]


def test_locate_on_unstructured_delaunay_mesh():
    """auto -> banded on a Delaunay annulus (no circulant layout, so the
    host PrevRecovery feeds the bend): on-grid exact recovery."""
    gr = pt.add_midpoints(pt.triangle_annulus_2d(nr=12, spacing=500.0))
    A = pt.node_adjacency(gr, star=0)
    halo = np.empty((0, 2), np.int64)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r,
                                                              prof.Vp))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solver = pt.AnnulusSolver(gr, A, halo, U,
                                  PortConfig(dtype="float64"), device="cpu")
    assert solver.circulant is None and solver.method == "banded"
    stations = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
                for d in (0.0, 60.0, 140.0, 220.0, 300.0)]
    fields = pt.station_fields(solver, stations)
    true = pt.closest_point(gr, np.deg2rad(100.0), pt.R - 800.0,
                            system="polar")
    t_obs = fields[:, true] + 2.0
    loc = pt.locate(solver, stations, t_obs, refine=False, fields=fields)
    assert np.linalg.norm(_xy(gr, loc.node) - _xy(gr, true)) < 1.0
    assert abs(loc.t0 - 2.0) < 1e-6
    lb = pt.locate(solver, stations, t_obs, fields=fields, bend=True,
                   profile=(prof.r, prof.Vp))
    assert np.linalg.norm(np.array([lb.x, lb.z]) - _xy(gr, true)) < 600.0


def test_locate_phases_sparse_network_beats_p_only(coarse, fine, s_wave):
    """Two one-sided stations: S picks at the same stations cut the mean
    position error of P-only picks (the JAX behavioural test)."""
    gr, ps = coarse["gr"], coarse["psolver"]
    pss = s_wave[1]
    sub = [0, 1]
    st_c = [coarse["stations"][i] for i in sub]
    f_cp = coarse["pfields"][sub]
    f_cs = pl.station_fields(pss, st_c)
    errs_p, errs_ps = [], []
    for deg, dep in [(25.3, 500.0), (60.7, 300.0), (80.2, 800.0)]:
        true = rt.closest_point(fine["gr"], np.deg2rad(deg), rt.R - dep,
                                system="polar")
        txy = _xy(fine["gr"], true)
        tp, ts = fine["Vp"][sub, true], fine["Vs"][sub, true]
        lp = pl.locate(ps, st_c, tp, fields=f_cp)
        lps = pl.locate_phases([ps, pss], [st_c, st_c], [tp, ts],
                               fields=[f_cp, f_cs])
        errs_p.append(np.linalg.norm(np.array([lp.x, lp.z]) - txy))
        errs_ps.append(np.linalg.norm(np.array([lps.x, lps.z]) - txy))
    assert np.mean(errs_ps) < np.mean(errs_p) and np.mean(errs_ps) < 300.0


def test_double_difference_improves_relative_geometry(coarse, fine):
    gr, ps, st, F = (coarse[k] for k in ("gr", "psolver", "stations",
                                         "pfields"))
    ev = [rt.closest_point(fine["gr"], np.deg2rad(d), rt.R - h,
                           system="polar")
          for d, h in ((80.0, 500.0), (82.5, 650.0))]
    true_rel = _xy(fine["gr"], ev[0]) - _xy(fine["gr"], ev[1])
    syst = np.random.default_rng(5).normal(0.0, 1.5, len(st))
    T_obs = np.stack([fine["Vp"][:, e] + syst for e in ev])
    indep = pl.locate_many(ps, st, T_obs, fields=F)
    dd = pl.locate_dd(ps, st, T_obs, fields=F)
    rel_i = np.array([indep[0].x - indep[1].x, indep[0].z - indep[1].z])
    rel_d = np.array([dd[0].x - dd[1].x, dd[0].z - dd[1].z])
    err_d = np.linalg.norm(rel_d - true_rel)
    assert err_d < np.linalg.norm(rel_i - true_rel) and err_d < 120.0


def test_example_location_refines():
    from raytracer_tpu_torch import example_location

    out = example_location.run(32, 8, 250.0, n_events=4, verbose=False,
                               device="cpu")
    assert out["refined_err"] < out["node_err"], out
    assert out["refined_err"] < 150.0, out


def test_locate_needs_the_graph():
    """A solver built from a circulant stencil alone has A = None: the
    grid search runs, the Gauss-Newton step refuses by name."""
    gr, cg, U = pt.init_annulus_circulant(16, 4, 400.0, dtype=np.float64)
    solver = pt.AnnulusSolver(gr, None, None, U, PortConfig(dtype="float64"),
                              circulant=cg, device="cpu")
    stations = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
                for d in (0.0, 90.0, 180.0, 270.0)]
    fields = pt.station_fields(solver, stations)
    t_obs = fields[:, 40] + 1.0
    loc = pt.locate(solver, stations, t_obs, refine=False, fields=fields)
    assert loc.node_rms < 1e-8
    with pytest.raises(ValueError, match="graph A"):
        pt.locate(solver, stations, t_obs, fields=fields)
