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
from jax_mappings import below_the_map_limit  # noqa: F401,E402

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


# ----------------------------------------------------------------------
# A NumPy replay of csrc/gridsearch.cu: its column tiles, event chunks,
# a lane's running best over its columns, the warp's shuffle-down
# reduction once per (event, block) and the finishing warp over the
# blocks' partials
# ----------------------------------------------------------------------

NO_COL = 0x7FFFFFFF
TILE, LANE_COLS, WARPS, K_CHUNK = 128, 4, 8, 16


def _before(m1, j1, m2, j2):
    """(m1, j1) before (m2, j2): the lesser misfit, NaN the least, then the
    lower column (the kernel's `before`)."""
    n1, n2 = np.isnan(m1), np.isnan(m2)
    return np.where(n1 != n2, n1, np.where(n1 | (m1 == m2), j1 < j2,
                                           m1 < m2))


def _shfl_down_argmin(m, j):
    """warp_argmin over the last axis (32 lanes): at each offset a lane
    takes lane l + off's pair when it comes before its own (a lane past
    31 reads its own), lane 0's pair at the end."""
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        src = np.where(lane + off < 32, lane + off, lane)
        mo, jo = m[..., src], j[..., src]
        take = _before(mo, jo, m, j)
        m, j = np.where(take, mo, m), np.where(take, jo, j)
    return m[..., 0], j[..., 0]


def _kernel_pick(m, blocks, expanded):
    """The kernel's (j, m) from the misfits m (E, n) on `blocks` blocks:
    warp w of a block takes events [e0 + w ept, e0 + w ept + ept) of each
    chunk of 8 ept (ept 8 expanded, 4 direct); lane l walks its columns
    tile by tile (tiles b, b + blocks, ...), l + 32 i within a tile, from
    (+inf, its first column), replacing its pair only by a pair that
    comes before it; the warp's lanes reduced once an (event, block);
    then one warp an event over the blocks' partials."""
    E, n = m.shape
    ept = 8 if expanded else 4
    tiles = -(-n // TILE)
    pm = np.full((E, blocks), np.inf, dtype=m.dtype)
    pj = np.full((E, blocks), NO_COL, dtype=np.int64)
    lanes = np.arange(32)
    for e0 in range(0, E, WARPS * ept):
        for b in range(blocks):
            for w in range(WARPS):
                ev = np.arange(e0 + w * ept, e0 + (w + 1) * ept)
                ev = ev[ev < E]
                if not len(ev):
                    continue
                first = b * TILE + lanes
                bm = np.full((len(ev), 32), np.inf, dtype=m.dtype)
                bj = np.repeat(np.where(first < n, first, NO_COL)[None],
                               len(ev), 0)
                for tile in range(b, tiles, blocks):
                    for i in range(LANE_COLS):
                        c = tile * TILE + lanes + 32 * i
                        live = c < n
                        mc = m[ev][:, np.minimum(c, n - 1)]
                        keep = live & ~(mc >= bm) & (bm == bm)
                        bm, bj = np.where(keep, mc, bm), np.where(keep, c, bj)
                pm[ev, b], pj[ev, b] = _shfl_down_argmin(bm, bj)
    fm = np.full((E, 32), np.inf, dtype=m.dtype)
    fj = np.full((E, 32), NO_COL, dtype=np.int64)
    for b in range(blocks):
        lane = b % 32
        take = _before(pm[:, b], pj[:, b], fm[:, lane], fj[:, lane])
        fm[:, lane] = np.where(take, pm[:, b], fm[:, lane])
        fj[:, lane] = np.where(take, pj[:, b], fj[:, lane])
    mm, jj = _shfl_down_argmin(fm, fj)
    return jj, mm


def _kernel_rows(T, T_obs, w2, mode):
    """Every (event, column) misfit in the kernel's order of operations, in
    T's dtype (NumPy rounds the products the kernel fuses): W2 and the
    sums over K in ascending k; expanded with the event side (a, A) the
    kernel forms."""
    with np.errstate(invalid="ignore"):
        dt = T.dtype
        W2 = _ksum(w2)
        fin = np.isfinite(T).all(axis=0)
        if mode == "expanded":
            mean = _ksum(w2 * T_obs, axis=1) / W2
            oc = T_obs - mean[:, None]
            a = w2[None, :] * oc
            A = _ksum(a * oc, axis=1)
            s2 = np.zeros(T.shape[1], dt)
            for k in range(T.shape[0]):
                s2 = s2 + w2[k] * T[k]
            mean = np.where(fin, s2 / W2, dt.type(0))
            C = np.zeros(T.shape[1], dt)
            B = np.zeros((T_obs.shape[0], T.shape[1]), dt)
            for k in range(T.shape[0]):
                tc = np.where(fin, T[k] - mean, dt.type(0))
                C = C + w2[k] * (tc * tc)
                B = B + a[:, k, None] * tc[None, :]
            m = (A[:, None] - dt.type(2) * B) + C[None, :]
        else:
            s = np.zeros((T_obs.shape[0], T.shape[1]), dt)
            for k in range(T.shape[0]):
                s = s + w2[k] * (T_obs[:, k, None] - T[k][None, :])
            t0 = s / W2
            m = np.zeros_like(s)
            for k in range(T.shape[0]):
                d = (T_obs[:, k, None] - T[k][None, :]) - t0
                m = m + w2[k] * (d * d)
        return np.where(fin[None, :], m, dt.type(np.inf))


def _ksum(x, axis=0):
    """The sum over `axis` in ascending order, in x's dtype."""
    x = np.moveaxis(np.asarray(x), axis, 0)
    out = np.zeros(x.shape[1:], x.dtype)
    for v in x:
        out = out + v
    return out


def _kernel_t0(T, T_obs, w2, j, mode):
    """finish_kernel's t0 at the picked columns."""
    dt = T.dtype
    W2 = _ksum(w2)
    out = np.empty(len(j), dt)
    for e, c in enumerate(j):
        col = T[:, c]
        if mode == "expanded":
            s1 = _ksum(w2 * T_obs[e])
            s2 = dt.type(0)
            if np.isfinite(col).all():
                for k in range(len(col)):
                    s2 = s2 + w2[k] * col[k]
            out[e] = (s1 - s2) / W2
        else:
            s = dt.type(0)
            for k in range(len(col)):
                s = s + w2[k] * (T_obs[e, k] - col[k])
            out[e] = s / W2
    return out


@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("blocks", [1, 3, 8, 40])
def test_kernel_pick_is_the_first_minimum(expanded, blocks):
    """Given the twin's misfits, the kernel's reduction order picks what
    argmin picks: the first of equal minima across lanes, warps, column
    tiles and blocks, a NaN first, node 0 in an all-inf row; for E = 1
    and E not a multiple of the event chunk."""
    rng = np.random.default_rng(7)
    for E in (1, 37, 70):
        n = 5000
        m = rng.uniform(5.0, 9.0, (E, n))
        m[rng.random((E, n)) < 0.1] = np.inf
        ties = [(5, 133), (31, 32), (127, 128), (40, 40 + 3 * TILE),
                (4000, 4001), (640, 4999)]
        for e in range(E):
            a, b = ties[e % len(ties)]
            m[e, [a, b]] = 1.0 + (e % 3 == 0) * 0.5
        if E > 1:
            m[1] = np.inf                           # all inf: node 0
        if E > 5:
            m[3, [700, 90, 4500]] = np.nan           # the first NaN
            m[4, [2000, 3000]] = -np.inf
        if E > 20:
            m[20, :] = np.nan
        for dt in (np.float64, np.float32):
            mm = m.astype(dt)
            j, got = _kernel_pick(mm, blocks, expanded)
            want = np.argmin(mm, axis=1)
            np.testing.assert_array_equal(j, want)
            assert np.array_equal(got, mm[np.arange(E), want], equal_nan=True)
        if E > 5:
            assert j[3] == 90 and j[4] == 2000
        if E > 1:
            assert j[1] == 0


SEARCH_RTOL = {np.float64: 1e-12, np.float32: 1e-4}
SEARCH_T0_ATOL = {np.float64: 0.0, np.float32: 1e-3}


def _search_cases(coarse):
    rng = np.random.default_rng(3)
    T = coarse["jfields"]
    n = T.shape[1]
    ev = rng.integers(0, n, size=70)
    obs = T[:, ev].T + rng.normal(0.0, 0.2, (70, T.shape[0]))
    yield "fixture E=70", T, obs, np.full(T.shape[0], 25.0)
    yield "fixture E=1", T, obs[:1], np.full(T.shape[0], 25.0)
    # K = 20 (past a chunk of K), non-finite and duplicated columns
    K, n2 = 20, 3001
    T2 = rng.uniform(10.0, 900.0, (K, n2))
    T2[:, rng.integers(0, n2, 30)] = np.inf
    T2[4, 17] = np.inf
    T2[:, 2600] = T2[:, 40]
    T2[:, 41] = T2[:, 40]
    T2[:, 40 + TILE] = T2[:, 40]
    obs2 = T2[:, rng.integers(0, n2, 37)].T + 2.0
    obs2[np.isinf(obs2)] = 600.0
    obs2[:2] = T2[:, 40] + 4.0
    obs2[2:] += rng.normal(0.0, 0.3, obs2[2:].shape)
    yield "K=20 E=37", T2, obs2, rng.uniform(0.5, 2.0, K)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", gs.MODES)
def test_kernel_replay_holds_to_jax_under_the_tie_rule(coarse, mode, dtype):
    """The kernel's arithmetic and reduction order, replayed on 3 and 5
    blocks, against the JAX search of the same formula under the tie
    rule of gridsearch_check, both held to the twin's rows: 70 events
    (not a multiple of a chunk), one event, and K = 20 with non-finite
    and exactly duplicated columns (the first index)."""
    for what, T, obs, w2 in _search_cases(coarse):
        T, obs, w2 = (np.asarray(x, dtype) for x in (T, obs, w2))
        terms = (SEARCH_RTOL[dtype] if dtype == np.float64
                 else gc.ulp_rtol(torch.float32, T.shape[0]))
        rows = gc.misfit_rows(*(torch.from_numpy(x) for x in (T, obs, w2)),
                              mode, SEARCH_RTOL[dtype], terms,
                              SEARCH_T0_ATOL[dtype])
        m_all = _kernel_rows(T, obs, w2, mode)
        for blocks in (3, 5):
            j, m = _kernel_pick(m_all, blocks, mode == "expanded")
            t0 = _kernel_t0(T, obs, w2, j, mode)
            try:
                gc.search_agreement(rows, j, t0, m)
            except AssertionError as e:
                raise AssertionError((what, blocks, *e.args)) from None
        if what.startswith("K=20"):
            assert j[:2].tolist() == [40, 40]
        if mode == "expanded":
            jax = [np.asarray(v) for v in
                   jl._grid_search_catalogue_jit(T, obs, w2)]
        else:
            picks = [jl._grid_search_jit(T, row, w2) for row in obs]
            jax = [np.array([float(p[i]) for p in picks]) for i in range(3)]
        gc.search_agreement(rows, *jax)
