"""PyTorch port: 3-D event location on the spherical wedge.

The JAX package's wedges of tests/test_locate.py: (20, 16, 12) for the
on-grid and P+S cases, (16, 12, 10) located against picks from
(31, 23, 19).  `station_fields3d` is held to the JAX package's; with the
same fields (and, for `locate3d`, the same search) `locate3d`,
`locate3d_phases` and `locate_many3d` give the JAX package's Location3D
fields within 1e-9 (the Gauss-Newton step and the clamp are host NumPy
on the same numbers; the catalogue search under the tie rule of
tests/test_torch_locate.py); and the JAX behavioural tests run on the
port's own fields.
"""
import dataclasses

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.config import SolverConfig
from raytracer_tpu.solvers import locate as jl
from raytracer_tpu_torch.config import SolverConfig as PortConfig
from raytracer_tpu_torch.ops import gridsearch_check as gc
from raytracer_tpu_torch.solvers import refine as p_refine
from raytracer_tpu_torch.solvers import locate as pl
from jax_mappings import below_the_map_limit  # noqa: F401,E402

LO, HI = (0.0, 0.0, rt.R - 1500.0), (np.deg2rad(40.0), np.deg2rad(40.0),
                                     rt.R)
CFG = PortConfig(dtype="float64")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers,
    and the twins' many small ops slow down badly when each worker's
    thread pool competes for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wedge(dims, waves=("Vp",)):
    g = pt.grid3d(LO, HI, dims)
    prof = pt.velocity_profile("ak135")
    Us = [pt.interpolate_velocity(g.r, pt.LinearInterpolation(
        prof.r, getattr(prof, w))) for w in waves]
    return g, Us, prof


def _corners(g):
    n0, n1, n2 = g.nnods
    top = n0 * n1 * (n2 - 1)
    return [top, top + (n0 - 1), top + n0 * (n1 - 1), top + n0 * n1 - 1,
            top + n0 * (n1 // 2) + n0 // 2]


def _pos(l):
    return np.array([l.x, l.y, l.z])


def _same(lp, lj, what):
    for f in dataclasses.fields(lj):
        a, b = getattr(lp, f.name), getattr(lj, f.name)
        assert np.allclose(a, b, rtol=0, atol=1e-9), (what, f.name, a, b)


@pytest.fixture(scope="module")
def wedge():
    """(20, 16, 12), P and S, the port's station fields."""
    g, (Up, Us), prof = _wedge((20, 16, 12), ("Vp", "Vs"))
    st_p = _corners(g)
    f_p = pl.station_fields3d(g, Up, st_p, CFG, device="cpu")
    f_s = pl.station_fields3d(g, Us, st_p[:3], CFG, device="cpu")
    n0, n1, n2 = g.nnods
    src = (n0 // 3) + n0 * (n1 // 3) + n0 * n1 * (n2 // 2)
    return dict(g=g, Up=Up, Us=Us, st_p=st_p, f_p=f_p, f_s=f_s, src=src,
                prof=prof)


def test_station_fields3d_match_jax(wedge):
    """The port's solve3d on the CPU against the JAX package's, and
    reciprocity against a direct solve from the source."""
    g = wedge["g"]
    jg = rt.grid3d(LO, HI, (20, 16, 12))
    want = jl.station_fields3d(jg, wedge["Up"], wedge["st_p"],
                               SolverConfig(dtype="float64"))
    assert np.abs(wedge["f_p"] - want).max() < 1e-9
    d, _ = pt.solve3d(g, wedge["Up"], [wedge["src"]], CFG, device="cpu")
    for k, s in enumerate(wedge["st_p"]):
        assert abs(d[0, s] - wedge["f_p"][k, wedge["src"]]) < 1e-6


def test_locate3d_matches_jax(wedge):
    """On-grid and noisy picks, refined, with the same fields and
    search: every field within 1e-9."""
    g, U, st, F = (wedge[k] for k in ("g", "Up", "st_p", "f_p"))
    rng = np.random.default_rng(1)
    for t_obs in (F[:, wedge["src"]] + 4.0,
                  F[:, 777] + 2.0 + rng.normal(0.0, 0.3, len(st))):
        s = jl._grid_search_jit(F, t_obs, np.ones(len(st)))
        s = (int(s[0]), float(s[1]), float(s[2]))
        for refine in (False, True):
            _same(pl.locate3d(g, U, st, t_obs, fields=F, refine=refine,
                              _search=s, config=CFG, device="cpu"),
                  jl.locate3d(g, U, st, t_obs, fields=F, refine=refine,
                              _search=s), "locate3d")


def test_locate3d_phases_matches_jax(wedge):
    g, st = wedge["g"], wedge["st_p"]
    F = [wedge["f_p"], wedge["f_s"]]
    picks = [F[0][:, 901] + 1.5, F[1][:, 901] + 1.6]
    for refine in (False, True):
        _same(pl.locate3d_phases(g, [wedge["Up"], wedge["Us"]],
                                 [st, st[:3]], picks, fields=F,
                                 refine=refine, config=CFG, device="cpu"),
              jl.locate3d_phases(g, [wedge["Up"], wedge["Us"]],
                                 [st, st[:3]], picks, fields=F,
                                 refine=refine), "locate3d_phases")


@pytest.fixture(scope="module")
def catalogue():
    """(16, 12, 10), five noisy events of the JAX catalogue test."""
    g, (U,), prof = _wedge((16, 12, 10))
    st = _corners(g)
    F = pl.station_fields3d(g, U, st, CFG, device="cpu")
    rng = np.random.default_rng(2)
    ev = rng.integers(0, g.nnods_total, size=5)
    T_obs = F[:, ev].T + rng.normal(0.0, 0.5, (5, len(st)))
    return g, U, st, F, T_obs, prof


def test_locate_many3d_matches_jax(catalogue):
    """The catalogue's search under the tie rule (the unrefined node, t0
    and node rms of both packages against the same rows), then every
    refined field within 1e-9 wherever the two picked the same node."""
    g, U, st, F, T_obs, _ = catalogue
    w2 = torch.ones(len(st), dtype=torch.float64)
    rows = gc.misfit_rows(torch.as_tensor(F), torch.as_tensor(T_obs), w2,
                          "expanded", 1e-12)
    same = None
    for refine in (False, True):
        port = pl.locate_many3d(g, U, st, T_obs, fields=F, refine=refine,
                                config=CFG, device="cpu")
        jax = jl.locate_many3d(g, U, st, T_obs, fields=F, refine=refine)
        if not refine:
            for locs in (port, jax):
                out = gc.search_agreement(
                    rows, [l.node for l in locs], [l.t0 for l in locs],
                    [l.node_rms ** 2 * len(st) for l in locs])
            assert out["same_node"] > 0
            same = [lp.node == lj.node for lp, lj in zip(port, jax)]
            assert sum(same) >= out["same_node"]
        for lp, lj, eq in zip(port, jax, same):
            if eq:
                _same(lp, lj, "locate_many3d")


def test_locate_many3d_matches_per_event(catalogue, monkeypatch):
    """Batched search and shared prev trees reproduce per-event locate3d,
    bend mode included (the JAX behavioural test, on two events).  The
    bends run 50 of their 800 steps here: both routes bend the same
    polylines the same way, whatever the step count."""
    plain = p_refine.refine_paths_batch
    monkeypatch.setattr(p_refine, "refine_paths_batch",
                        lambda *a, **kw: plain(*a, iters=50, **kw))
    g, U, st, F, T_obs, prof = catalogue
    kw = dict(fields=F, bend=True, profile=(prof.r, prof.Vp), config=CFG,
              device="cpu")
    batched = pl.locate_many3d(g, U, st, T_obs[:2], **kw)
    for row, lb in zip(T_obs[:2], batched):
        l1 = pl.locate3d(g, U, st, row, **kw)
        assert l1.node == lb.node
        assert np.allclose(_pos(l1), _pos(lb), atol=1e-8)
        assert np.isclose(l1.t0, lb.t0, atol=1e-8)


def test_locate3d_on_grid_exact(wedge):
    g, U, st, F, src = (wedge[k] for k in ("g", "Up", "st_p", "f_p", "src"))
    t_obs = F[:, src] + 4.0
    loc = pl.locate3d(g, U, st, t_obs, fields=F, refine=False, device="cpu")
    assert isinstance(loc, pt.Location3D) and loc.node == src
    assert abs(loc.t0 - 4.0) < 1e-6 and loc.node_rms < 1e-8
    loc_r = pl.locate3d(g, U, st, t_obs, fields=F, device="cpu")
    truth = np.array([g.x[src], g.y[src], g.z[src]])
    assert np.linalg.norm(_pos(loc_r) - truth) < 60.0
    assert loc_r.rms <= loc.node_rms + 1e-9


def test_locate3d_off_grid_event():
    """Picks from the (31, 23, 19) wedge, located on (16, 12, 10) by the
    port's own station solves: the refined position beats the node, and
    bend mode lowers the rms and beats the node too."""
    g, (U,), prof = _wedge((16, 12, 10))
    gf, (Uf,), _ = _wedge((31, 23, 19))

    def surface_nodes(grid, fracs):
        n0, n1, n2 = grid.nnods
        top = n0 * n1 * (n2 - 1)
        return [top + int(f0 * (n0 - 1)) + n0 * int(f1 * (n1 - 1))
                for f0, f1 in fracs]

    fracs = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0), (0.5, 0.5),
             (0.25, 0.75)]
    stations = surface_nodes(g, fracs)
    n0f, n1f, _ = gf.nnods
    src_f = 9 + n0f * 7 + n0f * n1f * 9
    t_obs = pl.station_fields3d(gf, Uf, surface_nodes(gf, fracs), CFG,
                                device="cpu")[:, src_f]
    truth = np.array([gf.x[src_f], gf.y[src_f], gf.z[src_f]])
    loc = pl.locate3d(g, U, stations, t_obs, config=CFG, device="cpu")
    node = np.array([g.x[loc.node], g.y[loc.node], g.z[loc.node]])
    node_err = np.linalg.norm(node - truth)
    assert np.linalg.norm(_pos(loc) - truth) < node_err
    lb = pl.locate3d(g, U, stations, t_obs, bend=True,
                     profile=(prof.r, prof.Vp), config=CFG, device="cpu")
    assert lb.rms < loc.rms
    assert np.linalg.norm(_pos(lb) - truth) < node_err


def test_locate3d_phases_exact_and_sparse(wedge):
    """Joint P+S: exact on-grid recovery; with two corner stations the S
    picks pull the solution closer than P alone."""
    g, Up, Us, st_p, f_p, f_s, src = (wedge[k] for k in (
        "g", "Up", "Us", "st_p", "f_p", "f_s", "src"))
    loc = pl.locate3d_phases(g, [Up, Us], [st_p, st_p[:3]],
                             [f_p[:, src] + 4.0, f_s[:, src] + 4.0],
                             refine=False, fields=[f_p, f_s], device="cpu")
    assert loc.node == src
    assert abs(loc.t0 - 4.0) < 1e-6 and loc.node_rms < 1e-8
    n0, n1, n2 = g.nnods
    st2 = st_p[:2]
    rng = np.random.default_rng(7)
    errs_p, errs_ps = [], []
    for ev in [src, (2 * n0 // 3) + n0 * (n1 // 2) + n0 * n1 * (n2 // 3),
               (n0 // 2) + n0 * (2 * n1 // 3) + n0 * n1 * (2 * n2 // 3)]:
        truth = np.array([g.x[ev], g.y[ev], g.z[ev]])
        tp = f_p[:2, ev] + rng.normal(0, 0.3, 2)
        ts = f_s[:2, ev] + rng.normal(0, 0.3, 2)
        lp = pl.locate3d(g, Up, st2, tp, fields=f_p[:2], device="cpu")
        lps = pl.locate3d_phases(g, [Up, Us], [st2, st2], [tp, ts],
                                 fields=[f_p[:2], f_s[:2]], device="cpu")
        errs_p.append(np.linalg.norm(_pos(lp) - truth))
        errs_ps.append(np.linalg.norm(_pos(lps) - truth))
    assert np.mean(errs_ps) < np.mean(errs_p) and np.mean(errs_ps) < 50.0
