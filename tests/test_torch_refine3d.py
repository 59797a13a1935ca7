"""PyTorch port: the 3-D bending refinement against the JAX package.

`refine3d_travel_times` (P on an upper-mantle wedge, 20x3x10, star 1) and
`converted3d_refined` (SKS on a wedge 130 deg wide into the outer core,
26x3x16 with the AK135 interfaces forced, star 1) - the smallest wedges
that reach the two phases - on the CPU, float32 solves, m=64:
  * the SPM times equal the JAX package's bit for bit, and at 50 Adam
    steps the refined times equal its within 1e-6 s (the bend's twin
    follows the JAX package step for step over a short run, as
    tests/test_torch_refine.py pins);
  * at 800 steps the refined times lie within twice the spread the JAX
    package shows against itself when the port's own polylines (the
    same nodes; equal prev trees) are nudged by 1e-9 km, and SKS's at or
    below its SPM times (refine3d_travel_times takes the minimum with
    SPM itself, as the JAX function does).
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import R
from raytracer_tpu.config import SolverConfig as JC
from raytracer_tpu.models import grid3d as jg
from raytracer_tpu.models.velocity import table_interface_radii
from raytracer_tpu.solvers import refine as jr
from raytracer_tpu.solvers import solve3d as js
from raytracer_tpu.utils.coords import spherical2cart
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.solvers import refine as pr
from raytracer_tpu_torch.solvers import solve3d as ps
from jax_mappings import below_the_map_limit  # noqa: F401,E402

JF32, PF32 = JC(dtype="float32"), PC(dtype="float32")
CMB = 3481.5
M = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface_node(gr, theta_deg):
    x, y, z = spherical2cart(np.deg2rad(theta_deg), np.deg2rad(90.0), R)
    return jg.closest_point3d(gr, x, y, z)


@pytest.fixture(scope="module")
def prof():
    return rt.velocity_profile("ak135")


@pytest.fixture(scope="module")
def p_case(prof):
    c0, c1, dims = ((0.0, np.deg2rad(87.0), 3000.0),
                    (np.deg2rad(70.0), np.deg2rad(93.0), R), (20, 3, 10))
    gj, gp = jg.grid3d(c0, c1, dims), pt.grid3d(c0, c1, dims)
    U = jg.velocity3d(gj, rt.LinearInterpolation(prof.r, prof.Vp))
    src = _surface_node(gj, 0.0)
    recs = [_surface_node(gj, d) for d in (35.0, 55.0)]
    return gj, gp, U, src, recs


@pytest.fixture(scope="module")
def sks_case(prof):
    radii = table_interface_radii("ak135")
    c0, c1, dims = ((0.0, np.deg2rad(88.0), 1400.0),
                    (np.deg2rad(130.0), np.deg2rad(92.0), R), (26, 3, 16))
    gj = jg.grid3d(c0, c1, dims, force_radii=radii)
    gp = pt.grid3d(c0, c1, dims, force_radii=radii)
    Up = jg.velocity3d(gj, rt.LinearInterpolation(prof.r, prof.Vp))
    Us = jg.velocity3d(gj, rt.LinearInterpolation(prof.r, prof.Vs))
    src = _surface_node(gj, 0.0)
    recs = [_surface_node(gj, d) for d in (105.0, 125.0)]
    return gj, gp, Up, Us, src, recs


def _run(fn_j, fn_p, monkeypatch):
    """The JAX and port results at 50 steps, the port's at 800 with the
    polylines it bent, and the JAX package's 800-step times on those
    polylines with its spread under four 1e-9 km nudges."""
    tj50, sj = fn_j(50)
    tp50, sp = fn_p(50)
    seen = []
    bend = pr.refine_paths_batch

    def spy(paths, *args, **kwargs):
        seen.append([np.array(p) for p in paths])
        return bend(paths, *args, **kwargs)

    monkeypatch.setattr(pr, "refine_paths_batch", spy)
    tp800, sp800 = fn_p(800)
    return tj50, sj, tp50, sp, tp800, sp800, seen[0]


def _jax_spread(paths, rs, vs, r_max):
    kw = dict(m=M, iters=800, r_max=r_max)
    tj = jr.refine_paths_batch(paths, rs, vs, **kw)[1]
    rng = np.random.default_rng(0)
    spread = 0.0
    for k in range(4):
        nudged = [p + 1e-9 * (1.0 if k == 0 else
                              rng.choice([-1.0, 1.0], size=p.shape))
                  for p in paths]
        tn = jr.refine_paths_batch(nudged, rs, vs, **kw)[1]
        spread = max(spread, float(np.abs(tn - tj).max()))
    return tj, spread


def test_refine3d_travel_times(p_case, prof, monkeypatch):
    gj, gp, U, src, recs = p_case

    def fn_j(iters):
        return js.refine3d_travel_times(gj, U, src, recs, prof.r, prof.Vp,
                                        JF32, star=1, m=M, iters=iters)

    def fn_p(iters):
        return ps.refine3d_travel_times(gp, U, src, recs, prof.r, prof.Vp,
                                        PF32, star=1, m=M, iters=iters,
                                        device="cpu")

    tj50, sj, tp50, sp, tp800, sp800, paths = _run(fn_j, fn_p, monkeypatch)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(sp800, sj)
    np.testing.assert_allclose(tp50, tj50, rtol=0, atol=1e-6)
    assert np.all(tp50 < sp - 5.0)               # the SPM bias it cures
    tj, spread = _jax_spread(paths, prof.r, prof.Vp, float(gj.r.max()))
    assert spread < 0.05
    np.testing.assert_allclose(tp800, np.minimum(tj, sj), rtol=0,
                               atol=max(2.0 * spread, 1e-9))
    assert np.all(tp800 <= sp800)


def test_converted3d_refined(sks_case, prof, monkeypatch):
    gj, gp, Up, Us, src, recs = sks_case

    def fn_j(iters):
        return js.converted3d_refined(gj, Us, Up, src, recs, CMB, prof.r,
                                      prof.Vs, prof.Vp, JF32, star=1, m=M,
                                      iters=iters)

    def fn_p(iters):
        return ps.converted3d_refined(gp, Us, Up, src, recs, CMB, prof.r,
                                      prof.Vs, prof.Vp, PF32, star=1, m=M,
                                      iters=iters, device="cpu")

    tj50, sj, tp50, sp, tp800, sp800, paths = _run(fn_j, fn_p, monkeypatch)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_allclose(tp50, tj50, rtol=0, atol=1e-6)
    rs = np.asarray(prof.r, np.float64)
    v_comp = np.where(rs >= CMB, prof.Vs, prof.Vp)
    tj, spread = _jax_spread(paths, rs, v_comp, float(gj.r.max()))
    assert spread < 0.5       # measured 0.18 s on this wedge
    np.testing.assert_allclose(tp800, tj, rtol=0,
                               atol=max(2.0 * spread, 1e-9))
    assert np.all(tp800 <= sp800) and np.all(tp800 < sp800 - 10.0)
