"""PyTorch port: bending refinement against the JAX package.

On five SPM paths of the tiny annulus (16x6, float64, a surface source,
receivers at 10-140 deg), m=64, quad=8, lr=3:
  * the NumPy parts (`resample_path`, `_uniform_slowness`,
    `refraction_inits`, `_polyline_time`) equal the JAX package's bit for
    bit;
  * the bend's plain twin (the functional, autograd, optax's Adam written
    out) follows the JAX package step for step over a short run: 10 steps
    within 1e-8 s and 1e-6 km (measured 5.6e-11 s, 5.2e-8 km in 2-D,
    1.8e-9 s in 3-D), 50 steps within 1e-6 s and 1e-4 km (measured
    3.7e-8 s, 3.8e-6 km in 2-D), in 2-D and in 3-D (the same paths turned
    out of their plane);
  * over 800 steps the optimisation is chaotic (vertices slide along the
    ray, where the time is flat): the JAX package's own times move by up
    to `spread` when its input vertices are nudged by 1e-9 km (four
    nudges), and the port's times are held within twice that; every time
    is at or below its input polyline's, the endpoints stay pinned and
    every vertex inside r_max; degenerate and origin-crossing paths stay
    finite; sub-batches and chunks do not change the result, and
    `refine_fan`'s multistart only tightens;
  * `AnnulusSolver.refined_travel_times` and `refined_travel_time_table`
    equal the JAX solver's at 50 steps within 1e-6 s, at m=48-64 and
    quad=8 (at the table's defaults, m=384 and quad=16, the flat
    refraction candidates bent at lr=1 part from the JAX package by
    5.6e-3 s within 5 steps: Adam scales each gradient component to about
    lr, so the rounding of components near zero decides their steps).
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import R, SolverConfig
from raytracer_tpu.solvers import refine as jr
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.ops import bend as ob
from raytracer_tpu_torch.solvers import refine as pr
from jax_mappings import below_the_map_limit  # noqa: F401,E402

F64 = SolverConfig(dtype="float64")
KW = dict(m=64, quad=8)
LOCKSTEP = {10: (1e-8, 1e-6), 50: (1e-6, 1e-4)}   # iters: (s, km)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lift(p, ang=0.3):
    """A 2-D (x, z) polyline turned out of its plane into 3-D."""
    return np.stack([p[:, 0] * np.cos(ang), p[:, 0] * np.sin(ang), p[:, 1]],
                    axis=1)


@pytest.fixture(scope="module")
def fan(tiny_annulus, tiny_velocity):
    gr, A, halo = tiny_annulus
    src = rt.closest_point(gr, 0.0, R, system="polar")
    D = rt.dijkstra(A, halo, src, gr, tiny_velocity, F64)
    prof = rt.velocity_profile("ak135")
    pts = []
    for deg in (10.0, 40.0, 80.0, 110.0, 140.0):
        rec = rt.closest_point(gr, np.deg2rad(deg), R, system="polar")
        path = rt.recontruct_path(D.prev, src, rec)
        pts.append(np.stack([gr.x[path], gr.z[path]], axis=1))
    return prof, pts


@pytest.fixture(scope="module")
def long_run(fan):
    """The JAX package at 800 steps, its spread under four 1e-9 km
    nudges of the input vertices, and the port's twin."""
    prof, pts = fan
    Pj, tj = jr.refine_paths_batch(pts, prof.r, prof.Vp, iters=800, **KW)
    rng = np.random.default_rng(0)
    spread = 0.0
    for k in range(4):
        sign = 1.0 if k == 0 else rng.choice([-1.0, 1.0], size=(1,))
        nudged = [p + (1e-9 * sign if k == 0 else
                       1e-9 * rng.choice([-1.0, 1.0], size=p.shape))
                  for p in pts]
        tn = jr.refine_paths_batch(nudged, prof.r, prof.Vp, iters=800,
                                   **KW)[1]
        spread = max(spread, float(np.abs(tn - tj).max()))
    Pp, tp = pr.refine_paths_batch(pts, prof.r, prof.Vp, iters=800,
                                   device="cpu", **KW)
    return tj, spread, Pp, tp


def test_numpy_parts_equal_jax(fan):
    prof, pts = fan
    for p in pts:
        for m in (7, 64):
            np.testing.assert_array_equal(pr.resample_path(p, m),
                                          jr.resample_path(p, m))
        for quad in (8, 16):
            assert pr._polyline_time(p, prof.r, prof.Vp, quad) == \
                jr._polyline_time(p, prof.r, prof.Vp, quad)
    np.testing.assert_array_equal(pr.resample_path(pts[0][:1].repeat(3, 0),
                                                   5),
                                  jr.resample_path(pts[0][:1].repeat(3, 0),
                                                   5))
    for dr in (pr._UNIFORM_DR, 2.5):
        a = pr._uniform_slowness(prof.r, prof.Vp, dr)
        b = jr._uniform_slowness(prof.r, prof.Vp, dr)
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], np.asarray(b[2]))
    assert pr._UNIFORM_DR == jr._UNIFORM_DR == 1.0
    p0 = np.array([0.0, R])
    for deg in (2.0, 15.0, 30.0, -20.0):
        th = np.deg2rad(deg)
        p1 = np.array([R * np.sin(th), R * np.cos(th)])
        got = pr.refraction_inits(p0, p1, prof.r, prof.Vp)
        want = jr.refraction_inits(p0, p1, prof.r, prof.Vp)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("iters", sorted(LOCKSTEP))
def test_twin_follows_jax_step_for_step(fan, d, iters):
    prof, pts = fan
    paths = pts if d == 2 else [_lift(p) for p in pts]
    Pj, tj = jr.refine_paths_batch(paths, prof.r, prof.Vp, iters=iters, **KW)
    Pp, tp = pr.refine_paths_batch(paths, prof.r, prof.Vp, iters=iters,
                                   device="cpu", **KW)
    assert Pp.shape == (5, 64, d) and tp.dtype == np.float64
    t_tol, p_tol = LOCKSTEP[iters]
    assert float(np.abs(tp - tj).max()) <= t_tol
    assert float(np.abs(Pp - np.asarray(Pj)).max()) <= p_tol


def test_800_steps_within_the_jax_spread(fan, long_run):
    prof, pts = fan
    tj, spread, Pp, tp = long_run
    assert 1e-4 < spread < 0.05, spread
    assert float(np.abs(tp - tj).max()) <= 2.0 * spread
    # at or below the input polyline (the resampled stack under the same
    # functional: the best iterate starts there), and below the SPM
    # polyline's continuous time
    stack = torch.as_tensor(np.stack([pr.resample_path(p, 64)
                                      for p in pts]))
    prof_t = ob.uniform_table(*pr._uniform_slowness(prof.r, prof.Vp),
                              torch.float64, "cpu")
    t_in = ob.ttime(stack, prof_t, 8).numpy()
    assert np.all(tp <= t_in)
    for p, t in zip(pts, tp):
        assert t < pr._polyline_time(p, prof.r, prof.Vp)
    # endpoints pinned, every vertex inside the Earth
    np.testing.assert_allclose(Pp[:, 0], stack[:, 0].numpy(), atol=1e-12)
    np.testing.assert_allclose(Pp[:, -1], stack[:, -1].numpy(), atol=1e-12)
    assert np.all(np.linalg.norm(Pp, axis=-1) <= R + 1e-9)


def test_degenerate_and_origin_paths_stay_finite(fan):
    prof, _ = fan
    degen = np.repeat([[0.0, R]], 7, axis=0)        # a single surface point
    through0 = np.stack([np.linspace(-R, R, 9), np.zeros(9)], axis=1)
    _, tj = jr.refine_paths_batch([degen, through0], prof.r, prof.Vp,
                                  m=32, iters=50)
    P, t = pr.refine_paths_batch([degen, through0], prof.r, prof.Vp, m=32,
                                 iters=50, device="cpu")
    assert np.isfinite(t).all() and np.isfinite(P).all(), t
    assert abs(t[0]) < 1e-6 and t[1] > 1000.0
    np.testing.assert_allclose(t, tj, rtol=0, atol=1e-6)
    # refine_path keeps the JAX package's short-path rule
    Pq, tq = pt.refine_path(degen[:2], prof.r, prof.Vp, device="cpu")
    assert tq == jr.refine_path(degen[:2], prof.r, prof.Vp)[1]


def test_sub_batch_and_chunks_do_not_change_the_bend(fan):
    prof, pts = fan
    P1, t1 = pr.refine_paths_batch(pts, prof.r, prof.Vp, iters=30,
                                   device="cpu", **KW)
    P2, t2 = pr.refine_paths_batch(pts, prof.r, prof.Vp, iters=30,
                                   sub_batch=2, device="cpu", **KW)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(P1, P2)
    stack = torch.as_tensor(np.stack([pr.resample_path(p, 48)
                                      for p in pts[:2]]))
    prof_t = ob.uniform_table(*pr._uniform_slowness(prof.r, prof.Vp),
                              torch.float64, "cpu")
    Pa, ta = ob.bend(stack, prof_t, 3.0, R, 25, 8)
    Pb, tb = ob.bend(stack, prof_t, 3.0, R, 25, 8, chunk=7)
    assert torch.equal(Pa, Pb) and torch.equal(ta, tb)
    # one path alone bends as it does in the batch
    P1a, t1a = pt.refine_path(pts[1], prof.r, prof.Vp, m=64, iters=30,
                              device="cpu")
    np.testing.assert_array_equal(P1a, P1[1])
    assert t1a == t1[1]
    with pytest.raises(ValueError, match="chunk"):
        ob.bend(stack, prof_t, 3.0, R, 25, 8, chunk=0)
    with pytest.raises(ValueError, match="float32 or float64"):
        pr.refine_paths_batch(pts, prof.r, prof.Vp, dtype="float16",
                              device="cpu")


def test_refine_fan_multistart_tightens_and_equals_jax(fan):
    prof, pts = fan
    kw = dict(m=64, iters=50, quad=8)
    plain = pt.refine_fan(pts, prof.r, prof.Vp, multistart=False,
                          device="cpu", **kw)
    ms = pt.refine_fan(pts, prof.r, prof.Vp, device="cpu", **kw)
    assert np.all(ms <= plain + 1e-9)
    assert np.any(ms < plain - 1e-3)          # the 10-deg pair gains
    want = jr.refine_fan(pts, prof.r, prof.Vp, **kw)
    np.testing.assert_allclose(ms, want, rtol=0, atol=1e-6)


def test_solver_methods_equal_jax(tiny_annulus, tiny_velocity, fan):
    gr, A, halo = tiny_annulus
    prof, _ = fan
    js_ = rt.AnnulusSolver(gr, A, halo, tiny_velocity, F64,
                           method="circulant")
    ps_ = pt.AnnulusSolver(gr, A, halo, tiny_velocity,
                           PC(dtype="float64"), method="circulant",
                           device="cpu")
    src = rt.closest_point(gr, 0.0, R, system="polar")
    recs = [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
            for d in (4.0, 60.0, 90.0)]
    kw = dict(profile=(prof.r, prof.Vp), m=48, iters=50)
    want = js_.refined_travel_times(src, recs, **kw)
    got = ps_.refined_travel_times(src, recs, **kw)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the solver's own sampled table
    want = js_.refined_travel_times(src, recs, m=48, iters=50)
    got = ps_.refined_travel_times(src, recs, m=48, iters=50)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    srcs = [src, rt.closest_point(gr, np.deg2rad(120.0), R, system="polar")]
    kw = dict(profile=(prof.r, prof.Vp), m=64, quad=8, iters=50)
    want = js_.refined_travel_time_table(srcs, recs[1:], **kw)
    got = ps_.refined_travel_time_table(srcs, recs[1:], **kw)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
