"""PyTorch port: path reconstruction against the JAX package.

`backtrace_paths` (the `paths` kernel's walk; on the CPU its plain twin)
equals the JAX package's fixed-depth scan bit for bit: on the tiny
annulus with the Dijkstra prev tree and its halo, and on a random
predecessor tree with cycles (ROADMAP C.9: a walk that meets a cycle
never reaches the source and keeps cycling in both).  `ray_parameters`,
`takeoff_angle` and the `reconstruct_path` alias are host NumPy copies,
equal to the JAX package's bit for bit.  The `paths` wrapper refuses
what its kernel does not take.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import R, SolverConfig
from raytracer_tpu.solvers import path as jp
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.ops import paths as op
from raytracer_tpu_torch.solvers import path as pp


@pytest.fixture(scope="module")
def tree(tiny_annulus, tiny_velocity):
    gr, A, halo = tiny_annulus
    src = rt.closest_point(gr, 0.0, R, system="polar")
    D = rt.dijkstra(A, halo, src, gr, tiny_velocity,
                    SolverConfig(dtype="float64"))
    recs = [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
            for d in np.arange(3.0, 360.0, 17.0)]
    return gr, src, D, recs


@pytest.mark.parametrize("max_len", [1, 7, 88])
def test_backtrace_equals_jax(tree, max_len):
    gr, src, D, recs = tree
    want = np.asarray(jp.backtrace_paths(D.prev, src, np.asarray(recs),
                                         max_len))
    got = pp.backtrace_paths(D.prev, src, recs, max_len, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if max_len == 88:
        # every row ends in the source, and agrees with the host walk
        assert np.all(want[:, -1] == src)
        for row, r in zip(want, recs):
            path = pt.recontruct_path(D.prev, src, r)
            np.testing.assert_array_equal(row[:len(path)], path)


def test_backtrace_with_cycles_equals_jax():
    rng = np.random.default_rng(7)
    n = 300
    prev = rng.integers(0, n, size=n)
    prev[5] = 5
    prev[10], prev[11] = 11, 10                  # a 2-cycle (C.9)
    recs = np.concatenate([rng.integers(0, n, 20), [10, 5]])
    want = np.asarray(jp.backtrace_paths(prev, 5, recs, 40))
    got = pp.backtrace_paths(torch.as_tensor(prev), 5,
                             torch.as_tensor(recs), 40, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want[-2]) == {10, 11}


def test_host_helpers_equal_jax(tree):
    gr, src, D, recs = tree
    prof = rt.velocity_profile("ak135")
    assert pp.reconstruct_path is pp.recontruct_path
    assert pt.reconstruct_path is pt.recontruct_path
    for r in recs:
        path = pp.reconstruct_path(D.prev, src, r)
        np.testing.assert_array_equal(path,
                                      jp.reconstruct_path(D.prev, src, r))
        pts = np.stack([gr.x[path], gr.z[path]], axis=1)
        np.testing.assert_array_equal(
            pt.ray_parameters(pts, prof.r, prof.Vp),
            jp.ray_parameters(pts, prof.r, prof.Vp))
        assert pt.takeoff_angle(pts) == jp.takeoff_angle(pts)
        assert pt.takeoff_angle(pts[::-1]) == jp.takeoff_angle(pts[::-1])
    # 3-D polylines and the short cases
    rng = np.random.default_rng(3)
    p3 = rng.normal(size=(9, 3)) * 100 + np.array([0.0, 0.0, 6000.0])
    np.testing.assert_array_equal(pt.ray_parameters(p3, prof.r, prof.Vp),
                                  jp.ray_parameters(p3, prof.r, prof.Vp))
    assert pt.takeoff_angle(p3) == jp.takeoff_angle(p3)
    assert pt.ray_parameters(p3[:1], prof.r, prof.Vp).shape == (0,)
    assert np.isnan(pt.takeoff_angle(p3[:1]))


def test_paths_wrapper_refuses():
    prev = torch.arange(5, dtype=torch.int32)
    recs = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        op.paths(prev, 0, recs, 0)
    with pytest.raises(ValueError, match="pair terms"):
        op.paths(prev, 0, recs, 3, dense=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        op.paths(prev.to("meta"), 0, recs.to("meta"), 3)
    out = op.paths(prev, 0, recs, 3)
    assert out.ids is None and out.dense is None
    np.testing.assert_array_equal(out.nodes.numpy(), [[1, 1, 1], [2, 2, 2]])
