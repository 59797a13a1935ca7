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


def _jump_walk(prev, source, receivers, max_len):
    """NumPy replay of the `paths` kernel's walk: the jump tables f^(2^j)
    (f: the source stays, an id outside [0, n) stays, else prev), then
    every (r, k) from k's binary digits."""
    prev = np.asarray(prev, np.int64)
    a = np.arange(prev.shape[0])
    F = [np.where((a == source) | (prev < 0) | (prev >= a.size), a, prev)]
    while len(F) < op.jump_levels(max_len):
        F.append(F[-1][F[-1]])
    x = np.repeat(np.asarray(receivers, np.int64)[:, None], max_len, axis=1)
    k = np.arange(max_len)
    for j, Fj in enumerate(F):
        bit = (k >> j) & 1 == 1
        x[:, bit] = Fj[x[:, bit]]
    return x.astype(np.int32)


def _three_references(prev, src, recs, max_len):
    got = _jump_walk(prev, src, recs, max_len)
    want = np.asarray(jp.backtrace_paths(prev, src, np.asarray(recs),
                                         max_len))
    twin = op.walk_reference(torch.as_tensor(np.asarray(prev)), src,
                             torch.as_tensor(np.asarray(recs)), max_len)
    np.testing.assert_array_equal(twin.numpy(), want)
    return got, want


@pytest.mark.parametrize("max_len", [1, 7, 88, 300])
def test_jump_walk_equals_the_walks(tree, max_len):
    gr, src, D, recs = tree
    got, want = _three_references(D.prev, src, recs, max_len)
    np.testing.assert_array_equal(got, want)
    # a prev with cycles (ROADMAP C.9), a self-loop and the source's own
    # entry -1 (never read: a walk stops at the source)
    rng = np.random.default_rng(22)
    n = 300
    prev = rng.integers(0, n, size=n)
    prev[5] = -1
    prev[10], prev[11], prev[12] = 11, 12, 10         # a 3-cycle
    prev[20] = 20
    recs = np.concatenate([rng.integers(0, n, 20), [10, 5, 20, 12]])
    got, want = _three_references(prev, 5, recs, max_len)
    np.testing.assert_array_equal(got, want)
    assert op.jump_levels(max_len) == max(1, (max_len - 1).bit_length())


@pytest.mark.parametrize("max_len", [1, 7, 88, 300])
def test_jump_walk_stops_at_ids_outside(max_len):
    """A walk that meets -1 or n stays there in the kernel; the twin and
    the JAX package emit a -1 and go on from prev[n - 1] (and the twin
    cannot index n): on the prev with those entries made self-loops,
    which is the kernel's rule, all three agree."""
    rng = np.random.default_rng(23)
    n = 200
    prev = rng.integers(0, n, size=n)
    prev[7], prev[8] = -1, n
    prev[30], prev[31] = 7, 8
    recs = np.array([30, 31, 7, 8, 3, 150])
    looped = np.where((prev < 0) | (prev >= n), np.arange(n), prev)
    got = _jump_walk(prev, 3, recs, max_len)
    np.testing.assert_array_equal(got, _three_references(looped, 3, recs,
                                                         max_len)[1])
    if max_len > 2:
        np.testing.assert_array_equal(got[:2, 1:], [[7] * (max_len - 1),
                                                    [8] * (max_len - 1)])
