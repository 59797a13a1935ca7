"""PyTorch port: the slab-sharded 3-D sweep solves against the JAX
package.

The port's parallel/shard3d.py runs on one 8-rank gloo group on the CPU
for the module (`launch.run_group`), the JAX package's on the 8 virtual
CPU devices of tests/conftest.py while the ranks run
(tests/torch_group.py: both once a run); the cases are tests/test_shard3d.py's
(a 10x16x12 wedge from the upper mantle into the outer core, every shard
axis, receivers, an indivisible mesh; the staged reflection and
converted solves on a CMB-spanning wedge with forced interfaces, and the
refusal of a radial shard axis), in float64.  The plane passes (their
plain twin here), the edge-masked weights, the halo carries and the vote
are the JAX package's arithmetic op for op, so every field is equal bit
for bit and every round count equal on the same D.
"""
import numpy as np
import pytest

import jax

import raytracer_tpu as rt
from raytracer_tpu.config import R, SolverConfig as JConfig
from raytracer_tpu.parallel import shard3d as js3
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.parallel import launch, mesh as pm
from raytracer_tpu_torch.parallel import shard3d as ps3

import torch_group
from jax_mappings import below_the_map_limit  # noqa: F401,E402

J64 = JConfig(dtype="float64")
P64 = pt.SolverConfig(dtype="float64")
WORLD = torch_group.WORLD


def _problem(mod):
    gr = mod.grid3d((0.0, 0.0, 3000.0),
                    (np.deg2rad(40.0), np.deg2rad(30.0), R), (10, 16, 12))
    prof = mod.velocity_profile("ak135")
    U = mod.velocity3d(gr, mod.LinearInterpolation(prof.r, prof.Vp))
    return gr, U, [0, gr.nnods_total // 2, gr.nnods_total - 1]


def _disc(mod):
    from raytracer_tpu_torch.models.velocity import table_interface_radii

    gr = mod.grid3d((0.0, np.deg2rad(88.0), 1400.0),
                    (np.deg2rad(120.0), np.deg2rad(92.0), R), (24, 4, 24),
                    force_radii=table_interface_radii("ak135"))
    prof = mod.velocity_profile("ak135")
    Up = mod.velocity3d(gr, mod.LinearInterpolation(prof.r, prof.Vp))
    Us = mod.velocity3d(gr, mod.LinearInterpolation(prof.r, prof.Vs))
    return gr, Up, Us


def _ranks(n):
    return launch.call(pm.make_shard3d_mesh, range(n), device="cpu")


def _jax(fn, *args, n, **kw):
    return fn(*args, J64, mesh=js3.make_shard3d_mesh(jax.devices()[:n]), **kw)


def _references():
    """The JAX package's results for every test, and the port's
    single-device fixpoint."""
    gr, U, srcs = _problem(rt)
    out = {"d8": _jax(js3.solve3d_sharded, gr, U, srcs, n=8, shard_axis=1)}
    for shard_axis, dsize in ((0, 4), (1, 8), (2, 2)):
        out[f"axis{shard_axis}"] = _jax(js3.solve3d_sharded, gr, U,
                                        [srcs[0]], n=dsize,
                                        shard_axis=shard_axis)
    out["recs"] = _jax(js3.solve3d_sharded, gr, U, [srcs[1]], n=4,
                       receivers=[1, gr.nnods_total // 3,
                                  gr.nnods_total - 2])
    dg, Up, Us = _disc(rt)
    out["pcp"] = _jax(js3.solve3d_reflection_sharded, dg, Up,
                      [0, dg.nnods_total - 1], 3481.5, n=4, shard_axis=1)
    out["sks"] = js3.solve3d_converted_sharded(
        dg, Us, Up, [dg.nnods_total - 2], 3481.5, config=J64,
        mesh=js3.make_shard3d_mesh(jax.devices()[:3]), shard_axis=2)
    pg, pU, _ = _problem(pt)
    out["fixpoint"] = pt.solve3d(pg, pU, srcs, P64, engine="xla",
                                 device="cpu")[0]
    return out


@pytest.fixture(scope="module")
def made(request, tmp_path_factory):
    """Every sharded call of the module in one 8-rank gloo group, and the
    references, made while the ranks run."""
    gr, U, srcs = _problem(pt)
    dg, Up, Us = _disc(pt)
    recs = [1, gr.nnods_total // 3, gr.nnods_total - 2]
    c = launch.call
    calls = {
        "d8": c(ps3.solve3d_sharded, gr, U, srcs, P64, _ranks(8),
                shard_axis=1),
        "ax0": c(ps3.solve3d_sharded, gr, U, [srcs[0]], P64, _ranks(4),
                 shard_axis=0),
        "ax2": c(ps3.solve3d_sharded, gr, U, [srcs[0]], P64, _ranks(2),
                 shard_axis=2),
        "recs": c(ps3.solve3d_sharded, gr, U, [srcs[1]], P64, _ranks(4),
                  receivers=recs),
        "d7": c(ps3.solve3d_sharded, gr, U, [srcs[0]], P64, _ranks(7),
                shard_axis=1),
        "pcp": c(ps3.solve3d_reflection_sharded, dg, Up,
                 [0, dg.nnods_total - 1], 3481.5, P64, _ranks(4),
                 shard_axis=1),
        "sks": c(ps3.solve3d_converted_sharded, dg, Us, Up,
                 [dg.nnods_total - 2], 3481.5, config=P64, mesh=_ranks(3),
                 shard_axis=2),
        "radial": c(ps3.solve3d_reflection_sharded, dg, Up, [0], 3481.5,
                    P64, _ranks(2), shard_axis=0),
    }
    res, refs = torch_group.once(request, tmp_path_factory, "shard3d",
                                 calls.values(), _references)
    out = {}
    for i, k in enumerate(calls):
        got = [r[i] for r in res if r[i] is not None]
        for r in got[1:]:
            if isinstance(r[0], np.ndarray):
                np.testing.assert_array_equal(r[0], got[0][0])
            assert r[1] == got[0][1]
        out[k] = got[0]
    return out, refs


@pytest.fixture(scope="module")
def port(made):
    return made[0]


@pytest.fixture(scope="module")
def want(made):
    return made[1]


def test_matches_jax_and_the_single_device_fixpoint(port, want):
    vals, rounds = port["d8"]
    w, rounds_j = want["d8"]
    assert rounds == rounds_j
    np.testing.assert_array_equal(vals, w)
    np.testing.assert_allclose(vals, want["fixpoint"], atol=2e-3, rtol=0)


@pytest.mark.parametrize("shard_axis,dsize", [(0, 4), (1, 8), (2, 2)])
def test_every_shard_axis(port, want, shard_axis, dsize):
    key = {0: "ax0", 1: "d8", 2: "ax2"}[shard_axis]
    vals, rounds = port[key]
    w, rounds_j = want[f"axis{shard_axis}"]
    assert rounds == rounds_j or shard_axis == 1
    np.testing.assert_array_equal(vals[:1], w)


def test_receiver_subset(port, want):
    vals, rounds = port["recs"]
    w, rounds_j = want["recs"]
    assert vals.shape == (1, 3) and rounds == rounds_j
    np.testing.assert_array_equal(vals, w)


def test_indivisible_mesh_raises(port):
    err = port["d7"]
    assert err[0] == "ValueError" and "not divisible" in err[1]


def test_reflection_sharded_matches(port, want):
    vals, rounds = port["pcp"]
    w, rounds_j = want["pcp"]
    assert rounds == rounds_j
    assert np.array_equal(np.isfinite(vals), np.isfinite(w))
    np.testing.assert_array_equal(vals, w)


def test_converted_sharded_matches(port, want):
    vals, rounds = port["sks"]
    w, rounds_j = want["sks"]
    assert rounds == rounds_j
    np.testing.assert_array_equal(vals, w)


def test_staged_sharded_rejects_radial_axis(port):
    err = port["radial"]
    assert err[0] == "ValueError" and "radial" in err[1]
