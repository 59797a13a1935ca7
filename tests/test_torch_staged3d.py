"""PyTorch port: the staged 3-D solves and their host pieces.

`mask_region3d`, `solve3d_reflection` (PcP: two stages on region-masked
weights) and `solve3d_converted` (SKS/PKP: three stages seeded on the
twin planes of a forced radius) run on the port's sweep engine; on the
CPU they must give the JAX package's floats and summed round counts on
the discontinuity wedges of tests/test_grid3d_disc.py (CMB-spanning,
and 130 deg into the outer core), and the converted solve must refuse a
radius that is not twin-doubled with the JAX package's ValueError.
`composite_velocity3d`, the stage-seeded predecessor tree
(`_prev3d_seeded`) and `table_interface_radii` (a host copy) must equal
the JAX package's.  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import R
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.models import grid3d as jg
from raytracer_tpu.models import velocity as jv
from raytracer_tpu.solvers import solve3d as js
from raytracer_tpu.utils.coords import spherical2cart
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.models import velocity as pv
from raytracer_tpu_torch.solvers import solve3d as ps
from jax_mappings import below_the_map_limit  # noqa: F401,E402

JF32, PF32 = JConfig(dtype="float32"), PConfig(dtype="float32")
CMB = 3481.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface_node(gr, theta_deg):
    x, y, z = spherical2cart(np.deg2rad(theta_deg), np.deg2rad(90.0), R)
    return jg.closest_point3d(gr, x, y, z)


def _grids(c0, c1, dims):
    radii = pv.table_interface_radii("ak135")
    gj = jg.grid3d(c0, c1, dims, force_radii=radii)
    gp = pt.grid3d(c0, c1, dims, force_radii=radii)
    assert np.array_equal(gj.r, gp.r) and np.array_equal(gj.x, gp.x)
    prof = rt.velocity_profile("ak135")
    Up = jg.velocity3d(gj, rt.LinearInterpolation(prof.r, prof.Vp))
    Us = jg.velocity3d(gj, rt.LinearInterpolation(prof.r, prof.Vs))
    return gj, gp, Up, Us


@pytest.fixture(scope="module")
def wedge():
    """The CMB-spanning wedge of tests/test_grid3d_disc.py."""
    return _grids((np.deg2rad(60.0), np.deg2rad(88.0), 3000.0),
                  (np.deg2rad(120.0), np.deg2rad(92.0), R), (61, 3, 35))


@pytest.fixture(scope="module")
def wide_wedge():
    """The 130-deg wedge into the outer core of tests/test_grid3d_disc.py."""
    return _grids((0.0, np.deg2rad(88.0), 1400.0),
                  (np.deg2rad(130.0), np.deg2rad(92.0), R), (66, 3, 42))


@pytest.mark.parametrize("wave", ["Vp", "Vs"])
@pytest.mark.parametrize("model", ["ak135", "iasp91"])
def test_table_interface_radii_equal_jax(model, wave):
    got = pv.table_interface_radii(model, wave=wave)
    assert got == jv.table_interface_radii(model, wave=wave)
    assert got == tuple(sorted(got, reverse=True)) and len(got) >= 4
    if (model, wave) == ("ak135", "Vp"):
        assert got == (6350.5, 6335.5, 5960.5, 5710.5, 3481.5, 1217.5)


@pytest.mark.parametrize("star", [1, 2])
def test_mask_region3d_equals_jax(wedge, star):
    gj, _, Up, _ = wedge
    shifts = ps.shifts_star(star)
    W = ps._shifted_weights(gj, Up, np.float32, shifts)
    keep = (gj.r >= CMB - 1e-6).reshape(W.shape[1:])
    got = ps.mask_region3d(W, keep, shifts)
    assert np.array_equal(got, js.mask_region3d(W, keep, shifts))
    assert np.isinf(got[:, ~keep]).all()
    assert np.isfinite(got).sum() < np.isfinite(W).sum()


def test_reflection_equals_jax(wedge):
    """Staged PcP: stage A from the sources on the masked region, stage B
    from the reflector level; the same floats and summed rounds, one and
    two sources (one batch), receivers gathered."""
    gj, gp, Up, _ = wedge
    srcs = [_surface_node(gj, 90.0), _surface_node(gj, 75.0)]
    want, it_w = js.solve3d_reflection(gj, Up, srcs, CMB, JF32)
    got, it_g = ps.solve3d_reflection(gp, Up, srcs, CMB, PF32, device="cpu")
    assert it_g == it_w and got.shape == (2, len(gj))
    np.testing.assert_array_equal(got, want)
    recs = [_surface_node(gj, d) for d in (95.0, 100.0, 110.0)]
    tab, it_t = ps.solve3d_reflection(gp, Up, srcs, CMB, PF32,
                                      receivers=recs, device="cpu")
    assert it_t == it_g
    np.testing.assert_array_equal(tab, got[:, recs])
    direct, _ = ps.solve3d(gp, Up, srcs[:1], PF32, engine="sweep",
                           device="cpu")
    assert got[0, recs[1]] > direct[0, recs[1]] + 50.0   # no direct leak


@pytest.mark.parametrize("phase", ["SKS", "PKP"])
def test_converted_equals_jax(wide_wedge, phase):
    """The three-stage converted solve (topside, core seeded on the
    underside twin plane, topside re-seeded): the same floats and summed
    rounds; the final field is +inf below the boundary."""
    gj, gp, Up, Us = wide_wedge
    U_mantle = Us if phase == "SKS" else Up
    src = _surface_node(gj, 0.0)
    want, it_w = js.solve3d_converted(gj, U_mantle, Up, [src], CMB,
                                      config=JF32)
    got, it_g = ps.solve3d_converted(gp, U_mantle, Up, [src], CMB,
                                     config=PF32, device="cpu")
    assert it_g == it_w < 40
    np.testing.assert_array_equal(got, want)
    assert not np.isfinite(got[0][gj.r < CMB - 0.05 - 1e-6]).any()
    # U_up given as its own array: its weights are rebuilt, same field
    again, it_a = ps.solve3d_converted(gp, U_mantle, Up, [src], CMB,
                                       U_up=U_mantle.copy(), config=PF32,
                                       device="cpu")
    assert it_a == it_g
    np.testing.assert_array_equal(again, got)


def test_converted_refuses_a_radius_without_twin(wide_wedge):
    gj, gp, Up, Us = wide_wedge
    src = _surface_node(gj, 0.0)
    with pytest.raises(ValueError, match="forced radius") as jerr:
        js.solve3d_converted(gj, Us, Up, [src], 3000.0, config=JF32)
    with pytest.raises(ValueError, match="forced radius") as perr:
        ps.solve3d_converted(gp, Us, Up, [src], 3000.0, config=PF32,
                             device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_composite_velocity3d_equals_jax(wide_wedge):
    gj, gp, _, _ = wide_wedge
    prof = rt.velocity_profile("ak135")
    vs = rt.LinearInterpolation(prof.r, prof.Vs)
    vp = rt.LinearInterpolation(prof.r, prof.Vp)
    got = ps.composite_velocity3d(gp, CMB, vs, vp)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, js.composite_velocity3d(gj, CMB, vs,
                                                               vp))
    assert np.array_equal(got[gp.r >= CMB], vs(gp.r[gp.r >= CMB]))


def test_prev3d_seeded_equals_jax(wedge):
    """The stage-seeded predecessor tree of the reflection's stage-B
    field on its masked weights: a node its best candidate cannot
    explain (a seeded reflector node) points to itself."""
    import jax.numpy as jnp

    gj, gp, Up, _ = wedge
    src = _surface_node(gj, 90.0)
    d, _ = ps.solve3d_reflection(gp, Up, [src], CMB, PF32, device="cpu")
    W = ps._shifted_weights(gp, Up, np.float32, ps.SHIFTS)
    shp = W.shape[1:]
    Wm = ps.mask_region3d(W, (gp.r >= CMB - 1e-6).reshape(shp), ps.SHIFTS)
    d3 = d[0].reshape(shp)
    got = ps._prev3d_seeded(torch.from_numpy(d3), torch.from_numpy(Wm),
                            ps.SHIFTS).numpy()
    want = np.asarray(js._prev3d_seeded_jit(jnp.asarray(d3), jnp.asarray(Wm),
                                            js.SHIFTS))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    ids = np.arange(len(gj))
    lev = np.abs(gj.r - CMB) < 1e-6
    assert (got[lev & np.isfinite(d[0])] == ids[lev & np.isfinite(d[0])]).any()


def test_staged_solves_default_to_the_card(wedge):
    """Without a card the default device raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    gj, gp, Up, _ = wedge
    src = [_surface_node(gj, 90.0)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.solve3d_reflection(gp, Up, src, CMB, PF32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.solve3d_converted(gp, Up, Up, src, CMB, config=PF32)
