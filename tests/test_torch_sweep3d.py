"""PyTorch port: the 3-D grid, the shifted weights and the 26-tap
multi-sweep kernel's plain twin against the JAX package on the CPU.

The host copies (`models/grid3d`, `spherical2cart`, `_shifted_weights`,
`plan_sweep3d`) must give the JAX package's arrays bit for bit.
`sweep3d_reference` (the twin of the CUDA kernel `csrc/sweep3d.cu`) must
equal the Pallas kernel `sweep3d_T` in interpret mode bit for bit: every
candidate is one add and the minimum does not depend on order.  The
cases cover a single row block, a tiny box and n0 = 130 (two 128-lane
groups, L0 = 256), float32 and float64, and the batched form.  The plain
stencil pieces `_sweep` and `_axis_scan` (XLA code in the JAX package)
must equal the JAX functions bit for bit on fields with +inf entries.
Mirrors tests/test_sweep3d.py and tests/test_grid3d.py.  The CUDA kernel
runs only on the card; chip_smoke.py holds it to the twin there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import R
from raytracer_tpu.models import grid3d as jg
from raytracer_tpu.ops import sweep3d as jk
from raytracer_tpu.solvers import solve3d as js
from raytracer_tpu.utils.coords import spherical2cart as j_s2c
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.models import grid3d as pg
from raytracer_tpu_torch.ops import sweep3d as pk
from raytracer_tpu_torch.solvers import solve3d as ps
from raytracer_tpu_torch.utils.coords import spherical2cart as p_s2c
from jax_mappings import below_the_map_limit  # noqa: F401,E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the twin runs many
    small ops, and torch's thread pool stalls at each op while the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(dims, force_radii=None, lo=80.0, hi=100.0, depth=600.0):
    """The JAX and port grids of one wedge, and AK135 Vp on it."""
    c0 = (np.deg2rad(lo), np.deg2rad(lo), R - depth)
    c1 = (np.deg2rad(hi), np.deg2rad(hi), R)
    gj = jg.grid3d(c0, c1, dims, force_radii=force_radii)
    gp = pg.grid3d(c0, c1, dims, force_radii=force_radii)
    prof = rt.velocity_profile()
    return gj, gp, rt.LinearInterpolation(prof.r, prof.Vp)(gj.r)


GRID_CASES = {
    "7x5x4": ((7, 5, 4), None),
    "12x12x8": ((12, 12, 8), None),
    "force_radii": ((12, 12, 8), (R - 210.0, R - 410.0)),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid3d_copy_is_bit_equal(case):
    dims, force = GRID_CASES[case]
    gj, gp, _ = _grids(dims, force)
    for f in ("c0", "c1", "nnods", "forced_radii", "twin_offset"):
        assert getattr(gp, f) == getattr(gj, f), f
    for f in ("theta_ax", "phi_ax", "r_ax", "theta", "phi", "r", "x", "y",
              "z"):
        np.testing.assert_array_equal(getattr(gp, f), getattr(gj, f), f)
    assert (gp.nnods_total, gp.nel_total, gp.nels, len(gp)) == \
        (gj.nnods_total, gj.nel_total, gj.nels, len(gj))
    if force:
        assert gp.forced_radii == tuple(sorted(force))
    jprof = rt.velocity_profile()
    pprof = pt.velocity_profile()
    np.testing.assert_array_equal(
        pg.velocity3d(gp, pt.LinearInterpolation(pprof.r, pprof.Vp)),
        jg.velocity3d(gj, rt.LinearInterpolation(jprof.r, jprof.Vp)))
    rng = np.random.default_rng(3)
    th = np.deg2rad(rng.uniform(78.0, 102.0, 5))
    ph = np.deg2rad(rng.uniform(78.0, 102.0, 5))
    rr = rng.uniform(R - 650.0, R + 10.0, 5)
    for a, b in zip(p_s2c(th, ph, rr), j_s2c(th, ph, rr)):
        np.testing.assert_array_equal(a, b)
    for x, y, z in zip(*j_s2c(th, ph, rr)):
        assert pg.closest_point3d(gp, x, y, z) == jg.closest_point3d(gj, x, y, z)


def test_grid3d_helpers_are_bit_equal():
    gj, gp, _ = _grids((6, 6, 5))
    np.testing.assert_array_equal(pg.connectivity3d(gp), jg.connectivity3d(gj))
    for levels in (0, 1):
        a, b = pg.nodal_incidence3d(gp, levels), jg.nodal_incidence3d(gj, levels)
        assert (a != b).nnz == 0 and a.shape == b.shape
    lp = pg.lazy_grid3d(gp.c0, gp.c1, gp.nnods)
    lj = jg.lazy_grid3d(gj.c0, gj.c1, gj.nnods)
    assert lp.delta == lj.delta and len(lp) == len(lj)
    for flat in (0, 7, 63, len(gp) - 1):
        assert lp[flat] == lj[flat]
        assert pg.distance3d_nodes(gp, 0, flat) == jg.distance3d_nodes(gj, 0, flat)


@pytest.mark.parametrize("dtype,star", [("float32", 1), ("float32", 2),
                                        ("float64", 1), ("float64", 2)])
def test_shifted_weights_are_bit_equal(dtype, star):
    gj, gp, U = _grids((9, 6, 5), (R - 210.0,))
    assert ps.shifts_star(star) == js.shifts_star(star)
    Wp = ps._shifted_weights(gp, U, np.dtype(dtype), ps.shifts_star(star))
    Wj = js._shifted_weights(gj, U, np.dtype(dtype), js.shifts_star(star))
    assert Wp.dtype == Wj.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(Wp, Wj)


@pytest.mark.parametrize("block_rows", [32, 1024])
def test_plan_sweep3d_is_bit_equal(block_rows):
    gj, _, U = _grids((130, 6, 3))
    W = js._shifted_weights(gj, U, np.float32)
    pp, pj = pk.plan_sweep3d(W, block_rows), jk.plan_sweep3d(W, block_rows)
    np.testing.assert_array_equal(pp.W4, pj.W4)
    assert pp._replace(W4=None) == pj._replace(W4=None)
    assert pk.sweep3d_statics(pj.shape, block_rows) == \
        (pj.n1, pj.BR, pj.NB, pj.L0, pj.H8)
    assert pk.SHIFTS3 == jk.SHIFTS3 == ps.SHIFTS


def _plans_and_field(dims, dtype, block_rows=32, S=None, seed=0):
    """The JAX and port kernel plans of one wedge's weights, and a random
    field (S fields when S is given) with ~30 % +inf entries."""
    gj, _, U = _grids(dims)
    W = js._shifted_weights(gj, U, dtype)
    pj, pp = jk.plan_sweep3d(W, block_rows), pk.plan_sweep3d(W, block_rows)
    rng = np.random.default_rng(seed)
    shape = pj.shape if S is None else (S,) + pj.shape
    d0 = rng.uniform(0.0, 50.0, shape).astype(dtype)
    d0[rng.random(shape) < 0.3] = np.inf
    return pj, pp, d0


def _statics(plan):
    return (plan.n1, plan.BR, plan.NB, plan.L0, plan.H8)


@pytest.mark.parametrize("dims,dtype", [((7, 5, 4), np.float32),
                                        ((8, 8, 3), np.float32),
                                        ((130, 6, 3), np.float32),
                                        ((8, 8, 3), np.float64)])
def test_sweep3d_reference_equals_pallas_interpret(dims, dtype):
    pj, pp, d0 = _plans_and_field(dims, dtype)
    want = jk.sweep3d_T(jk.pack_field(jnp.asarray(d0), pj),
                        jnp.asarray(pj.W4), *_statics(pj), 3, interpret=True)
    flat = pk.pack_field(torch.from_numpy(d0), pp)
    got = pk.sweep3d_reference(flat[None], torch.from_numpy(pp.W4),
                               *_statics(pp), 3)[0]
    assert got.dtype == torch.from_numpy(d0).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).any()
    # the wrapper on a CPU tensor is the twin
    np.testing.assert_array_equal(
        pk.sweep3d_T(flat, torch.from_numpy(pp.W4), *_statics(pp), 3).numpy(),
        got.numpy())


def test_sweep3d_batched_equals_single_and_pallas():
    pj, pp, d0 = _plans_and_field((8, 8, 3), np.float32, S=3, seed=1)
    W4 = torch.from_numpy(pp.W4)
    flat = pk.pack_field(torch.from_numpy(d0), pp)
    got = pk.sweep3d_T_batched(flat, W4, *_statics(pp), 3)
    for s in range(3):
        one = pk.sweep3d_T(flat[s], W4, *_statics(pp), 3)
        np.testing.assert_array_equal(got[s].numpy(), one.numpy())
    want = jk.sweep3d_T_batched(
        jnp.stack([jk.pack_field(jnp.asarray(f), pj) for f in d0]),
        jnp.asarray(pj.W4), *_statics(pj), 3, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_and_unpack_field_match_jax():
    pj, pp, d0 = _plans_and_field((130, 6, 3), np.float32, S=2, seed=2)
    flat = pk.pack_field(torch.from_numpy(d0), pp)
    assert tuple(flat.shape) == (2, pp.NB * pp.BR, pp.L0)
    for s in range(2):
        np.testing.assert_array_equal(
            flat[s].numpy(), np.asarray(jk.pack_field(jnp.asarray(d0[s]), pj)))
    np.testing.assert_array_equal(pk.unpack_field(flat, pp).numpy(), d0)
    np.testing.assert_array_equal(pk.unpack_field(flat[1], pp).numpy(), d0[1])


def test_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    _, pp, d0 = _plans_and_field((7, 5, 4), np.float32)
    before = pk.sweep3d_T.launches
    flat = pk.pack_field(torch.from_numpy(d0), pp)[None]
    W4 = torch.from_numpy(pp.W4)
    got = pk.sweep3d_T_batched(flat, W4, *_statics(pp), 2, interpret=True)
    want = pk.sweep3d_reference(flat, W4, *_statics(pp), 2)
    assert torch.equal(got, want)
    assert pk.sweep3d_T.launches == before


def test_wrapper_refuses_bad_arguments():
    _, pp, d0 = _plans_and_field((7, 5, 4), np.float32)
    flat = pk.pack_field(torch.from_numpy(d0), pp)[None]
    W4 = torch.from_numpy(pp.W4)
    st = _statics(pp)
    with pytest.raises(ValueError, match="at least one sweep"):
        pk.sweep3d_T_batched(flat, W4, *st, 0)
    with pytest.raises(ValueError, match="dist_flat must be"):
        pk.sweep3d_T_batched(flat[:, 1:], W4, *st, 1)
    with pytest.raises(ValueError, match="W4 must be"):
        pk.sweep3d_T_batched(flat, W4[:, 1:], *st, 1)
    with pytest.raises(ValueError, match="pad rows"):
        pk.sweep3d_T_batched(flat, W4, *st[:4], pp.n1, 1)
    with pytest.raises(TypeError):
        pk.sweep3d_T_batched(flat.double(), W4, *st, 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.sweep3d_T_batched(flat.to("meta"), W4.to("meta"), *st, 1)


def _inf_field(rng, shape, dtype):
    d = rng.uniform(0.0, 300.0, shape).astype(dtype)
    d[rng.random(shape) < 0.25] = np.inf
    return d


@pytest.mark.parametrize("star", [1, 2])
def test_plain_sweep_is_bit_equal(star):
    gj, _, U = _grids((9, 6, 5))
    shifts = js.shifts_star(star)
    W = js._shifted_weights(gj, U, np.float32, shifts)
    d = _inf_field(np.random.default_rng(4), W.shape[1:], np.float32)
    want = js._sweep(jnp.asarray(d), jnp.asarray(W), shifts)
    got = ps._sweep(torch.from_numpy(d), torch.from_numpy(W), shifts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_scan_is_bit_equal(axis):
    gj, _, U = _grids((11, 7, 6))
    W = js._shifted_weights(gj, U, np.float32)
    cf, cb = js._scan_costs_of(W)[axis]
    rng = np.random.default_rng(5 + axis)
    d = _inf_field(rng, W.shape[1:], np.float32)
    cf = np.where(rng.random(cf.shape) < 0.1, np.inf, cf).astype(np.float32)
    want = js._axis_scan(jnp.asarray(d), jnp.asarray(cf), jnp.asarray(cb),
                         axis)
    got = ps._axis_scan(torch.from_numpy(d), torch.from_numpy(cf),
                        torch.from_numpy(cb), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pc = ps._scan_costs_of(W)
    for (a, b), (c, e) in zip(pc, js._scan_costs_of(W)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)


# ----------------------------------------------------------------------
# the kernel's mirrored 13-tap layout (mirror_weights) and its plain
# evaluation
# ----------------------------------------------------------------------

MIRROR_CASES = {
    # dims, block_rows: padded lanes (n0 < L0), several row blocks with
    # padded rows, two lane groups, the example's grid
    "7x5x4": ((7, 5, 4), 32),
    "8x8x3": ((8, 8, 3), 1024),
    "130x6x3": ((130, 6, 3), 32),
    "24x24x16": ((24, 24, 16), 1024),
    "7x5x9-blocks": ((7, 5, 9), 16),
}


def _plan_of(dims, dtype, block_rows):
    gj, _, U = _grids(dims)
    return pk.plan_sweep3d(js._shifted_weights(gj, U, dtype), block_rows)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_mirror_layout_rebuilds_w4(case, dtype):
    """The 26 weights the kernel reads from the 13-tap layout are W4's bit
    for bit, +inf at the box faces, the lane wrap and the padding."""
    dims, block_rows = MIRROR_CASES[case]
    plan = _plan_of(dims, dtype, block_rows)
    W4 = torch.from_numpy(plan.W4)
    M13 = pk.mirror_weights(W4, plan.n1)
    assert tuple(M13.shape) == (pk.HALF, plan.NB * plan.BR, plan.L0)
    assert M13.dtype == W4.dtype
    full = pk.expand_mirrored(M13, plan.n1)
    flat = W4.permute(1, 0, 2, 3).reshape(26, plan.NB * plan.BR, plan.L0)
    assert torch.equal(pk._bits(full), pk._bits(flat))
    assert torch.isinf(flat).any() and torch.isfinite(flat).any()
    assert pk.SHIFTS3[:pk.HALF] == tuple(
        tuple(-x for x in s) for s in pk.SHIFTS3[pk.HALF:][::-1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_mirrored_reference_equals_reference(case, dtype):
    dims, block_rows = MIRROR_CASES[case]
    plan = _plan_of(dims, dtype, block_rows)
    rng = np.random.default_rng(11)
    d0 = rng.uniform(0.0, 50.0, (2,) + plan.shape).astype(dtype)
    d0[rng.random(d0.shape) < 0.3] = np.inf
    flat = pk.pack_field(torch.from_numpy(d0), plan)
    W4 = torch.from_numpy(plan.W4)
    want = pk.sweep3d_reference(flat, W4, *_statics(plan), 3)
    got = pk.sweep3d_mirrored_reference(
        flat, pk.mirror_weights(W4, plan.n1), plan.n1, 3)
    assert torch.equal(got, want)
    assert not torch.equal(want, flat)


def test_mirror_weights_refuse_asymmetric_weights():
    plan = _plan_of((7, 5, 4), np.float32, 32)
    W4 = torch.from_numpy(plan.W4.copy())
    k, s, r, i = np.argwhere(np.isfinite(plan.W4))[0]
    W4[k, s, r, i] = W4[k, s, r, i] * 2
    with pytest.raises(ValueError, match="not mirror-symmetric"):
        pk.mirror_weights(W4, plan.n1)


def test_mirror_weights_derived_once_per_tensor():
    """Derived and checked once per W4 tensor and kept on it; an in-place
    change derives (and checks) them again."""
    plan = _plan_of((8, 8, 3), np.float32, 1024)
    W4 = torch.from_numpy(plan.W4.copy())
    M13 = pk.mirror_weights(W4, plan.n1)
    assert pk.mirror_weights(W4, plan.n1) is M13
    W4.mul_(2.0)            # still symmetric
    M2 = pk.mirror_weights(W4, plan.n1)
    assert M2 is not M13 and torch.equal(M2, 2.0 * M13)
    k, s, r, i = np.argwhere(np.isfinite(plan.W4))[0]
    W4[k, s, r, i] += 1.0
    with pytest.raises(ValueError, match="not mirror-symmetric"):
        pk.mirror_weights(W4, plan.n1)


def test_sweep3d_tiling():
    """One CTA per SM over kc k-planes of 8 j-rows and all lanes; fewer
    rows, then narrower lane chunks, then fewer fields where the four
    plane tiles would not fit 227 KB."""
    assert pk.sweep3d_tiling(128, 128, 1, 4, 64) == (128, 8, 8, 1, 21760)
    assert pk.sweep3d_tiling(128, 128, 7, 4, 64) == (128, 8, 8, 7, 152320)
    assert pk.sweep3d_tiling(128, 128, 8, 8, 64) == (128, 4, 16, 8, 208896)
    assert pk.sweep3d_tiling(5, 128, 1, 4, 5) == (128, 5, 1, 1, 15232)
    for n1, L0, S, size in ((6, 2048, 8, 8), (6, 8192, 1, 8),
                            (3, 384, 8, 8)):
        lc, tj, kc, sc, smem = pk.sweep3d_tiling(n1, L0, S, size, 3)
        assert smem <= 227 * 1024 and tj >= 1
        assert lc % 128 == 0 and L0 % lc == 0 and 1 <= sc <= S
        assert smem == 4 * sc * (tj + 2) * (lc + 8) * size
    assert pk.sweep3d_tiling(6, 2048, 8, 8, 3)[0] < 2048
    assert pk.sweep3d_tiling(600, 640, 8, 8, 3)[:2] == (128, 1)
    assert pk.sweep3d_tiling(6, 2048, 8, 8, 3)[3] == 8


def test_kernel_source_interface():
    """The CUDA source exposes the plain C launch function the wrapper
    binds with ctypes, names the TPU kernel it replaces and reads the
    mirrored weights."""
    from raytracer_tpu_torch import kernels

    with open(kernels.source_path("sweep3d")) as f:
        src = f.read()
    assert 'extern "C" int sweep3d_launch(' in src
    assert "cudaGetLastError()" in src
    assert "torch/extension.h" not in src
    assert "_make_sweep3d_kernel" in src
    assert "mirror_weights" in src
