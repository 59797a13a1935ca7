"""PyTorch port: the 'twrapped' Jacobi engine and the plain 'circulant'
oracle on the CPU against the JAX package.

The port's twrapped solve runs `titer_reference` (the CUDA kernel's
twin) where the JAX package runs its Pallas kernel in interpret mode;
both follow the same floats, so the fields agree far inside the stated
2e-3 s (two units of the f32 termination slack) and the iteration counts
match.  Mirrors tests/test_wrapped_t.py: the wrap regimes of the 8-row
theta cover, source batching with duplicate rows, centre sources,
receiver extraction, device_out, and the vertical and band closures.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops import circulant as jci
from raytracer_tpu.ops import wrapped_t as jwt
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.convert import stencil_from_numpy
from raytracer_tpu_torch.ops import circulant as pci
from raytracer_tpu_torch.ops import wrapped_t as pwt
from jax_mappings import below_the_map_limit  # noqa: F401,E402

TOL = 2e-3
JF32, PF32 = JConfig(dtype="float32"), PConfig(dtype="float32")


def _grids(ntheta, nr=4, spacing=400.0):
    gr, cg, _ = pt.init_annulus_circulant(ntheta, nr, spacing)
    _, jcg, _ = rt.init_annulus_circulant(ntheta, nr, spacing)
    return gr, cg, jcg


def _src(gr, deg):
    return pt.closest_point(gr, np.deg2rad(deg), pt.R, system="polar")


def _same(got, want):
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=TOL)


@pytest.mark.parametrize("ntheta", [9, 12, 16, 20, 24, 30])
def test_twrapped_wrap_regimes_match_jax(ntheta):
    gr, cg, jcg = _grids(ntheta, 3, 500.0)
    src = _src(gr, 25.0)
    want, it_j = jwt.solve_circulant_twrapped(jcg, [src], JF32,
                                              sweeps_per_call=2,
                                              interpret=True)
    got, it_p = pwt.solve_circulant_twrapped(cg, [src], PF32,
                                             sweeps_per_call=2, device="cpu")
    _same(got[0], want[0])
    assert it_p == it_j > 0


def test_twrapped_batching_dup_rows_and_centre_match_jax():
    gr, cg, jcg = _grids(20)
    srcs = [_src(gr, d) for d in (0.0, 95.0, 200.0, 310.0, 170.0)]
    srcs.append(cg.cmap.center)
    want, it_j = jwt.solve_circulant_twrapped(jcg, srcs, JF32,
                                              sweeps_per_call=2,
                                              interpret=True, batch=2)
    got, it_p = pwt.solve_circulant_twrapped(cg, srcs, PF32,
                                             sweeps_per_call=2, batch=2,
                                             device="cpu")
    assert got.shape == want.shape == (len(srcs), gr.nnods)
    for i in range(len(srcs)):
        _same(got[i], want[i])
    assert it_p == it_j


def test_twrapped_receivers_and_device_out():
    gr, cg, _ = _grids(16)
    srcs = [_src(gr, d) for d in (0.0, 45.0, 120.0)]
    recs = [_src(gr, d) for d in (30.0, 90.0, 260.0)] + [cg.cmap.center]
    full, it = pwt.solve_circulant_twrapped(cg, srcs, PF32, batch=2,
                                            device="cpu")
    rec, _ = pwt.solve_circulant_twrapped(cg, srcs, PF32, batch=2,
                                          receivers=recs, device="cpu")
    np.testing.assert_array_equal(rec, full[:, recs])
    dev, it_dev = pwt.solve_circulant_twrapped(cg, srcs, PF32, batch=2,
                                               device_out=True, device="cpu")
    assert isinstance(dev, torch.Tensor) and it_dev == it
    np.testing.assert_array_equal(dev.numpy(), full)


@pytest.mark.parametrize("vc,bc", [(0, 0), (0, 1), (0, 2), (2, 0)])
def test_twrapped_closures_match_jax(vc, bc):
    gr, cg, jcg = _grids(20)
    src = _src(gr, 0.0)
    want, it_j = jwt.solve_circulant_twrapped(
        jcg, [src], JF32, sweeps_per_call=1, interpret=True,
        vertical_closure=vc, band_closure=bc)
    got, it_p = pwt.solve_circulant_twrapped(
        cg, [src], PF32, sweeps_per_call=1, vertical_closure=vc,
        band_closure=bc, device="cpu")
    _same(got[0], want[0])
    assert it_p == it_j


def test_twrapped_s_wave_zero_velocity_core():
    """Vs = 0 in the outer core: +inf weights survive the closure and the
    moving-frame pack; the unreachable set is the JAX package's."""
    gr, A, halo = pt.init_annulus(16, 6, spacing=200.0)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r, prof.Vs))
    cg = pci.build_circulant(gr, A, halo, U, dtype=np.float32)
    jgr, jA, jhalo = rt.init_annulus(16, 6, spacing=200.0)
    jcg = jci.build_circulant(jgr, jA, jhalo, U, dtype=np.float32)
    src = _src(gr, 0.0)
    want, _ = jwt.solve_circulant_twrapped(jcg, [src], JF32, interpret=True,
                                           band_closure=1)
    got, _ = pwt.solve_circulant_twrapped(cg, [src], PF32, band_closure=1,
                                          device="cpu")
    assert not np.isnan(got).any() and not np.isfinite(got).all()
    _same(got[0], want[0])


def test_twrapped_refuses_unsupported_ntheta():
    _, cg, _ = _grids(15, 3, 500.0)
    assert not pwt.supports_twrapped(cg)
    with pytest.raises(ValueError, match="solve_circulant_wrapped/diag"):
        pwt.solve_circulant_twrapped(cg, [0], PF32, device="cpu")


def test_jax_packed_stencil_gives_the_same_solve():
    """A stencil packed by the JAX package, carried across by convert.py,
    solves to the same field as the port's own packing."""
    gr, cg, jcg = _grids(20)
    src = _src(gr, 100.0)
    jws = jwt.pack_twrapped_stencil(jcg, dtype=np.float32, band_closure=1)
    got, it = pwt.solve_circulant_twrapped(cg, [src], PF32, device="cpu",
                                           _packed=stencil_from_numpy(jws))
    own, it_own = pwt.solve_circulant_twrapped(cg, [src], PF32,
                                               band_closure=1, device="cpu")
    np.testing.assert_array_equal(got, own)
    assert it == it_own


@pytest.mark.parametrize("NTT,ML,rows", [(184, 896, 488), (1080, 896, 88),
                                         (2160, 1664, 560), (16, 128, 40)])
def test_max_twrapped_batch_equals_jax(NTT, ML, rows):
    class _T:  # minimal TWStencil stand-in
        def __init__(self):
            self.NTT, self.ML = NTT, ML
            self.wrows = np.zeros((rows, ML), np.float32)

    assert pwt.max_twrapped_batch(_T()) == jwt.max_twrapped_batch(_T())


def test_max_twrapped_batch_on_real_stencil():
    _, cg, jcg = _grids(20)
    for bc in (0, 1):
        p = pwt.pack_twrapped_stencil(cg, dtype=np.float32, band_closure=bc)
        j = jwt.pack_twrapped_stencil(jcg, dtype=np.float32, band_closure=bc)
        assert pwt.max_twrapped_batch(p) == jwt.max_twrapped_batch(j) >= 1


@pytest.mark.parametrize("ntheta,deg", [(16, 0.0), (15, 47.0), (20, None)])
def test_solve_circulant_matches_jax(ntheta, deg):
    gr, cg, jcg = _grids(ntheta, 3, 500.0)
    src = cg.cmap.center if deg is None else _src(gr, deg)
    want, it_j = jci.solve_circulant(jcg, src, JF32)
    got, it_p = pci.solve_circulant(cg, src, PF32, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert it_p == it_j
