"""PyTorch port: the Jacobi engines' kernels' plain versions against the
JAX package's Pallas kernels (interpret mode), bit for bit.

`titer_reference` (T full Jacobi iterations of the theta-major page) and
`band_reference` (the streamed band sweep) follow their Pallas bodies op
for op: every candidate is one f32 add (the ring costs s*ring_f are
exact, s a power of two), min does not depend on order, and the span
schedules of the scans are the TPU kernel's.  So the floats must be the
same, across the wrap regimes of the 8-row theta cover (dup = NTT - nt =
7, 4, 0, 4, 0, 2 at ntheta 9, 12, 16, 20, 24, 30) and at one and two
source blocks.  The CUDA kernels run only on the card; chip_smoke.py
holds them to these twins there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.ops import stream_t as jst
from raytracer_tpu.ops import wrapped_t as jwt
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.convert import stencil_from_numpy
from raytracer_tpu_torch.ops import stream_t as pst
from raytracer_tpu_torch.ops import wrapped_t as pwt

NTHETAS = [9, 12, 16, 20, 24, 30]


def _jax_stencil(ntheta, band_closure=1):
    _, jcg, _ = rt.init_annulus_circulant(ntheta, 4, 400.0)
    return jwt.pack_twrapped_stencil(jcg, dtype=np.float32,
                                     band_closure=band_closure)


def _field(rng, rows, ws):
    """Random travel times with +inf cells; +inf pad lanes [Mp, ML), the
    invariant every table keeps."""
    d = rng.uniform(0.0, 800.0, (rows, ws.ML)).astype(np.float32)
    d[rng.random(d.shape) < 0.4] = np.inf
    d[:, ws.Mp:] = np.inf
    return d


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("ntheta", NTHETAS)
def test_titer_reference_matches_pallas(ntheta, S):
    jws = _jax_stencil(ntheta)
    ws = stencil_from_numpy(jws)
    rng = np.random.default_rng(10 * ntheta + S)
    dist = _field(rng, S * ws.NTT, ws)
    cen = rng.uniform(0.0, 800.0, S).astype(np.float32)
    cen[0] = np.inf
    cen2d = np.broadcast_to(np.repeat(cen, 128)[None, :], (8, S * 128))
    tabs = (ws.wrows, ws.ring_f, ws.ring_b, ws.cfl, ws.cbl, ws.fan_w)
    want_d, want_c = jwt._titer_call(
        (ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm), jnp.asarray(dist),
        jnp.asarray(cen2d), *(jnp.asarray(a) for a in tabs), 3, True, S)
    st = pwt.TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)
    tbl = pwt.TWTables(*(torch.from_numpy(a) for a in tabs))
    got_d, got_c = pwt.titer_reference(st, torch.from_numpy(dist),
                                       torch.from_numpy(cen), tbl, 3)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(),
                                  np.asarray(want_c)[0, ::128])
    assert np.isfinite(got_d.numpy()).sum() > np.isfinite(dist).sum()


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("ntheta", NTHETAS)
def test_band_reference_matches_pallas(ntheta, S):
    ws = stencil_from_numpy(_jax_stencil(ntheta))
    rng = np.random.default_rng(20 * ntheta + S)
    v = _field(rng, S * ws.nt, ws).reshape(S, ws.nt, ws.ML)
    stack = np.stack([np.roll(v, -dc, axis=1) for dc in range(-2, 3)])
    TB = 8          # several theta blocks, the last one padded
    NTB = -(-ws.nt // TB) * TB
    padded = np.pad(stack, ((0, 0), (0, 0), (0, NTB - ws.nt), (0, 0)),
                    constant_values=np.inf)
    want = np.asarray(jst._band_call(jnp.asarray(padded),
                                     jnp.asarray(ws.wrows), ws.maxdm, TB,
                                     True))[:, :ws.nt]
    got = pst.band_reference(torch.from_numpy(stack),
                             torch.from_numpy(ws.wrows), ws.maxdm)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_the_twin_on_cpu_and_count_no_launch():
    ws = stencil_from_numpy(_jax_stencil(20))
    st = pwt.TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)
    tbl = pwt.device_twrapped_tables(ws, "cpu")
    rng = np.random.default_rng(3)
    dist = torch.from_numpy(_field(rng, 2 * ws.NTT, ws))
    cen = torch.tensor([0.5, np.inf], dtype=torch.float32)
    n_titer, n_band = pwt.titer.launches, pst.band.launches
    d1, c1 = pwt.titer(st, dist, cen, tbl, 2)
    d2, c2 = pwt.titer_reference(st, dist, cen, tbl, 2)
    assert torch.equal(d1, d2) and torch.equal(c1, c2)
    v = dist.view(2, ws.NTT, ws.ML)
    stack = torch.stack([torch.roll(v, -dc, 1) for dc in range(-2, 3)])
    assert torch.equal(pst.band(v, tbl.wrows, ws.maxdm),
                       pst.band_reference(stack, tbl.wrows, ws.maxdm))
    assert (pwt.titer.launches, pst.band.launches) == (n_titer, n_band)


def test_wrappers_refuse_bad_arguments():
    ws = stencil_from_numpy(_jax_stencil(16))
    st = pwt.TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)
    tbl = pwt.device_twrapped_tables(ws, "cpu")
    dist = torch.zeros((ws.NTT + 1, ws.ML))
    with pytest.raises(ValueError, match="dist must be"):
        pwt.titer(st, dist, torch.zeros(1), tbl, 1)
    with pytest.raises(ValueError, match="cen must be"):
        pwt.titer(st, torch.zeros((2 * ws.NTT, ws.ML)), torch.zeros(1),
                  tbl, 1)
    with pytest.raises(ValueError, match="v must be"):
        pst.band(torch.zeros((5, 1, ws.nt, ws.ML)), tbl.wrows, ws.maxdm)
    with pytest.raises(ValueError, match="does not fit"):
        pst.band(torch.zeros((1, ws.nt, ws.ML)), tbl.wrows[:5], ws.maxdm)


def test_meta_device_raises():
    """A device that is neither the CPU nor CUDA is refused, never
    replaced by the CPU."""
    ws = stencil_from_numpy(_jax_stencil(16))
    v = torch.zeros((1, ws.nt, ws.ML), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pst.band(v, torch.zeros(ws.wrows.shape, device="meta"), ws.maxdm)


def test_port_packing_equals_jax():
    """The port's own packer gives the JAX package's tables bit for bit,
    with the vertical and band closures."""
    gr, cg, _ = pt.init_annulus_circulant(20, 4, 400.0)
    _, jcg, _ = rt.init_annulus_circulant(20, 4, 400.0)
    for vc, bc in [(0, 0), (0, 1), (2, 0), (1, 2)]:
        j = jwt.pack_twrapped_stencil(jcg, dtype=np.float32,
                                      vertical_closure=vc, band_closure=bc)
        p = pwt.pack_twrapped_stencil(cg, dtype=np.float32,
                                      vertical_closure=vc, band_closure=bc)
        for name in ("wrows", "ring_f", "ring_b", "cfl", "cbl", "fan_w"):
            np.testing.assert_array_equal(getattr(p, name),
                                          np.asarray(getattr(j, name)))
        assert (p.maxdm, p.Mp, p.ML, p.M, p.nt, p.NTT) == \
            (j.maxdm, j.Mp, j.ML, j.M, j.nt, j.NTT)
