"""PyTorch port: the 'stream' Jacobi engine on the CPU against the JAX
package.

The port's level loop runs `band_reference` (the CUDA band kernel's
twin) where the JAX package runs its Pallas band kernel in interpret
mode, and the scans op for op; the fields agree within the stated
2e-3 s (two units of the f32 termination slack; in practice bit for bit)
and the iteration counts, summed over the warm levels, match.  Mirrors
tests/test_stream_t.py: theta counts the twrapped engine refuses, cold
and warm starts, odd source columns, centre sources, band closures,
receivers and device_out; plus the host helpers and the tables carried
across from the JAX package.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops import stream_t as jst
from raytracer_tpu.ops import wrapped_t as jwt
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.convert import (stencil_from_numpy,
                                         stream_level_from_numpy)
from raytracer_tpu_torch.ops import diag_circulant as pdc
from raytracer_tpu_torch.ops import stream_t as pst
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


def _both(jcg, cg, srcs, **kw):
    want, it_j = jst.solve_circulant_stream(jcg, srcs, JF32, interpret=True,
                                            **kw)
    got, it_p = pst.solve_circulant_stream(cg, srcs, PF32, device="cpu", **kw)
    assert got.shape == want.shape
    for i in range(len(srcs)):
        _same(got[i], want[i])
    assert it_p == it_j > 0
    return got, it_p


@pytest.mark.parametrize("ntheta", [9, 15, 16, 20, 30])
def test_stream_cold_matches_jax(ntheta):
    """ntheta=15 has dup=1, which the twrapped engine refuses; the
    streamed engine has no wrap cover and takes any theta count."""
    gr, cg, jcg = _grids(ntheta, 3, 500.0)
    _both(jcg, cg, [_src(gr, 25.0)], warm_levels=0)


@pytest.mark.parametrize("levels", [1, 2])
def test_stream_warm_levels_match_jax(levels):
    gr, cg, jcg = _grids(16)
    _both(jcg, cg, [_src(gr, 70.0)], warm_levels=levels)


def test_stream_warm_odd_source_columns_and_centre_match_jax():
    gr, cg, jcg = _grids(20)
    srcs = [_src(gr, d) for d in (9.0, 27.0, 45.0, 63.0, 81.0)]
    srcs.append(cg.cmap.center)
    assert len({int(cg.cmap.c_of[s]) % 2 for s in srcs[:-1]}) == 2
    _both(jcg, cg, srcs, batch=3, warm_levels=1)


@pytest.mark.parametrize("bc", [0, 1, 2])
def test_stream_band_closure_matches_jax(bc):
    gr, cg, jcg = _grids(20)
    _both(jcg, cg, [_src(gr, 0.0)], band_closure=bc, warm_levels=0)


def test_stream_warm_with_band_closure_matches_jax():
    gr, cg, jcg = _grids(16, 6, 200.0)
    _both(jcg, cg, [_src(gr, 0.0)], band_closure=1, warm_levels=2)


def test_stream_warm_levels_stop_at_odd_nt():
    gr, cg, jcg = _grids(9, 3, 500.0)
    cold, _ = _both(jcg, cg, [_src(gr, 40.0)], warm_levels=0)
    warm, _ = _both(jcg, cg, [_src(gr, 40.0)], warm_levels=3)
    np.testing.assert_array_equal(warm, cold)


def test_stream_config_warm_levels_and_receivers():
    """warm_levels=None takes SolverConfig.warm_levels; receivers are the
    full field's columns; device_out leaves the rows as a tensor."""
    gr, cg, _ = _grids(16)
    srcs = [_src(gr, d) for d in (0.0, 45.0, 120.0)]
    recs = [_src(gr, d) for d in (30.0, 90.0, 260.0)] + [cg.cmap.center]
    full, it = pst.solve_circulant_stream(cg, srcs, PF32, batch=2,
                                          device="cpu")
    warm_cfg = PConfig(dtype="float32", warm_levels=1)
    warm, it_w = pst.solve_circulant_stream(cg, srcs, warm_cfg, batch=2,
                                            device="cpu")
    warm1, it_w1 = pst.solve_circulant_stream(cg, srcs, PF32, batch=2,
                                              warm_levels=1, device="cpu")
    np.testing.assert_array_equal(warm, warm1)
    assert it_w == it_w1
    _same(warm[0], full[0])
    rec, _ = pst.solve_circulant_stream(cg, srcs, PF32, batch=2,
                                        receivers=recs, device="cpu")
    np.testing.assert_array_equal(rec, full[:, recs])
    dev, it_dev = pst.solve_circulant_stream(cg, srcs, PF32, batch=2,
                                             device_out=True, device="cpu")
    assert isinstance(dev, torch.Tensor) and it_dev == it
    np.testing.assert_array_equal(dev.numpy(), full)


def test_stream_and_twrapped_same_fixpoint_on_one_stencil():
    gr, cg, _ = _grids(16)
    ws = pwt.pack_twrapped_stencil(cg, dtype=np.float32, band_closure=1)
    src = _src(gr, 100.0)
    d_t, _ = pwt.solve_circulant_twrapped(cg, [src], PF32, device="cpu",
                                          _packed=ws)
    d_s, _ = pst.solve_circulant_stream(cg, [src], PF32, device="cpu",
                                        _packed=ws)
    _same(d_s[0], d_t[0])


@pytest.mark.parametrize("ntheta,bc,n_levels", [(20, 1, 1), (32, 0, 2)])
def test_coarsen_theta_equals_jax(ntheta, bc, n_levels):
    _, cg, jcg = _grids(ntheta)
    dec = pdc.decompose_diagonals(cg)
    dms, dcs, wmat = dec.dms, dec.dcs, dec.wmat.copy()
    if bc:
        dms, dcs, wmat = pwt._compose_band(dms, dcs, wmat, dec.pad, bc)
    got = pst._coarsen_theta(dms, dcs, wmat, dec.pad)
    want = jst._coarsen_theta(dms, dcs, wmat.copy(), dec.pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # and the warm stencils packed from them
    ws_p = pwt.pack_twrapped_stencil(cg, dtype=np.float32, band_closure=bc)
    ws_j = jwt.pack_twrapped_stencil(jcg, dtype=np.float32, band_closure=bc)
    lv_p = pst._warm_stencils(ws_p, cg, np.float32, bc, 2)
    lv_j = jst._warm_stencils(ws_j, jcg, np.float32, bc, 2)
    assert len(lv_p) == len(lv_j) == n_levels
    for p, j in zip(lv_p, lv_j):
        np.testing.assert_array_equal(p.wrows, np.asarray(j.wrows))
        assert (p.nt, p.maxdm, p.ML) == (j.nt, j.maxdm, j.ML)


@pytest.mark.parametrize("nt,ML,rows", [(180, 896, 488), (1080, 896, 88),
                                        (2160, 1664, 560), (6, 128, 16),
                                        (4000, 4096, 96)])
def test_pick_block_equals_jax(nt, ML, rows):
    for itemsize in (4, 8):
        assert pst._pick_block(nt, ML, rows, itemsize) == \
            jst._pick_block(nt, ML, rows, itemsize)


def test_auto_warm_levels_and_pow_spans_equal_jax():
    for nt in (8, 180, 999, 1000, 1080, 1200, 1201, 1440, 2160):
        assert pst.auto_warm_levels(nt) == jst.auto_warm_levels(nt)
    assert pst.auto_warm_levels(1080) == 1
    for n in (1, 2, 3, 7, 8, 9, 100, 1277):
        assert pst._pow_spans(n) == jst._pow_spans(n)


def test_stream_level_tables_carried_from_jax():
    """One level's StreamTables/LevelStatic packed by the JAX package,
    carried across by convert.py, equal the port's and run the port's
    level loop to the JAX level loop's field."""
    gr, cg, jcg = _grids(16)
    jws = jwt.pack_twrapped_stencil(jcg, dtype=np.float32, band_closure=1)
    jtbl, jstatic = jst._stream_tables(jws, np.float32)
    tbl, static = stream_level_from_numpy(jtbl, jstatic)
    own_tbl, own_static = pst._stream_tables(
        pwt.pack_twrapped_stencil(cg, dtype=np.float32, band_closure=1),
        np.float32)
    assert static == own_static
    for a, b in zip(tbl, own_tbl):
        np.testing.assert_array_equal(a, b)

    src = _src(gr, 30.0)
    c, m = int(cg.cmap.c_of[src]), int(cg.cmap.m_of[src])
    d0 = np.full((1, static.nt, static.ML), np.inf, np.float32)
    d0[0, c, m] = 0.0
    c0 = np.full(1, np.inf, np.float32)
    tol = np.float32(1e-3)
    want = jst._run_level(jnp.asarray(d0), jnp.asarray(c0),
                          jnp.zeros((), jnp.int32), jtbl, jstatic,
                          jnp.asarray(tol), 10_000, True)
    got = pst._run_level(torch.from_numpy(d0), torch.from_numpy(c0), 0,
                         pst.StreamTables(*(torch.tensor(a) for a in tbl)),
                         static, torch.tensor(tol), 10_000)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert got.it == int(want.it)

    # and a whole solve on the JAX-packed stencil
    d_j, it_j = pst.solve_circulant_stream(
        cg, [src], PF32, device="cpu", _packed=stencil_from_numpy(jws))
    d_p, it_p = pst.solve_circulant_stream(cg, [src], PF32, band_closure=1,
                                           device="cpu")
    np.testing.assert_array_equal(d_j, d_p)
    assert it_j == it_p


def _band_case(name):
    """(wrows, maxdm, Mp, nt) of a band sweep: the 16x4 weights on fields
    of 3 and 5 theta rows (the wrap folds rows dc = -2..2 onto each
    other), a 30x4 stencil, and the 1080x300 warm level's coarse weights
    on a cut of 24 of its 540 theta rows."""
    if name == "coarse 1080x300, 24 rows":
        _, cg, _ = pt.init_annulus_circulant(1080, 300, 20.0)
        ws = pwt.pack_twrapped_stencil(cg, dtype=np.float32, band_closure=1)
        ws = pst._warm_stencils(ws, cg, np.float32, 1, 1)[0]
        return ws.wrows, ws.maxdm, ws.Mp, 24
    ntheta, nt = {"16x4, 3 rows": (16, 3), "16x4, 5 rows": (16, 5),
                  "30x4": (30, 30)}[name]
    _, jcg, _ = rt.init_annulus_circulant(ntheta, 4, 400.0)
    ws = jwt.pack_twrapped_stencil(jcg, dtype=np.float32, band_closure=1)
    return ws.wrows, ws.maxdm, ws.Mp, nt


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("name", ["16x4, 3 rows", "16x4, 5 rows", "30x4",
                                  "coarse 1080x300, 24 rows"])
def test_band_field_form_equals_stack_form_and_pallas(name, S):
    """`band` takes the field and rolls theta itself (on the CPU through
    its plain version); it equals `band_reference` on the explicit stack
    of 5 rolled pages and the JAX Pallas kernel in interpret mode, bit for
    bit, with the theta wrap exact at any row count."""
    wrows, maxdm, Mp, nt = _band_case(name)
    ML = wrows.shape[1]
    rng = np.random.default_rng(7 * nt + S)
    v = rng.uniform(0.0, 800.0, (S, nt, ML)).astype(np.float32)
    v[rng.random(v.shape) < 0.4] = np.inf
    v[..., Mp:] = np.inf
    stack = np.stack([np.roll(v, -dc, axis=1) for dc in range(-2, 3)])
    TB = 8
    NTB = -(-nt // TB) * TB
    padded = np.pad(stack, ((0, 0), (0, 0), (0, NTB - nt), (0, 0)),
                    constant_values=np.inf)
    want = np.asarray(jst._band_call(jnp.asarray(padded), jnp.asarray(wrows),
                                     maxdm, TB, True))[:, :nt]
    w = torch.from_numpy(np.ascontiguousarray(wrows))
    got = pst.band(torch.from_numpy(v), w, maxdm)
    ref = pst.band_reference(torch.from_numpy(stack), w, maxdm)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.numpy(), want)
    assert np.isfinite(want).sum() > np.isfinite(v).sum()


@pytest.mark.parametrize("ntheta", [20, 30])
def test_run_level_with_the_field_form_band_equals_jax(ntheta):
    """One level's loop, two sources, the band sweep taking the field:
    the same field and iteration count as the JAX level loop."""
    gr, cg, jcg = _grids(ntheta)
    jws = jwt.pack_twrapped_stencil(jcg, dtype=np.float32, band_closure=1)
    jtbl, jstatic = jst._stream_tables(jws, np.float32)
    tbl, static = pst._stream_tables(
        pwt.pack_twrapped_stencil(cg, dtype=np.float32, band_closure=1),
        np.float32)
    d0 = np.full((2, static.nt, static.ML), np.inf, np.float32)
    for b, deg in enumerate((30.0, 200.0)):
        src = _src(gr, deg)
        d0[b, int(cg.cmap.c_of[src]), int(cg.cmap.m_of[src])] = 0.0
    c0 = np.full(2, np.inf, np.float32)
    tol = np.float32(1e-3)
    want = jst._run_level(jnp.asarray(d0), jnp.asarray(c0),
                          jnp.zeros((), jnp.int32), jtbl, jstatic,
                          jnp.asarray(tol), 10_000, True)
    got = pst._run_level(torch.from_numpy(d0), torch.from_numpy(c0), 0,
                         pst.StreamTables(*(torch.tensor(a) for a in tbl)),
                         static, torch.tensor(tol), 10_000)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert got.it == int(want.it) > 1
