"""PyTorch port: the slot-major 'wrapped' Jacobi engine on the CPU against
the JAX package.

`witer_reference` (T full iterations of the (Mp, S*NTL) field, the CUDA
kernel `csrc/witer.cu`'s twin) must equal the Pallas kernel
`_iter_call` in interpret mode bit for bit: every candidate is one f32
add (the ring costs s*ring_f are exact, s a power of two), min does not
depend on order, and the scans keep the TPU kernel's span schedules.
The cases cover the wrap regimes of the 128-lane theta cover - dup > nt
(ntheta 16: NTL 128, dup 112), 0 < dup < nt (ntheta 100: dup 28) and
dup == 0 (ntheta 128, where the page shifts wrap inside each source
block) - at one and two source blocks.

The solves run the twin where the JAX package runs its Pallas kernel in
interpret mode; both follow the same floats, so the fields agree far
inside the stated 2e-3 s (two units of the f32 termination slack) with
the same iteration counts.  Mirrors tests/test_diag_wrapped.py.  The
CUDA kernel runs only on the card; chip_smoke.py holds it to the twin
there.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops import diag_wrapped as jdw
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.convert import wrapped_from_numpy
from raytracer_tpu_torch.ops import diag_wrapped as pdw
from raytracer_tpu_torch.ops.diag_circulant import decompose_diagonals
from jax_mappings import below_the_map_limit  # noqa: F401,E402

TOL = 2e-3
JF32, PF32 = JConfig(dtype="float32"), PConfig(dtype="float32")
NTHETAS = [16, 100, 128]   # dup 112 (> nt), 28 (< nt), 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the plain versions
    run thousands of small ops, and while the suite's workers share the
    cores, torch's thread pool stalls at each op (a solve that takes
    half a second alone took minutes that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _static(ws):
    return pdw.WStatic(ws.rho_starts, ws.Mp, ws.NTL, ws.pad2, ws.nt)


def _field(rng, ws, S):
    """Random travel times with ~half +inf cells over every lane (each
    lane of the wrapped cover is real data)."""
    d = rng.uniform(0.0, 800.0, (ws.Mp, S * ws.NTL)).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = np.inf
    return d


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("ntheta", NTHETAS)
def test_witer_reference_matches_pallas(ntheta, S):
    _, jcg, _ = rt.init_annulus_circulant(ntheta, 3, 500.0)
    ws = wrapped_from_numpy(jdw.pack_wrapped_stencil(jcg, dtype=np.float32))
    rng = np.random.default_rng(10 * ntheta + S)
    dist = _field(rng, ws, S)
    cen = rng.uniform(0.0, 800.0, S).astype(np.float32)
    cen[0] = np.inf
    cen2d = np.broadcast_to(np.repeat(cen, 128)[None, :], (8, S * 128))
    tabs = (ws.offs, ws.wp, ws.wpT, ws.ring_f, ws.ring_b, ws.cfl, ws.cbl,
            ws.fan_w)
    want_d, want_c = jdw._iter_call(
        (ws.rho_starts, ws.Mp, ws.NTL, ws.pad2, ws.nt), jnp.asarray(dist),
        jnp.asarray(cen2d), *(jnp.asarray(a) for a in tabs), 3, True, S)
    tbl = pdw.device_wrapped_tables(ws, "cpu")
    got_d, got_c = pdw.witer_reference(_static(ws), torch.from_numpy(dist),
                                       torch.from_numpy(cen), tbl, 3)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(),
                                  np.asarray(want_c)[0, ::128])
    assert np.isfinite(got_d.numpy()).sum() > np.isfinite(dist).sum()


@pytest.mark.parametrize("ntheta", [16, 47, 100, 128])
def test_wrapped_wrap_regimes_match_jax(ntheta):
    gr, cg, jcg = _grids(ntheta, 3, 500.0)
    src = _src(gr, 25.0)
    want, it_j = jdw.solve_circulant_wrapped(jcg, [src], JF32,
                                             sweeps_per_call=2,
                                             interpret=True)
    got, it_p = pdw.solve_circulant_wrapped(cg, [src], PF32,
                                            sweeps_per_call=2, device="cpu")
    _same(got[0], want[0])
    assert it_p == it_j > 0


@pytest.mark.parametrize("ntheta,batch", [(16, 3), (128, 2)])
def test_wrapped_batching_and_centre_match_jax(ntheta, batch):
    """Uneven chunks (the last repeats its final source), a centre
    source, and at ntheta 128 (dup 0) page shifts that must wrap inside
    each source block."""
    gr, cg, jcg = _grids(ntheta)
    srcs = [_src(gr, d) for d in (0.0, 45.0, 120.0, 290.0)]
    srcs.append(cg.cmap.center)
    want, it_j = jdw.solve_circulant_wrapped(jcg, srcs, JF32,
                                             sweeps_per_call=2,
                                             interpret=True, batch=batch)
    got, it_p = pdw.solve_circulant_wrapped(cg, srcs, PF32,
                                            sweeps_per_call=2, batch=batch,
                                            device="cpu")
    assert got.shape == want.shape == (len(srcs), gr.nnods)
    for i in range(len(srcs)):
        _same(got[i], want[i])
    assert it_p == it_j


def test_wrapped_receivers_and_device_out():
    gr, cg, _ = _grids(16)
    srcs = [_src(gr, d) for d in (0.0, 45.0, 120.0)]
    recs = [_src(gr, d) for d in (30.0, 90.0, 260.0)] + [cg.cmap.center]
    full, it = pdw.solve_circulant_wrapped(cg, srcs, PF32, batch=2,
                                           device="cpu")
    rec, _ = pdw.solve_circulant_wrapped(cg, srcs, PF32, batch=2,
                                         receivers=recs, device="cpu")
    assert rec.shape == (len(srcs), len(recs))
    np.testing.assert_array_equal(rec, full[:, recs])
    dev, it_dev = pdw.solve_circulant_wrapped(cg, srcs, PF32, batch=2,
                                              device_out=True, device="cpu")
    assert isinstance(dev, torch.Tensor) and it_dev == it
    np.testing.assert_array_equal(dev.numpy(), full)


def test_wrapped_vertical_closure_matches_jax():
    gr, cg, jcg = _grids(16)
    src = _src(gr, 0.0)
    want, it_j = jdw.solve_circulant_wrapped(jcg, [src], JF32,
                                             sweeps_per_call=2,
                                             interpret=True,
                                             vertical_closure=2)
    got, it_p = pdw.solve_circulant_wrapped(cg, [src], PF32,
                                            sweeps_per_call=2,
                                            vertical_closure=2, device="cpu")
    _same(got[0], want[0])
    assert it_p == it_j
    _, it_0 = pdw.solve_circulant_wrapped(cg, [src], PF32, sweeps_per_call=2,
                                          device="cpu")
    assert it_p <= it_0  # composed vertical diagonals only help


@pytest.mark.parametrize("weight_mode,pre_roll",
                         [("transpose", False), ("reduce", True)])
def test_wrapped_layout_variants_match_jax(weight_mode, pre_roll):
    """The TPU kernel's VMEM layout variants give the same floats; the
    port accepts them and runs its one layout."""
    gr, cg, jcg = _grids(16)
    src = _src(gr, 0.0)
    want, it_j = jdw.solve_circulant_wrapped(
        jcg, [src, src], JF32, sweeps_per_call=2, interpret=True, batch=2,
        weight_mode=weight_mode, pre_roll=pre_roll)
    got, it_p = pdw.solve_circulant_wrapped(
        cg, [src, src], PF32, sweeps_per_call=2, batch=2,
        weight_mode=weight_mode, pre_roll=pre_roll, device="cpu")
    for i in range(2):
        _same(got[i], want[i])
    assert it_p == it_j


def test_wrapped_centre_source_matches_jax():
    gr, cg, jcg = _grids(47, 3, 500.0)
    srcs = [cg.cmap.center, _src(gr, 0.0)]
    want, it_j = jdw.solve_circulant_wrapped(jcg, srcs, JF32,
                                             sweeps_per_call=4,
                                             interpret=True)
    got, it_p = pdw.solve_circulant_wrapped(cg, srcs, PF32,
                                            sweeps_per_call=4, device="cpu")
    for i in range(2):
        _same(got[i], want[i])
    assert it_p == it_j


def test_wrapped_refuses_unsupported_ntheta():
    _, cg, _ = _grids(127, 3, 500.0)
    assert not pdw.supports_wrapped(cg)
    with pytest.raises(ValueError, match="solve_circulant_diag"):
        pdw.solve_circulant_wrapped(cg, [0], PF32, device="cpu")
    for nt, ok in [(7, False), (8, True), (126, True), (255, False),
                   (256, True)]:
        stub = SimpleNamespace(ntheta=nt)  # the rule reads ntheta only
        assert pdw.supports_wrapped(stub) is ok, nt
        assert jdw.supports_wrapped(stub) is ok, nt


def test_jax_packed_stencil_gives_the_same_solve():
    """A stencil packed by the JAX package, carried across by convert.py,
    solves to the same field as the port's own packing."""
    gr, cg, jcg = _grids(47, 3, 500.0)
    src = _src(gr, 100.0)
    jws = jdw.pack_wrapped_stencil(jcg, dtype=np.float32)
    got, it = pdw.solve_circulant_wrapped(cg, [src], PF32, device="cpu",
                                          _packed=wrapped_from_numpy(jws))
    own, it_own = pdw.solve_circulant_wrapped(cg, [src], PF32, device="cpu")
    np.testing.assert_array_equal(got, own)
    assert it == it_own


@pytest.mark.parametrize("vertical_closure", [0, 2])
def test_wrapped_taps_are_the_grouped_diagonals(vertical_closure):
    """The CUDA kernel's (dm, dc) per grouped diagonal, decoded from the
    TPU offsets, are the decomposition's diagonals with finite weights;
    the padding diagonals keep +inf weights."""
    _, cg, _ = _grids(16)
    ws = pdw.pack_wrapped_stencil(cg, vertical_closure=vertical_closure)
    taps = pdw.wrapped_taps(ws)
    real = np.isfinite(ws.wpT[:ws.D, :ws.Mp]).any(axis=1)
    dec = decompose_diagonals(cg)
    keys = {(int(a), int(b)) for a, b in zip(dec.dms, dec.dcs)}
    got = {(int(a), int(b)) for a, b in taps[real]}
    assert keys <= got
    assert len(got) == real.sum()     # no diagonal twice
    assert all(r % 8 == dm % 8 for r in range(8)
               for dm, _ in taps[ws.rho_starts[r]:ws.rho_starts[r + 1]][
                   real[ws.rho_starts[r]:ws.rho_starts[r + 1]]])


def test_witer_takes_the_twin_on_cpu_and_counts_no_launch():
    _, cg, _ = _grids(100, 3, 500.0)
    ws = pdw.pack_wrapped_stencil(cg)
    tbl = pdw.device_wrapped_tables(ws, "cpu")
    rng = np.random.default_rng(3)
    dist = torch.from_numpy(_field(rng, ws, 2))
    cen = torch.tensor([0.5, np.inf], dtype=torch.float32)
    n = pdw.witer.launches
    d1, c1 = pdw.witer(_static(ws), dist, cen, tbl, 2)
    d2, c2 = pdw.witer_reference(_static(ws), dist, cen, tbl, 2)
    assert torch.equal(d1, d2) and torch.equal(c1, c2)
    assert pdw.witer.launches == n


def test_witer_refuses_bad_arguments():
    _, cg, _ = _grids(16)
    ws = pdw.pack_wrapped_stencil(cg)
    st = _static(ws)
    tbl = pdw.device_wrapped_tables(ws, "cpu")
    with pytest.raises(ValueError, match="dist must be"):
        pdw.witer(st, torch.zeros((ws.Mp, ws.NTL + 1)), torch.zeros(1),
                  tbl, 1)
    with pytest.raises(ValueError, match="cen must be"):
        pdw.witer(st, torch.zeros((ws.Mp, 2 * ws.NTL)), torch.zeros(1),
                  tbl, 1)
    with pytest.raises(ValueError, match="wpT must be"):
        pdw.witer(st, torch.zeros((ws.Mp, ws.NTL)), torch.zeros(1),
                  tbl._replace(wpT=tbl.wpT[:8]), 1)
    meta = torch.zeros((ws.Mp, ws.NTL), device="meta")
    mtbl = pdw.WTables(*(torch.zeros(t.shape, dtype=t.dtype, device="meta")
                         for t in tbl))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pdw.witer(st, meta, torch.zeros(1, device="meta"), mtbl, 1)
