"""PyTorch port: the directional-sweep solve against the JAX package.

The port's `solve_circulant_sweep` (plain versions on the CPU) must take
the same rounds as the JAX pallas engine in interpret mode and agree
with its field to 1e-4 s: float32's ulp at ~1000 s is 6e-5 s and the
order of operations is the same.  Against the Jacobi fixpoint of JAX's
`solve_circulant` it must agree to TOL = 2e-3 s, two tol units of f32
termination slack, as tests/test_sweep_theta.py holds the JAX solver.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops import sweep_theta as jsw
from raytracer_tpu.ops.circulant import solve_circulant
from raytracer_tpu.ops.wrapped_t import pack_twrapped_stencil as j_pack
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.ops import sweep_theta as psw
from raytracer_tpu_torch.ops.wrapped_t import \
    pack_twrapped_stencil as p_pack

JCFG = JConfig(dtype="float32")
CFG = pt.SolverConfig(dtype="float32")
TOL = 2e-3
PALLAS_ATOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    jgr, jcg, _ = rt.init_annulus_circulant(48, 12, 150.0)
    gr, cg, _ = pt.init_annulus_circulant(48, 12, 150.0)
    jws = j_pack(jcg, dtype=np.float32, band_closure=0)
    ws = p_pack(cg, dtype=np.float32, band_closure=0)
    sources = {
        "surface": pt.closest_point(gr, 0.0, pt.R, system="polar"),
        "mid": pt.closest_point(gr, np.deg2rad(113.0), 4000.0,
                                system="polar"),
        "center": cg.cmap.center,
    }
    return jcg, jws, cg, ws, sources


@pytest.fixture(scope="module")
def surface_pallas(problem):
    """The JAX pallas-engine solve (interpret mode) of the surface
    source, shared by the tests that pin the port to it."""
    jcg, jws, _, _, sources = problem
    d, rounds = jsw.solve_circulant_sweep(jcg, sources["surface"], JCFG,
                                          engine="pallas", interpret=True,
                                          _packed=jws)
    return d[0], rounds


def test_matches_pallas_engine(problem, surface_pallas):
    _, _, cg, ws, sources = problem
    d_j, rounds_j = surface_pallas
    d, rounds = psw.solve_circulant_sweep(cg, sources["surface"], CFG,
                                          engine="pallas", device="cpu",
                                          _packed=ws)
    assert rounds == rounds_j
    np.testing.assert_allclose(d[0], d_j, atol=PALLAS_ATOL, rtol=0)


def test_converted_tables_match_pallas_engine(problem, surface_pallas):
    """The JAX package's own packed tables, carried over with
    convert.tables_from_numpy, drive the port's rounds to the same
    field."""
    jcg, jws, _, _, sources = problem
    d_j, rounds_j = surface_pallas
    jt, js = jsw.pack_sweep_tables(jws, jcg, np.float32)
    (jdn, jup), jr = jsw.pack_rsweep_tables(jws, jcg, np.float32)
    tbl, st, (wdn, wup), rst, cg = convert.tables_from_numpy(
        jt, js, jdn, jup, jr, jcg)
    src = sources["surface"]
    tol = torch.tensor(CFG.tol_value(), dtype=torch.float32)
    out = psw._solve_sweep(
        [cg.cmap.m_of[src]], [cg.cmap.c_of[src]], [False],
        psw.tables_to_device(tbl, "cpu"), torch.tensor(wdn),
        torch.tensor(wup), tol, st, rst, CFG.max_iters)
    assert out.it == rounds_j and not out.changed
    field = out.dist[0].numpy()                       # (nt, ML)
    m, c = cg.cmap.m_of, cg.cmap.c_of
    ok = m >= 0
    d = np.full(cg.n, np.inf, np.float32)
    d[ok] = field[c[ok], m[ok]]
    d[cg.cmap.center] = out.cen[0].item()
    np.testing.assert_allclose(d, d_j, atol=PALLAS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["surface", "mid", "center"])
def test_matches_jacobi(problem, name):
    jcg, _, cg, ws, sources = problem
    src = sources[name]
    d_ref, _ = solve_circulant(jcg, src, JCFG)
    d, rounds = psw.solve_circulant_sweep(cg, src, CFG, engine="pallas",
                                          device="cpu", _packed=ws)
    assert rounds < 10, f"{name}: {rounds} rounds"
    np.testing.assert_allclose(d[0], d_ref, atol=TOL, rtol=0, err_msg=name)


def test_batched_and_receivers(problem):
    """Chunked sources (the last chunk padded) and on-device receiver
    extraction give the single-source rows."""
    _, _, cg, ws, sources = problem
    srcs = [sources["surface"], sources["mid"], sources["center"]]
    full, _ = psw.solve_circulant_sweep(cg, srcs, CFG, batch=2,
                                        engine="pallas", device="cpu",
                                        _packed=ws)
    rec = np.asarray([0, 5, 17, cg.cmap.center, cg.n // 2])
    sub, _ = psw.solve_circulant_sweep(cg, srcs, CFG, batch=2,
                                       receivers=rec, engine="pallas",
                                       device="cpu", _packed=ws)
    for i, s in enumerate(srcs):
        one, _ = psw.solve_circulant_sweep(cg, s, CFG, engine="pallas",
                                           device="cpu", _packed=ws)
        np.testing.assert_allclose(full[i], one[0], atol=TOL, rtol=0)
        np.testing.assert_array_equal(sub[i], full[i][rec])


def test_device_out_returns_tensor(problem):
    _, _, cg, ws, sources = problem
    host, it_h = psw.solve_circulant_sweep(cg, sources["mid"], CFG,
                                           engine="pallas", device="cpu",
                                           _packed=ws)
    dev, it_d = psw.solve_circulant_sweep(cg, sources["mid"], CFG,
                                          engine="pallas", device="cpu",
                                          device_out=True, _packed=ws)
    assert isinstance(dev, torch.Tensor) and it_d == it_h
    np.testing.assert_array_equal(dev.numpy(), host)


def test_lane_blocked_rounds_match_jacobi(monkeypatch):
    """Force NTB < NTL so the lane-blocked sweep and the per-boundary
    seamfix run (the seam-blind block edges must be repaired)."""
    jgr, jcg, _ = rt.init_annulus_circulant(256, 6, 400.0)
    gr, cg, _ = pt.init_annulus_circulant(256, 6, 400.0)
    ws = p_pack(cg, dtype=np.float32, band_closure=0)
    monkeypatch.setattr(psw, "_RSWEEP_SINGLE_BYTES", 1)
    monkeypatch.setattr(psw, "_RSWEEP_WINDOW_BYTES", 1)
    _, rst = psw.pack_rsweep_tables(ws, cg, np.float32)
    assert rst.NTB == 128 and rst.NTL == 256
    src = pt.closest_point(gr, np.deg2rad(179.0), pt.R, system="polar")
    d_ref, _ = solve_circulant(jcg, src, JCFG)
    d, rounds = psw.solve_circulant_sweep(cg, src, CFG, engine="pallas",
                                          device="cpu", _packed=ws)
    assert rounds < 40
    np.testing.assert_allclose(d[0], d_ref, atol=TOL, rtol=0)


def test_cuda_device_needs_cuda(problem, monkeypatch):
    _, _, cg, ws, sources = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psw.solve_circulant_sweep(cg, sources["surface"], CFG,
                                  engine="pallas", _packed=ws)
