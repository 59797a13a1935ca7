"""PyTorch port: the diagonal-band 'diag' Jacobi engine on the CPU against
the JAX package.

`diag_sweep_reference` (one relaxation sweep, the CUDA kernel
`csrc/diag.cu`'s twin) must equal the Pallas kernel `_sweep_diag` in
interpret mode bit for bit: every candidate is one f32 add and min does
not depend on order.  The cases include ntheta 127 at nr 3, whose
128-lane cover has one padding lane (the grids `auto` sends to 'diag').
The kernel reads the field itself, through per-row lists of the finite
taps, instead of the TPU's 40-copy source stack;
`test_diag_taps_replay_the_sweep` holds those lists, replayed in NumPy,
to the same bits.

The ring and chain scans are plain torch ops in the JAX package's order
of operations; they equal the JAX functions run op by op bit for bit.
The solves are held to the JAX package's compiled solve at the stated
2e-3 s (two units of the f32 termination slack) with the same iteration
counts.  One case is held to JAX's diag loop run op by op instead:
with `scan_every=2` the compiled JAX solve (XLA on the CPU) evaluates the
ring scan's `b - j*c` as one fused multiply-add inside its conditional,
rounds differently from the written op order, and ends up to 3.2e-3 s
from the port and up to 3.7e-3 s below the exact fixpoint on the 47x3
grid, where the port (and JAX op by op) stays within 1.4e-3 s of it.
Mirrors tests/test_diag_kernel.py.  The CUDA kernel runs only on the
card; chip_smoke.py holds it to the twin there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops import diag_circulant as jdc
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.convert import diag_from_numpy
from raytracer_tpu_torch.ops import diag_circulant as pdc
from raytracer_tpu_torch.ops.circulant import solve_circulant
from jax_mappings import below_the_map_limit  # noqa: F401,E402

TOL = 2e-3
JF32, PF32 = JConfig(dtype="float32"), PConfig(dtype="float32")


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


def _grids(ntheta, nr=3, spacing=500.0):
    gr, cg, _ = pt.init_annulus_circulant(ntheta, nr, spacing)
    _, jcg, _ = rt.init_annulus_circulant(ntheta, nr, spacing)
    return gr, cg, jcg


def _src(gr, deg):
    return pt.closest_point(gr, np.deg2rad(deg), pt.R, system="polar")


def _same(got, want):
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=TOL)


def _static(ds):
    return pdc.DiagStatic(ds.D, ds.Mp, ds.NTL, ds.pad, ds.ntheta)


def _field(rng, ds):
    """Random travel times with ~40 % +inf cells; the padding lanes are
    random too (the sweep must ignore them and return +inf there)."""
    d = rng.uniform(0.0, 800.0, (ds.Mp, ds.NTL)).astype(np.float32)
    d[rng.random(d.shape) < 0.4] = np.inf
    return d


@pytest.mark.parametrize("ntheta,nr", [(16, 4), (47, 3), (127, 3)])
def test_diag_sweep_reference_matches_pallas(ntheta, nr):
    _, jcg, _ = rt.init_annulus_circulant(ntheta, nr, 400.0)
    ds = diag_from_numpy(jdc.pack_diag_stencil(jcg, dtype=np.float32))
    dist = _field(np.random.default_rng(ntheta), ds)
    st = _static(ds)
    want = np.asarray(jdc._sweep_diag(jnp.asarray(dist), tuple(st),
                                      jnp.asarray(ds.offs),
                                      jnp.asarray(ds.wp), True))
    tbl = pdc.device_diag_tables(ds, "cpu")
    got = pdc.diag_sweep_reference(st, torch.from_numpy(dist), tbl).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, ds.ntheta:]).all()
    assert np.isfinite(got).sum() > np.isfinite(dist[:, :ds.ntheta]).sum()


@pytest.mark.parametrize("ntheta", [9, 127])
def test_diag_taps_replay_the_sweep(ntheta):
    """The CUDA kernel's taps - dist[m + dm, (c + dc) mod nt] + w over each
    row's list of finite taps (`tap_ptr`, `tap_dmdc`, `tap_w`, source
    rows in [0, Mp)), +inf padding lanes - replayed in NumPy, give the
    twin's bits."""
    _, cg, _ = _grids(ntheta, 3, 400.0)
    ds = pdc.pack_diag_stencil(cg)
    tbl = pdc.device_diag_tables(ds, "cpu")
    dist = _field(np.random.default_rng(7), ds)
    nt = ds.ntheta
    want = pdc.diag_sweep_reference(_static(ds), torch.from_numpy(dist),
                                    tbl).numpy()
    ptr, code, w = (t.numpy() for t in (tbl.tap_ptr, tbl.tap_dmdc,
                                         tbl.tap_w))
    out = np.full_like(dist, np.inf)
    out[:, :nt] = dist[:, :nt]
    cols = np.arange(nt)
    for m in range(ds.Mp):
        for e in range(ptr[m], ptr[m + 1]):
            dm, dc = code[e] >> 16, ((code[e] & 0xFFFF) ^ 0x8000) - 0x8000
            assert 0 <= m + dm < ds.Mp and np.isfinite(w[e])
            cand = dist[m + dm, (cols + dc) % nt] + w[e]
            out[m, :nt] = np.minimum(out[m, :nt], cand)
    np.testing.assert_array_equal(out, want)


def test_ring_and_chain_scans_equal_jax_op_by_op():
    _, cg, jcg = _grids(127, 3, 400.0)
    ds = pdc.pack_diag_stencil(cg)
    dist = _field(np.random.default_rng(11), ds)
    dist[:, ds.ntheta:] = np.inf
    want = np.asarray(jdc._ring_scan(jnp.asarray(dist),
                                     jnp.asarray(ds.ring_f),
                                     jnp.asarray(ds.ring_b), ds.ntheta))
    got = pdc._ring_scan(torch.from_numpy(dist), torch.from_numpy(ds.ring_f),
                         torch.from_numpy(ds.ring_b), ds.ntheta).numpy()
    np.testing.assert_array_equal(got, want)
    for fld in (dist, want):  # odd and even row counts in the recursion
        for rows in (ds.Mp, ds.Mp - 3):
            x = fld[:rows]
            jw = np.asarray(jdc._chain_scan(jnp.asarray(x),
                                            jnp.asarray(ds.chain_f[:rows]),
                                            jnp.asarray(ds.chain_b[:rows])))
            pg = pdc._chain_scan(torch.from_numpy(x),
                                 torch.from_numpy(ds.chain_f[:rows]),
                                 torch.from_numpy(ds.chain_b[:rows])).numpy()
            np.testing.assert_array_equal(pg, jw)


@pytest.mark.parametrize("scan_every", [0, 1])
def test_diag_solve_matches_jax(scan_every):
    gr, cg, jcg = _grids(47)
    src = _src(gr, 33.0)
    want, it_j = jdc.solve_circulant_diag(jcg, [src], JF32,
                                          scan_every=scan_every,
                                          interpret=True)
    got, it_p = pdc.solve_circulant_diag(cg, [src], PF32,
                                         scan_every=scan_every, device="cpu")
    _same(got[0], want[0])
    assert it_p == it_j > 0


def _jax_diag_op_by_op(jcg, src, scan_every):
    """The body of the JAX package's `_solve_diag_jit`, run op by op on
    its own functions (each jnp op rounds as written)."""
    ds = jdc.pack_diag_stencil(jcg, dtype=np.float32)
    nt, Mp, NTL = ds.ntheta, ds.Mp, ds.NTL
    meta = (ds.D, Mp, NTL, ds.pad, nt)
    a = {k: jnp.asarray(getattr(ds, k)) for k in (
        "offs", "wp", "ring_f", "ring_b", "chain_f", "chain_b", "fan_w")}
    lane_mask = np.zeros((1, NTL), np.float32)
    lane_mask[0, nt:] = np.inf
    lane_mask = jnp.asarray(lane_mask)
    tol = jnp.asarray(JF32.tol_value(), jnp.float32)
    cm = jcg.cmap
    d0 = np.full((Mp, NTL), np.inf, np.float32)
    d0[cm.m_of[src], cm.c_of[src]] = 0.0
    dist, dcen = jnp.asarray(d0), jnp.asarray(np.float32(np.inf))
    it, changed = 0, True
    while changed and it < JF32.max_iters:
        d = dist
        if scan_every == 1 or (scan_every > 1 and it % scan_every == 0):
            d = jdc._chain_scan(jdc._ring_scan(d, a["ring_f"], a["ring_b"],
                                               nt), a["chain_f"], a["chain_b"])
        d = jdc._sweep_diag(d, meta, a["offs"], a["wp"], True)
        c = jnp.minimum(dcen, (d + a["fan_w"]).min())
        d = jnp.minimum(d, c + a["fan_w"] + lane_mask)
        changed = bool(jnp.any(d < dist - tol) | (c < dcen - tol))
        dist, dcen, it = d, c, it + 1
    out = np.asarray(dist)
    valid = cm.m_of >= 0
    res = np.full(jcg.n, np.inf, np.float32)
    res[valid] = out[cm.m_of[valid], cm.c_of[valid]]
    res[cm.center] = float(dcen)
    return res, it


def test_diag_solve_every_second_scan_matches_jax_op_by_op():
    gr, cg, jcg = _grids(47)
    src = _src(gr, 33.0)
    want, it_j = _jax_diag_op_by_op(jcg, src, 2)
    got, it_p = pdc.solve_circulant_diag(cg, [src], PF32, scan_every=2,
                                         device="cpu")
    np.testing.assert_array_equal(got[0], want)
    assert it_p == it_j > 0
    exact, _ = solve_circulant(cg, src, PConfig(dtype="float64", tol=1e-12,
                                                max_iters=5000), device="cpu")
    _same(got[0], exact)


def test_diag_centre_and_sequential_sources_match_jax():
    gr, cg, jcg = _grids(16, 4, 400.0)
    srcs = [cg.cmap.center, _src(gr, 0.0), _src(gr, 200.0)]
    want, it_j = jdc.solve_circulant_diag(jcg, srcs, JF32, interpret=True)
    got, it_p = pdc.solve_circulant_diag(cg, srcs, PF32, device="cpu")
    assert got.shape == want.shape == (3, gr.nnods)
    for i in range(3):
        _same(got[i], want[i])
    assert it_p == it_j


def test_diag_at_ntheta_127_matches_jax():
    """The dup-1 grid that 'auto' sends to diag, held to the JAX
    package's interpret-mode solve."""
    gr, cg, jcg = _grids(127)
    src = _src(gr, 91.0)
    want, it_j = jdc.solve_circulant_diag(jcg, [src], JF32, interpret=True)
    got, it_p = pdc.solve_circulant_diag(cg, [src], PF32, device="cpu")
    _same(got[0], want[0])
    assert it_p == it_j


def test_jax_packed_stencil_gives_the_same_solve():
    gr, cg, jcg = _grids(47)
    src = _src(gr, 100.0)
    jds = jdc.pack_diag_stencil(jcg, dtype=np.float32)
    got, it = pdc.solve_circulant_diag(cg, [src], PF32, device="cpu",
                                       _packed=diag_from_numpy(jds))
    own, it_own = pdc.solve_circulant_diag(cg, [src], PF32, device="cpu")
    np.testing.assert_array_equal(got, own)
    assert it == it_own


def test_diag_sweep_takes_the_twin_on_cpu_and_counts_no_launch():
    _, cg, _ = _grids(47)
    ds = pdc.pack_diag_stencil(cg)
    tbl = pdc.device_diag_tables(ds, "cpu")
    dist = torch.from_numpy(_field(np.random.default_rng(5), ds))
    n = pdc.diag_sweep.launches
    got = pdc.diag_sweep(_static(ds), dist, tbl)
    assert torch.equal(got, pdc.diag_sweep_reference(_static(ds), dist, tbl))
    assert pdc.diag_sweep.launches == n


def test_diag_sweep_refuses_bad_arguments():
    _, cg, _ = _grids(16, 4, 400.0)
    ds = pdc.pack_diag_stencil(cg)
    st = _static(ds)
    tbl = pdc.device_diag_tables(ds, "cpu")
    with pytest.raises(ValueError, match="dist must be"):
        pdc.diag_sweep(st, torch.zeros((ds.Mp, ds.NTL + 1)), tbl)
    with pytest.raises(ValueError, match="tap_ptr must be"):
        pdc.diag_sweep(st, torch.zeros((ds.Mp, ds.NTL)),
                       tbl._replace(tap_ptr=tbl.tap_ptr[:8]))
    mtbl = pdc.DiagTables(*(torch.zeros(t.shape, dtype=t.dtype,
                                        device="meta") for t in tbl))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pdc.diag_sweep(st, torch.zeros((ds.Mp, ds.NTL), device="meta"), mtbl)
