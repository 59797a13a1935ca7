"""PyTorch port: the whole-solve 'fused' engine on the CPU against the JAX
package.

`_chain_jump_tables` is a NumPy copy (float64 on the host) and must give
the JAX package's tables bit for bit.  `fused_reference`, the plain twin
of the cooperative CUDA kernel `csrc/fused.cu`, runs the Pallas kernel's
while loop in torch ops in the kernel's order of operations: every add
is one add, the ring scan's one multiply is by a power of two (exact),
and min does not depend on order.  So its final state - pad rows
included - and centre equal the Pallas kernel's in interpret mode bit for
bit, with the loop run to its end and cut at `max_iters`, and the solve
equals the JAX package's and returns -1 iterations as it does.  The CUDA
kernel runs only on the card; chip_smoke.py holds it to the twin there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.contrib import fused_circulant as jfc
from raytracer_tpu.contrib import pallas_circulant as jpc
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.contrib import fused_circulant as pfc
from raytracer_tpu_torch.contrib import pallas_circulant as ppc

JF32, PF32 = JConfig(dtype="float32"), PConfig(dtype="float32")
# 21x6 has theta pad rows (ntheta 21 -> 24 rows) and a second slot tile
GRIDS = {"16x4": (16, 4, 400.0), "21x6": (21, 6, 300.0),
         "24x12": (24, 12, 150.0), "180x63": (180, 63, 20.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the plain versions
    run thousands of small ops, and while the suite's workers share the
    cores, torch's thread pool stalls at each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(name):
    ntheta, nr, spacing = GRIDS[name]
    gr, cg, _ = pt.init_annulus_circulant(ntheta, nr, spacing)
    _, jcg, _ = rt.init_annulus_circulant(ntheta, nr, spacing)
    return gr, cg, jcg


def _src(gr, deg):
    return pt.closest_point(gr, np.deg2rad(deg), pt.R, system="polar")


def _setup(cg, srcs):
    ts = ppc.pack_tiled_stencil(cg)
    T, nt = ts.T, ts.ntheta
    ntp = -(-nt // 8) * 8
    S = len(srcs)
    d0, c0 = ppc.initial_state(cg, srcs, T, ntp, np.float32)
    return (ts, pfc.FusedStatic(T, nt, ntp, S),
            d0.reshape(T, S * ntp, 128), c0)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_chain_jump_tables_equal_jax(grid):
    _, cg, _ = _grids(grid)
    ts = ppc.pack_tiled_stencil(cg)
    got = pfc._chain_jump_tables(ts.chain_w.astype(np.float64), ts.T)
    want = jfc._chain_jump_tables(ts.chain_w.astype(np.float64), ts.T)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (pfc.CHAIN_STEPS, ts.T * 128)
        np.testing.assert_array_equal(a, b)
    assert (pfc.RING_STEPS, pfc.CHAIN_STEPS) == (jfc.RING_STEPS,
                                                 jfc.CHAIN_STEPS)


def _jax_fused_state(ts, st, d0, c0, max_iters):
    """The Pallas kernel's final (state, centre per source), interpret
    mode, on the same initial state."""
    T, nt, ntp, S = st
    pdn, pup = jfc._chain_jump_tables(ts.chain_w.astype(np.float64), T)
    cen0 = np.repeat(c0, ntp)[None, :, None]
    out_state, out_cen = jfc._fused_jit(
        jnp.asarray(ts.offs), jnp.asarray(ts.u_of), jnp.asarray(d0),
        jnp.asarray(cen0), jnp.asarray(ts.idx), jnp.asarray(ts.w),
        jnp.asarray(ts.ring_w),
        jnp.asarray(pdn.reshape(pfc.CHAIN_STEPS, T, 128).astype(np.float32)),
        jnp.asarray(pup.reshape(pfc.CHAIN_STEPS, T, 128).astype(np.float32)),
        jnp.asarray(ts.fan_w), T, nt, ntp, S, max_iters, "float32", True)
    return np.asarray(out_state), np.asarray(out_cen)[0, ::ntp, 0]


@pytest.mark.parametrize("grid,max_iters", [("24x12", 3), ("24x12", 100_000),
                                            ("21x6", 100_000)])
def test_fused_reference_state_equals_pallas_interpret(grid, max_iters):
    """The whole state, pad rows included, and the centre, after the loop
    ran to its end or was cut at max_iters."""
    gr, cg, _ = _grids(grid)
    ts, st, d0, c0 = _setup(cg, [_src(gr, 0.0), cg.cmap.center])
    want_x, want_c = _jax_fused_state(ts, st, d0, c0, max_iters)
    tbl = pfc.device_fused_tables(ts, "cpu")
    x, c, it = pfc.fused_reference(torch.from_numpy(d0), torch.from_numpy(c0),
                                   tbl, st, max_iters)
    np.testing.assert_array_equal(x.numpy(), want_x)
    np.testing.assert_array_equal(c.numpy(), want_c)
    if max_iters == 3:
        assert it == 3
    else:
        assert 3 < it < max_iters
    if st.ntp > st.nt:
        pad_rows = x.numpy().reshape(st.T, st.S, st.ntp, 128)[:, :, st.nt:]
        assert np.isfinite(pad_rows).any()  # the fan writes them


@pytest.mark.parametrize("grid,degs", [("16x4", (0.0,)),
                                       ("21x6", (0.0, 150.0)),
                                       ("24x12", (0.0, 97.0))])
def test_fused_solve_matches_jax(grid, degs):
    gr, cg, jcg = _grids(grid)
    srcs = [_src(gr, d) for d in degs]
    want, it_j = jfc.solve_circulant_fused(jcg, srcs, JF32, interpret=True)
    got, it_p = pfc.solve_circulant_fused(cg, srcs, PF32, device="cpu")
    assert got.shape == want.shape == (len(srcs), gr.nnods)
    np.testing.assert_array_equal(got, want)
    assert it_p == it_j == -1


def test_fused_solve_with_the_centre_source_matches_jax():
    gr, cg, jcg = _grids("16x4")
    srcs = [cg.cmap.center, _src(gr, 200.0)]
    want, _ = jfc.solve_circulant_fused(jcg, srcs, JF32, interpret=True)
    got, it = pfc.solve_circulant_fused(cg, srcs, PF32, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[0, cg.cmap.center] == 0.0 and it == -1


def test_fused_and_pallas_reach_the_same_fixpoint_within_tol():
    """Both engines relax only real graph edges; 'fused' runs until no
    value falls, 'pallas' until none falls by more than tol (1e-3 s), and
    the pallas ring scan's closed form rounds (ROADMAP C.7): the fields
    agree to a few tol units."""
    gr, cg, _ = _grids("24x12")
    srcs = [_src(gr, 0.0), _src(gr, 150.0)]
    f, _ = pfc.solve_circulant_fused(cg, srcs, PF32, device="cpu")
    p, _ = ppc.solve_circulant_pallas(cg, srcs, PF32, device="cpu")
    assert np.isfinite(f).all()
    np.testing.assert_allclose(f, p, rtol=0, atol=5e-3)


def _fused_args():
    gr, cg, _ = _grids("16x4")
    ts, st, d0, c0 = _setup(cg, [_src(gr, 0.0), _src(gr, 90.0)])
    return (torch.from_numpy(d0), torch.from_numpy(c0),
            pfc.device_fused_tables(ts, "cpu"), st)


def test_fused_takes_the_twin_on_cpu_and_counts_no_launch():
    x, c, tbl, st = _fused_args()
    n = pfc.fused.launches
    got = pfc.fused(x, c, tbl, st, 100_000)
    want = pfc.fused_reference(x, c, tbl, st, 100_000)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2] > 0
    assert pfc.fused.launches == n
    assert torch.isinf(x).sum() == x.numel() - 2  # the input untouched


def test_fused_refuses_bad_arguments():
    x, c, tbl, st = _fused_args()
    with pytest.raises(ValueError, match="state must be"):
        pfc.fused(x[:, :-1], c, tbl, st, 10)
    with pytest.raises(ValueError, match="cen must be"):
        pfc.fused(x, c[:1], tbl, st, 10)
    with pytest.raises(ValueError, match="pdn must be"):
        pfc.fused(x, c, tbl._replace(pdn=tbl.pdn[:3]), st, 10)
    with pytest.raises(ValueError, match="ntp % 8"):
        pfc.fused(x, c, tbl, st._replace(ntp=st.ntp + 1), 10)
    with pytest.raises(TypeError, match="float64"):
        pfc.fused(x, c.double(), tbl, st, 10)
    mtbl = pfc.FusedTables(*(torch.zeros(t.shape, dtype=t.dtype,
                                         device="meta") for t in tbl))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pfc.fused(x.to("meta"), c.to("meta"), mtbl, st, 10)
