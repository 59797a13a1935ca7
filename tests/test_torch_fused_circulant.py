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
kernel reads the stencil as chunk tables (`relax_chunks`): their plain
evaluation equals the twin's relaxation bit for bit, and a NumPy replay
of the kernel's work partition takes every candidate exactly once.  The
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
         "24x12": (24, 12, 150.0), "48x12": (48, 12, 150.0),
         "180x63": (180, 63, 20.0)}


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


# csrc/fused.cu's relaxation: a block of WARPS warps takes an item
# (source, block of ROW_BLOCK theta rows, chunk; the chunk runs fastest);
# warp w, lane l of the chunk's slab, takes rows q0 + w + WARPS * i
WARPS = pfc.WARPS
ROW_BLOCK = pfc.ROW_BLOCK
# (grid, S): pad rows (21x6), the modular ring (24x12), the solve's width
# (180x63, S=1) and the table's (48x12, S=8)
RELAX_CASES = [("21x6", 2), ("24x12", 2), ("180x63", 1), ("48x12", 8)]


def _relax_case(grid, S):
    _, cg, _ = _grids(grid)
    ts = ppc.pack_tiled_stencil(cg)
    nt = ts.ntheta
    ntp = -(-nt // 8) * 8
    return ts, pfc.FusedStatic(ts.T, nt, ntp, S)


def _signature(count, total, t, s, c, lane, u, idx, w):
    """Add each candidate (dst tile t, source s, row c, lane; from rolled
    tile u, source lane idx, weight w) to a count and to a sum that
    tells the candidates apart."""
    np.add.at(count, (t, s, c, lane), 1)
    np.add.at(total, (t, s, c, lane),
              w.astype(np.float64) * (1.0 + idx + 128.0 * u))


@pytest.mark.parametrize("grid,S", RELAX_CASES)
def test_relax_items_cover_every_candidate_once(grid, S):
    """The kernel's work partition replayed in NumPy: every (tile,
    stencil row, lane, theta row) candidate with a finite weight is taken
    by exactly one (item, warp, lane, row), each item reads only its
    source window, and a (tile, slab, source tile)'s chunks differ in
    size by at most one row."""
    ts, st = _relax_case(grid, S)
    T, nt, ntp, _ = st
    ck = pfc.relax_chunks(ts)
    shape = (T, S, ntp, 128)
    want_n, want_sum = np.zeros(shape, np.int64), np.zeros(shape)
    got_n, got_sum = np.zeros(shape, np.int64), np.zeros(shape)

    for t in range(T):
        for k in range(ts.offs[t], ts.offs[t + 1]):
            lanes = np.flatnonzero(np.isfinite(ts.w[k]))
            u = int(ts.u_of[k])
            rows = np.arange(ntp if u // T == 2 else nt)
            s_, c_, l_ = np.meshgrid(np.arange(S), rows, lanes, indexing="ij")
            _signature(want_n, want_sum, t, s_, c_, l_, u,
                       ts.idx[k, l_], ts.w[k, l_])

    sizes = {}
    n_rows = ck.info[:, 1] & 0xFFFF
    for (tg, nz), n, row in zip(ck.info, n_rows, ck.row):
        sizes.setdefault(int(tg), []).append(int(n))
        assert (row[:n] & 0xFFFF == tg >> 16).all()  # one source tile
        dc0 = row[:n] >> 16 == 2                      # dc = 0 rows first
        assert dc0.sum() == nz >> 16 and dc0[:nz >> 16].all()
    assert all(max(v) - min(v) <= 1 and max(v) <= pfc.CHUNK
               for v in sizes.values())
    assert (ck.w[np.arange(pfc.CHUNK)[None, :] >= n_rows[:, None]]
            == np.inf).all()

    nrb = -(-ntp // ROW_BLOCK)
    nth = ntp + 4
    rows_per_thread = ROW_BLOCK // WARPS
    for item in range(len(ck.info) * S * nrb):
        rest, ch = divmod(item, len(ck.info))
        s, rb = divmod(rest, nrb)
        tg, n = int(ck.info[ch, 0]), int(n_rows[ch])
        t, g = divmod(tg & 0xFFFF, 128 // pfc.SLAB)
        q0 = rb * ROW_BLOCK
        c = q0 + np.arange(WARPS)[:, None] + WARPS * np.arange(
            rows_per_thread)[None, :]                    # (warp, i)
        for k in range(n):
            u = int(ck.row[ch, k] >> 16) * T + int(ck.row[ch, k] & 0xFFFF)
            dc = u // T - 2
            live = np.flatnonzero(np.isfinite(ck.w[ch, k]))
            # pad rows: the chunk's first z rows (those of dc = 0)
            take = (c < nt) | ((c < ntp) & (k < ck.info[ch, 1] >> 16))
            q = np.where(c < nt, c + 2 + dc, c + 4)[take]
            assert ((q >= q0) & (q < min(q0 + ROW_BLOCK + 4, nth))).all()
            cc = c[take]
            s_, c_, l_ = np.meshgrid([s], cc, live, indexing="ij")
            _signature(got_n, got_sum, t, s_, c_, g * pfc.SLAB + l_, u,
                       ck.idx[ch, k][l_], ck.w[ch, k][l_])
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got_sum, want_sum)
    assert want_n.sum() > 0


@pytest.mark.parametrize("grid,S", RELAX_CASES)
def test_relax_chunks_reference_equals_the_reference_relaxation(grid, S):
    """The chunk tables, evaluated as the kernel reads them (haloed
    source rows, pad rows from dc = 0 only), relax a state with +inf
    cells and finite pad rows to fused_reference's relaxation, bit for
    bit."""
    ts, st = _relax_case(grid, S)
    T, nt, ntp, _ = st
    tbl = pfc.device_fused_tables(ts, "cpu")
    rng = np.random.default_rng(S + nt)
    x = rng.uniform(0.0, 1500.0, (T, S * ntp, 128)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.inf
    x = torch.from_numpy(x)
    got = pfc.relax_chunks_reference(x, tbl, st)
    want = pfc._relax_reference(x, tbl, st)
    assert torch.equal(got, want)
    assert int(torch.isfinite(want).sum()) > int(torch.isfinite(x).sum())


def test_relax_chunks_refuses_more_tiles_than_the_format_packs():
    """The chunk info packs t * 4 + slab in 16 bits: a stencil of more
    tiles than that holds is refused, not packed wrong."""
    import dataclasses

    ts, _ = _relax_case("24x12", 1)
    with pytest.raises(ValueError, match="tiles"):
        pfc.relax_chunks(dataclasses.replace(ts, T=0xFFFF // 4 + 1))
