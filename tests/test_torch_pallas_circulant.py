"""PyTorch port: the lane-gather 'pallas' engine on the CPU against the JAX
package.

`pack_tiled_stencil` is a NumPy copy and must give the JAX package's
tables bit for bit.  `relax_reference` (one relaxation sweep, the CUDA
kernel `csrc/relax.cu`'s twin) must equal the Pallas kernel
`_relax_pallas` in interpret mode bit for bit: every candidate is one add
and min does not depend on order.  The kernel rolls theta in its index
arithmetic instead of reading 5 rolled copies;
`test_relax_index_arithmetic_replays_the_sweep` holds that indexing,
replayed in NumPy, to the same bits.  The ring and slot scans are plain
torch ops in the JAX package's order of operations and equal the JAX
functions bit for bit; the slot scan's in-tile costs follow the rounding
of `jnp.cumsum` on the CPU (`_lane_cumsum`).

The solves equal the JAX package's compiled solve bit for bit, with the
same iteration count.  With `ring_every=2` the compiled JAX solve (XLA on
the CPU) evaluates the ring scan's `body - j*c` as one fused multiply-add
inside its conditional and rounds differently from the written op order
(up to 3.7e-3 s at 24x12, as ROADMAP C.7 found for 'diag'), so that case
is held bit for bit to JAX's loop run op by op.  The CUDA kernel runs
only on the card; chip_smoke.py holds it to the twin there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.contrib import pallas_circulant as jpc
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.contrib import pallas_circulant as ppc
from raytracer_tpu_torch.convert import tiled_from_numpy
from jax_mappings import below_the_map_limit  # noqa: F401,E402

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


def _shape(ts):
    nt = ts.ntheta
    return ts.T, nt, -(-nt // 8) * 8


def _field(rng, ts, S):
    """Random travel times with ~30 % +inf cells; the pad rows are finite
    too (the fan writes finite values there, the sweep must reset them)."""
    T, nt, ntp = _shape(ts)
    d = rng.uniform(0.0, 800.0, (T, S, ntp, 128)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = np.inf
    d[:, :, nt:] = rng.uniform(0.0, 800.0, d[:, :, nt:].shape)
    return d


_STENCIL_FIELDS = ("idx", "w", "offs", "u_of", "ring_w", "chain_w", "fan_w")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_pack_tiled_stencil_equals_jax(grid):
    _, cg, jcg = _grids(grid)
    got, want = ppc.pack_tiled_stencil(cg), jpc.pack_tiled_stencil(jcg)
    for f in _STENCIL_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.groups == want.groups
    assert (got.T, got.M, got.ntheta) == (want.T, want.M, want.ntheta)
    if grid == "180x63":
        assert (got.M, got.T, got.idx.shape[0]) == (834, 7, 2785)
        assert all(10 <= len(g) <= 15 for g in got.groups)


def test_tiled_from_numpy_round_trips_the_jax_stencil():
    _, _, jcg = _grids("24x12")
    jts = jpc.pack_tiled_stencil(jcg)
    ts = tiled_from_numpy(jts)
    assert isinstance(ts, ppc.TiledStencil)
    for f in _STENCIL_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f), getattr(jts, f))
        assert getattr(ts, f).dtype == getattr(jts, f).dtype
    assert ts.groups == jts.groups and isinstance(ts.groups, tuple)
    assert (ts.T, ts.M, ts.ntheta) == (jts.T, jts.M, jts.ntheta)


@pytest.mark.parametrize("grid,S", [("16x4", 1), ("21x6", 2), ("24x12", 2)])
def test_relax_reference_matches_pallas_interpret(grid, S):
    _, cg, jcg = _grids(grid)
    ts = ppc.pack_tiled_stencil(cg)
    T, nt, ntp = _shape(ts)
    dist = _field(np.random.default_rng(S), ts, S)
    want = np.asarray(jpc._relax_pallas(
        jnp.asarray(dist), jnp.asarray(ts.offs), jnp.asarray(ts.u_of), T, nt,
        jnp.asarray(ts.idx), jnp.asarray(ts.w), S, ntp, interpret=True))
    tbl = ppc.device_pallas_tables(ts, "cpu")
    got = ppc.relax_reference(torch.from_numpy(dist), tbl.offs, tbl.u_of,
                              tbl.idx, tbl.w, T, nt, S, ntp).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, :, nt:]).all()
    assert (np.isfinite(got).sum()
            > np.isfinite(dist[:, :, :nt]).sum())


def test_relax_index_arithmetic_replays_the_sweep():
    """The CUDA kernel's indexing - dist[u % T, s, (c + dc) mod nt,
    idx[k, l]] + w[k, l] for k in offs[t]..offs[t+1], dc = u // T - 2,
    +inf weights skipped, pad rows +inf - replayed in NumPy, gives the
    twin's bits."""
    _, cg, _ = _grids("21x6")
    ts = ppc.pack_tiled_stencil(cg)
    T, nt, ntp = _shape(ts)
    S = 2
    dist = _field(np.random.default_rng(3), ts, S)
    tbl = ppc.device_pallas_tables(ts, "cpu")
    want = ppc.relax_reference(torch.from_numpy(dist), tbl.offs, tbl.u_of,
                               tbl.idx, tbl.w, T, nt, S, ntp).numpy()
    out = np.full_like(dist, np.inf)
    out[:, :, :nt] = dist[:, :, :nt]
    cols = np.arange(nt)
    lanes = np.arange(128)
    for t in range(T):
        for k in range(ts.offs[t], ts.offs[t + 1]):
            u = int(ts.u_of[k])
            dc, src_t = u // T - 2, u % T
            fin = np.isfinite(ts.w[k])
            g = dist[src_t][:, (cols + dc) % nt][:, :, ts.idx[k]]
            cand = g + ts.w[k]
            out[t, :, :nt, lanes[fin]] = np.minimum(
                out[t, :, :nt, lanes[fin]], cand[:, :, fin].transpose(2, 0, 1))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("grid", ["16x4", "21x6", "24x12"])
def test_ring_and_slot_scans_equal_jax(grid):
    _, cg, _ = _grids(grid)
    ts = ppc.pack_tiled_stencil(cg)
    T, nt, ntp = _shape(ts)
    dist = _field(np.random.default_rng(11), ts, 2)
    want = np.asarray(jpc._ring_scan(jnp.asarray(dist),
                                     jnp.asarray(ts.ring_w), nt))
    got = ppc._ring_scan(torch.from_numpy(dist), torch.from_numpy(ts.ring_w),
                         nt).numpy()
    np.testing.assert_array_equal(got, want)
    sc = ppc.slot_scan_tables(ts.chain_w, "cpu")
    for x in (dist, want):
        jw = np.asarray(jpc._slot_scan(jnp.asarray(x),
                                       jnp.asarray(ts.chain_w)))
        np.testing.assert_array_equal(
            ppc._slot_scan(torch.from_numpy(x.copy()), sc).numpy(), jw)


def test_lane_cumsum_rounds_as_jnp_cumsum():
    rng = np.random.default_rng(5)
    x = rng.uniform(0.0, 50.0, (7, 128)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.inf
    np.testing.assert_array_equal(ppc._lane_cumsum(x),
                                  np.asarray(jnp.cumsum(jnp.asarray(x),
                                                        axis=1)))


@pytest.mark.parametrize("grid,degs", [("16x4", (0.0,)),
                                       ("21x6", (0.0, 150.0)),
                                       ("24x12", (0.0, 97.0))])
def test_pallas_solve_matches_jax(grid, degs):
    gr, cg, jcg = _grids(grid)
    srcs = [_src(gr, d) for d in degs]
    want, it_j = jpc.solve_circulant_pallas(jcg, srcs, JF32, interpret=True)
    got, it_p = ppc.solve_circulant_pallas(cg, srcs, PF32, device="cpu")
    assert got.shape == want.shape == (len(srcs), gr.nnods)
    np.testing.assert_array_equal(got, want)
    assert it_p == it_j > 0


def test_pallas_solve_with_the_centre_source_matches_jax():
    gr, cg, jcg = _grids("16x4")
    srcs = [cg.cmap.center, _src(gr, 200.0)]
    want, it_j = jpc.solve_circulant_pallas(jcg, srcs, JF32, interpret=True)
    got, it_p = ppc.solve_circulant_pallas(cg, srcs, PF32, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got[0, cg.cmap.center] == 0.0
    assert it_p == it_j


def _jax_pallas_op_by_op(jcg, srcs, ring_every):
    """The body of the JAX package's `_solve_pallas_jit`, run op by op on
    its own functions (each jnp op rounds as written)."""
    ts = jpc.pack_tiled_stencil(jcg, dtype=np.float32)
    T, nt, ntp = _shape(ts)
    S = len(srcs)
    a = {k: jnp.asarray(getattr(ts, k)) for k in _STENCIL_FIELDS}
    d0, c0 = ppc.initial_state(jcg, srcs, T, ntp, np.float32)
    dist, dcen = jnp.asarray(d0), jnp.asarray(c0)
    tol = jnp.asarray(JF32.tol_value(), jnp.float32)
    fan = a["fan_w"][:, None, None, :]
    it, changed = 0, True
    while changed and it < JF32.max_iters:
        d = dist
        if ring_every == 1 or (ring_every > 1 and it % ring_every == 0):
            d = jpc._slot_scan(jpc._ring_scan(d, a["ring_w"], nt),
                               a["chain_w"])
        d = jpc._relax_pallas(d, a["offs"], a["u_of"], T, nt, a["idx"],
                              a["w"], S, ntp, True)
        c = jnp.minimum(dcen, (d + fan).min(axis=(0, 2, 3)))
        d = jnp.minimum(d, dcen[None, :, None, None] + fan)
        changed = bool(jnp.any(d < dist - tol) | jnp.any(c < dcen - tol))
        dist, dcen, it = d, c, it + 1
    return ppc.extract(jcg, np.asarray(dist), np.asarray(dcen)), it


def test_pallas_ring_every_2_matches_jax_op_by_op():
    gr, cg, jcg = _grids("24x12")
    srcs = [_src(gr, 33.0), cg.cmap.center]
    want, it_j = _jax_pallas_op_by_op(jcg, srcs, 2)
    got, it_p = ppc.solve_circulant_pallas(cg, srcs, PF32, ring_every=2,
                                           device="cpu")
    np.testing.assert_array_equal(got, want)
    assert it_p == it_j > 0
    # no scans at all: the compiled JAX solve rounds as written
    want0, it0 = jpc.solve_circulant_pallas(jcg, srcs[:1], JF32,
                                            ring_every=0, interpret=True)
    got0, it0_p = ppc.solve_circulant_pallas(cg, srcs[:1], PF32,
                                             ring_every=0, device="cpu")
    np.testing.assert_array_equal(got0, want0)
    assert it0_p == it0 > it_j


def test_jax_packed_stencil_gives_the_same_solve():
    gr, cg, jcg = _grids("24x12")
    src = _src(gr, 100.0)
    jts = jpc.pack_tiled_stencil(jcg, dtype=np.float32)
    got, it = ppc.solve_circulant_pallas(cg, [src], PF32, device="cpu",
                                         _packed=tiled_from_numpy(jts))
    own, it_own = ppc.solve_circulant_pallas(cg, [src], PF32, device="cpu")
    np.testing.assert_array_equal(got, own)
    assert it == it_own


def _relax_args(grid="16x4", S=1):
    _, cg, _ = _grids(grid)
    ts = ppc.pack_tiled_stencil(cg)
    T, nt, ntp = _shape(ts)
    tbl = ppc.device_pallas_tables(ts, "cpu")
    dist = torch.from_numpy(_field(np.random.default_rng(9), ts, S))
    return dist, (tbl.offs, tbl.u_of, tbl.idx, tbl.w, T, nt, S, ntp)


def test_relax_takes_the_twin_on_cpu_and_counts_no_launch():
    dist, args = _relax_args("24x12", 2)
    n = ppc.relax.launches
    got = ppc.relax(dist, *args)
    assert torch.equal(got, ppc.relax_reference(dist, *args))
    assert ppc.relax.launches == n


def test_relax_refuses_bad_arguments():
    dist, (offs, u_of, idx, w, T, nt, S, ntp) = _relax_args()
    with pytest.raises(ValueError, match="dist must be"):
        ppc.relax(dist[:, :, :-1], offs, u_of, idx, w, T, nt, S, ntp)
    with pytest.raises(ValueError, match="w must be"):
        ppc.relax(dist, offs, u_of, idx, w[:, :8], T, nt, S, ntp)
    with pytest.raises(ValueError, match="ntp % 8"):
        ppc.relax(dist, offs, u_of, idx, w, T, nt, S, ntp + 1)
    with pytest.raises(TypeError, match="float64"):
        ppc.relax(dist, offs, u_of, idx, w.double(), T, nt, S, ntp)
    meta = [torch.zeros(t.shape, dtype=t.dtype, device="meta")
            for t in (dist, offs, u_of, idx, w)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ppc.relax(*meta, T, nt, S, ntp)


def test_device_tables_refuse_out_of_range_indices():
    """The kernels read through offs, u_of and idx unchecked, so tables
    from outside (tiled_from_numpy) are checked when they are uploaded."""
    _, cg, _ = _grids("16x4")
    ts = ppc.pack_tiled_stencil(cg)
    ppc.check_tiled_stencil(ts)
    bad_idx = ts.idx.copy()
    bad_idx[0, 0] = 128
    bad_offs = ts.offs.copy()
    bad_offs[-1] += 1
    bad_u = ts.u_of.copy()
    bad_u[0] = 5 * ts.T
    for bad in ({"idx": bad_idx}, {"offs": bad_offs}, {"u_of": bad_u}):
        with pytest.raises(ValueError, match="range|rise"):
            ppc.device_pallas_tables(dataclasses.replace(ts, **bad), "cpu")
