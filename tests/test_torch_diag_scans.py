"""PyTorch port: the work partitions of the 'diag' engine's CUDA kernels,
`csrc/diag.cu` (the sweep, its fan and changed test) and
`csrc/diag_scans.cuh` (the ring and chain scans), replayed on the CPU,
and their float64 twins against the JAX package.

- The sweep reads per-row lists of the finite taps (`diag_tap_lists`)
  against a tiled shared-memory window whose lane p holds theta lane
  p mod nt (the ring wraps mod nt inside [0, NTL)); the padding lanes
  [nt, NTL) come out +inf.  `diag_tiles_reference` replays that and must
  equal `diag_sweep_reference` bit for bit: each candidate is one add
  and the minimum does not depend on order.
- The chain scan reads the sums of `_sum_min_scan`'s recursion packed
  once on the host (`chain_sum_tree`, the recursion's own adds in the
  field's dtype) and scans the min component level by level in place.
  `chain_tree_reference` replays that and must equal `_chain_scan`, and
  so `jax.lax.associative_scan`, bit for bit, at even and odd numbers
  of rows (odd levels on the way down in every case: 1032 -> 516 ->
  258 -> 129 -> 64 ...).
- The twins take float64 and equal the JAX functions in x64.
The CUDA kernels run only on the card; chip_smoke.py holds them to the
twins there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.ops import diag_circulant as jdc
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.convert import diag_from_numpy
from raytracer_tpu_torch.ops import diag_circulant as pdc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _static(ds):
    return pdc.DiagStatic(ds.D, ds.Mp, ds.NTL, ds.pad, ds.ntheta)


def _stencil(ntheta, nr, spacing, dtype=np.float32):
    _, cg, _ = pt.init_annulus_circulant(ntheta, nr, spacing)
    return pdc.pack_diag_stencil(cg, dtype=dtype)


def _field(rng, shape, dtype, inf_share=0.4):
    d = rng.uniform(0.0, 800.0, shape).astype(dtype)
    d[rng.random(shape) < inf_share] = np.inf
    return d


@pytest.mark.parametrize("ntheta,nr,lanes,dtype", [
    (9, 3, 64, np.float32), (16, 4, 32, np.float32), (47, 3, 64, np.float64),
    (127, 3, 64, np.float32), (127, 3, 32, np.float64),
    (127, 63, 64, np.float32)],
    ids=["9x3", "16x4-32lanes", "47x3-f64", "127x3", "127x3-32lanes-f64",
         "127x63"])
def test_tiled_sweep_replays_the_twin(ntheta, nr, lanes, dtype):
    """nt 9 and 16 wrap inside the first tile, nt 127 at the last lane of
    the 128-lane cover; the padding lanes hold finite values in the input
    and come out +inf."""
    ds = _stencil(ntheta, nr, 400.0 if nr < 63 else 20.0, dtype)
    tbl = pdc.device_diag_tables(ds, "cpu")
    dist = torch.from_numpy(_field(np.random.default_rng(ntheta), (ds.Mp, ds.NTL),
                                   dtype))
    want = pdc.diag_sweep_reference(_static(ds), dist, tbl)
    got = pdc.diag_tiles_reference(_static(ds), dist, tbl, lanes=lanes)
    assert torch.equal(got, want)
    assert torch.isinf(got[:, ds.ntheta:]).all()


def test_tap_lists_are_the_finite_weights_in_reach():
    """Row m's list holds every diagonal whose weight for m is finite and
    whose source row m + dm lies in [0, Mp), once, within the stencil's
    row padding and two theta lanes."""
    ds = _stencil(127, 3, 400.0)
    tl = pdc.diag_tap_lists(ds)
    taps = pdc.diag_taps(ds)
    d_ids = np.arange(ds.D)
    W = ds.wp[d_ids // 128, :, d_ids % 128]
    dm = tl.dmdc >> 16
    dc = ((tl.dmdc & 0xFFFF) ^ 0x8000) - 0x8000
    m = np.repeat(np.arange(ds.Mp), np.diff(tl.ptr))
    assert tl.ptr[0] == 0 and tl.ptr[-1] == len(tl.w) and tl.w.dtype == W.dtype
    assert np.abs(dm).max() <= ds.pad and np.abs(dc).max() <= 2
    want = {(int(r), int(taps[j, 0]), int(taps[j, 1]), float(W[j, r]))
            for j, r in zip(*np.nonzero(np.isfinite(W)))
            if 0 <= r + taps[j, 0] < ds.Mp}
    got = {(int(r), int(a), int(b), float(w))
           for r, a, b, w in zip(m, dm, dc, tl.w)}
    assert got == want and len(got) == len(tl.w)


def test_diag_sweep_reference_float64_matches_pallas():
    """The float64 twin and the tiles replay against the JAX kernel in
    interpret mode (x64) at ntheta 47 and 127."""
    for ntheta in (47, 127):
        _, jcg, _ = rt.init_annulus_circulant(ntheta, 3, 400.0,
                                              dtype=np.float64)
        ds = diag_from_numpy(jdc.pack_diag_stencil(jcg, dtype=np.float64))
        dist = _field(np.random.default_rng(ntheta), (ds.Mp, ds.NTL),
                      np.float64)
        st = _static(ds)
        want = np.asarray(jdc._sweep_diag(jnp.asarray(dist), tuple(st),
                                          jnp.asarray(ds.offs),
                                          jnp.asarray(ds.wp), True))
        assert want.dtype == np.float64
        tbl = pdc.device_diag_tables(ds, "cpu")
        got = pdc.diag_sweep_reference(st, torch.from_numpy(dist), tbl)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(pdc.diag_tiles_reference(st, torch.from_numpy(dist),
                                                    tbl), got)


def _cut(ds, rows):
    """The scans' tables of the first `rows` slots (any count of rows,
    odd ones too: the scans take any)."""
    import dataclasses

    return dataclasses.replace(
        ds, ring_f=ds.ring_f[:rows], ring_b=ds.ring_b[:rows],
        chain_f=ds.chain_f[:rows], chain_b=ds.chain_b[:rows],
        fan_w=ds.fan_w[:rows], Mp=rows)


@pytest.mark.parametrize("rows,dtype", [
    (None, np.float32), (None, np.float64), (1031, np.float32), (37, np.float64),
    (1, np.float32)], ids=["1032", "1032-f64", "1031", "37-f64", "1"])
def test_chain_tree_replays_the_twin_and_jax(rows, dtype):
    """127x63's chain costs (Mp 1032) and its first 1031, 37 and 1 rows:
    the packed sums and the level-by-level min scan give `_chain_scan`'s
    floats, which are `jax.lax.associative_scan`'s."""
    ds = _stencil(127, 63, 20.0, dtype)
    if rows is not None:
        ds = _cut(ds, rows)
    sc = pdc.device_diag_scan_tables(ds, "cpu")
    x = _field(np.random.default_rng(ds.Mp), (ds.Mp, ds.NTL), dtype, 0.3)
    want = pdc._chain_scan(torch.from_numpy(x), sc.chain_f, sc.chain_b)
    got = pdc.chain_tree_reference(torch.from_numpy(x), sc.tree_f, sc.tree_b)
    assert torch.equal(got, want)
    jw = np.asarray(jdc._chain_scan(jnp.asarray(x), jnp.asarray(ds.chain_f),
                                    jnp.asarray(ds.chain_b)))
    np.testing.assert_array_equal(got.numpy(), jw)
    if ds.Mp > 1:
        assert not torch.equal(got, torch.from_numpy(x))


def test_chain_sum_tree_holds_the_recursions_sums():
    """Level l + 1 of the tree is s[0:n-1:2] + s[1::2] of level l, in the
    costs' dtype, down to two values: the sums `_sum_min_scan` forms."""
    rng = np.random.default_rng(3)
    for n, dtype in ((1032, np.float32), (129, np.float64), (2, np.float32),
                     (1, np.float32)):
        cost = rng.uniform(0.0, 5.0, n).astype(dtype)
        cost[0] = np.inf
        tree = pdc.chain_sum_tree(cost)
        assert tree.dtype == dtype
        s, off = cost, 0
        while len(s) >= 2:
            np.testing.assert_array_equal(tree[off:off + len(s)], s)
            off += len(s)
            s = s[0:len(s) - 1:2] + s[1::2]
        assert off == len(tree)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ring_scan_twin_matches_jax(dtype):
    """`_ring_scan` (the ring kernel's twin) against the JAX function in
    its dtype, with +inf ring costs on some rows and finite padding lanes
    (copied through)."""
    ds = _stencil(127, 3, 400.0, dtype)
    x = _field(np.random.default_rng(11), (ds.Mp, ds.NTL), dtype, 0.3)
    rf = ds.ring_f.copy()
    rf[::7] = np.inf
    want = np.asarray(jdc._ring_scan(jnp.asarray(x), jnp.asarray(rf),
                                     jnp.asarray(ds.ring_b), ds.ntheta))
    assert want.dtype == dtype
    got = pdc._ring_scan(torch.from_numpy(x), torch.from_numpy(rf),
                         torch.from_numpy(ds.ring_b), ds.ntheta)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_wrappers_take_the_twins_on_cpu_and_count_no_launch():
    ds = _stencil(47, 3, 400.0)
    sc = pdc.device_diag_scan_tables(ds, "cpu")
    x = torch.from_numpy(_field(np.random.default_rng(2), (ds.Mp, ds.NTL),
                                np.float32))
    n = (pdc.ring_scan.launches, pdc.chain_scan.launches)
    assert torch.equal(pdc.ring_scan(x, sc, ds.ntheta),
                       pdc._ring_scan(x, sc.ring_f, sc.ring_b, ds.ntheta))
    assert torch.equal(pdc.chain_scan(x, sc),
                       pdc._chain_scan(x, sc.chain_f, sc.chain_b))
    assert (pdc.ring_scan.launches, pdc.chain_scan.launches) == n
    with pytest.raises(TypeError, match="chain_scan tensors"):
        pdc.chain_scan(x.double(), sc)
    with pytest.raises(ValueError, match="no sum trees of"):
        pdc.chain_scan(x, sc._replace(tree_b=sc.tree_b[:-1]))
    meta = pdc.DiagScanTables(*(torch.zeros(t.shape, dtype=t.dtype,
                                            device="meta") for t in sc))
    with pytest.raises(ValueError, match="cuda or cpu"):
        pdc.ring_scan(torch.zeros(x.shape, device="meta"), meta, ds.ntheta)


def test_diag_step_is_the_loop_body():
    """diag_step on the CPU: the sweep, the centre fan and the changed
    test of the JAX loop body, a changed and an unchanged iteration, and
    an iteration with the scans first."""
    ds = _stencil(47, 3, 400.0)
    st = _static(ds)
    tbl = pdc.device_diag_tables(ds, "cpu")
    sc = pdc.device_diag_scan_tables(ds, "cpu")
    x = torch.from_numpy(_field(np.random.default_rng(4), (ds.Mp, ds.NTL),
                                np.float32))
    x[:, ds.ntheta:] = float("inf")
    tol = torch.tensor(1e-3)
    dcen = torch.tensor(500.0)
    d, c, changed = pdc.diag_step(st, x, tbl, sc, x, dcen, tol)
    want = pdc.diag_sweep_reference(st, x, tbl)
    c_want = torch.minimum(dcen, (want + sc.fan_w).min())
    want = torch.minimum(want, c_want + sc.fan_w + sc.lane_mask)
    assert torch.equal(d, want) and torch.equal(c, c_want) and bool(changed)
    d2, c2, changed2 = pdc.diag_step(st, x, tbl, sc, d, c, tol)
    assert torch.equal(d2, d) and torch.equal(c2, c) and not bool(changed2)
    # with the scans first, as the solve's iterations run them
    d3, c3, changed3 = pdc.diag_step(st, x, tbl, sc, x, dcen, tol, scan=True)
    want = pdc.diag_sweep_reference(
        st, pdc._chain_scan(pdc._ring_scan(x, sc.ring_f, sc.ring_b, ds.ntheta),
                            sc.chain_f, sc.chain_b), tbl)
    c_want = torch.minimum(dcen, (want + sc.fan_w).min())
    want = torch.minimum(want, c_want + sc.fan_w + sc.lane_mask)
    assert torch.equal(d3, want) and torch.equal(c3, c_want) and bool(changed3)
    assert not torch.equal(d3, d)


@pytest.mark.parametrize("ntheta,nr,spacing,want", [
    (127, 63, 20.0, [(64, True), (64, True)]),
    (16, 4, 400.0, [(64, True), (64, True)])])
def test_launch_plans_take_the_kernels_tiles(ntheta, nr, spacing, want):
    """The sweep's tile (64 lanes with the block's taps in shared memory)
    and the scans' blocks (8 ring rows, 16 bytes of chain columns), float32 then
    float64."""
    ds = _stencil(ntheta, nr, spacing)
    block = pdc.band_block_taps(pdc.diag_tap_lists(ds).ptr)
    assert [pdc.diag_launch_plan(_static(ds), item, block)
            for item in (4, 8)] == want
    assert pdc.scan_launch_plan(ds.Mp, ds.NTL, 4) == (8, 4)
    assert pdc.scan_launch_plan(ds.Mp, ds.NTL, 8) == (8, 2)


def test_launch_plans_refuse_what_a_block_cannot_hold():
    """Each limit is refused by name: the sweep's window (its halo is the
    stencil's row padding), with the 32-lane tile and the taps from
    global memory on the way; the ring scan's row and the chain scan's
    column of slots."""
    st = pdc.DiagStatic(500, 1000, 128, 200, 127)
    assert pdc.diag_launch_plan(st, 4, 100) == (64, True)
    assert pdc.diag_launch_plan(st, 8, 100) == (32, True)
    assert pdc.diag_launch_plan(st, 8, 9000) == (32, False)
    with pytest.raises(ValueError, match="sweep window .* 227 KB"):
        pdc.diag_launch_plan(st._replace(pad=400), 8, 0)
    assert pdc.scan_launch_plan(14000, 128, 4) == (8, 2)
    assert pdc.scan_launch_plan(20000, 128, 4) == (8, 1)
    with pytest.raises(ValueError, match="30000 slots of a lane column"):
        pdc.scan_launch_plan(30000, 128, 4)
    with pytest.raises(ValueError, match="2 x 16384 lanes"):
        pdc.scan_launch_plan(100, 16384, 8)
