"""PyTorch port: the work partition of the 'wrapped' engine's CUDA kernel
`csrc/witer.cu`, replayed on the CPU, and its float64 twin against the
JAX package.

The kernel's band reads per-row lists of the finite taps
(`wrapped_tap_lists`) against a tiled shared-memory window with a halo
of +inf rows and, at the source block's lane edge, +inf lanes (dup > 0)
or the block's wrapped lanes (dup == 0); the centre takes its minimum
before the duplicate merge, which moves to the next pass.
`witer_tiles_reference` replays that partition in torch ops and must
equal `witer_reference` bit for bit: each candidate is one add, the
minimum does not depend on order, and rounding is monotone, so
min(a, b) + f == min(a + f, b + f).  The cases are the chip run's
shapes: 183x63 (dup 73) and 256x63 (dup 0), S=1 and S=2, and float64.
The CUDA kernel itself runs only on the card; chip_smoke.py holds it to
`witer_reference` there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.ops import diag_wrapped as jdw
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.convert import wrapped_from_numpy
from raytracer_tpu_torch.ops import diag_wrapped as pdw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _static(ws):
    return pdw.WStatic(ws.rho_starts, ws.Mp, ws.NTL, ws.pad2, ws.nt)


def _field(rng, ws, S, dtype, inf_share=0.5):
    d = rng.uniform(0.0, 1500.0, (ws.Mp, S * ws.NTL)).astype(dtype)
    d[rng.random(d.shape) < inf_share] = np.inf
    return d


@pytest.mark.parametrize("ntheta,S,dtype", [
    (183, 1, np.float32), (183, 2, np.float32), (256, 2, np.float32),
    (256, 1, np.float32), (183, 1, np.float64)],
    ids=["183x63-S1", "183x63-S2", "256x63-S2-dup0", "256x63-S1-dup0",
         "183x63-S1-f64"])
def test_tiled_band_replays_the_twin(ntheta, S, dtype):
    _, cg, _ = pt.init_annulus_circulant(ntheta, 63, 20.0)
    ws = pdw.pack_wrapped_stencil(cg, dtype=dtype)
    tbl = pdw.device_wrapped_tables(ws, "cpu")
    rng = np.random.default_rng(ntheta + S)
    dist = torch.from_numpy(_field(rng, ws, S, dtype))
    cen = torch.from_numpy(rng.uniform(0.0, 1500.0, S).astype(dtype))
    want = pdw.witer_reference(_static(ws), dist, cen, tbl, 2)
    got = pdw.witer_tiles_reference(_static(ws), dist, cen, tbl, 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(want[0]).sum() > torch.isfinite(dist).sum()


@pytest.mark.parametrize("ntheta,S,dtype", [
    (183, 1, np.float32), (256, 2, np.float32), (47, 1, np.float64)],
    ids=["183x63-S1", "256x63-S2-dup0", "47x63-S1-f64"])
def test_tiled_band_replays_the_twin_with_32_lane_tiles(ntheta, S, dtype):
    """The kernel's narrower tile, taken where the 64-lane window and the
    block's taps do not fit in shared memory (47x63 in float64)."""
    _, cg, _ = pt.init_annulus_circulant(ntheta, 63, 20.0)
    ws = pdw.pack_wrapped_stencil(cg, dtype=dtype)
    tbl = pdw.device_wrapped_tables(ws, "cpu")
    rng = np.random.default_rng(ntheta + 7 * S)
    dist = torch.from_numpy(_field(rng, ws, S, dtype))
    cen = torch.from_numpy(rng.uniform(0.0, 1500.0, S).astype(dtype))
    want = pdw.witer_reference(_static(ws), dist, cen, tbl, 2)
    got = pdw.witer_tiles_reference(_static(ws), dist, cen, tbl, 2,
                                    lanes=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("ntheta,want", [
    (183, [(64, True), (64, True)]), (47, [(64, True), (32, True)]),
    (31, [(64, True), (32, False)])])
def test_launch_plan_takes_the_kernels_band_tile(ntheta, want):
    """The band tile of csrc/witer.cu's launch function (float32, then
    float64), from the most taps a block reads: 64 lanes with the taps in
    shared memory, else 32, else the taps from global memory."""
    _, cg, _ = pt.init_annulus_circulant(ntheta, 63, 20.0)
    ws = pdw.pack_wrapped_stencil(cg)
    ptr = pdw.wrapped_tap_lists(ws).ptr
    block = pdw.band_block_taps(ptr)
    assert block == max(ptr[min(m + 8, ws.Mp)] - ptr[m]
                        for m in range(0, ws.Mp, 8))
    assert block < 8 * np.diff(ptr).max()
    assert [pdw.witer_launch_plan(_static(ws), item, block)
            for item in (4, 8)] == want


def test_launch_plan_refuses_what_a_block_cannot_hold():
    """Each limit of the kernel's launch is refused by name: the band's
    window (its halo grows as theta coarsens: 15x63 in float64), a chain
    column of more than 32 warps or of more shared memory than a block
    has (float64), a ring row of more than 32 warps."""
    _, cg, _ = pt.init_annulus_circulant(15, 63, 20.0)
    ws = pdw.pack_wrapped_stencil(cg)
    block = pdw.band_block_taps(pdw.wrapped_tap_lists(ws).ptr)
    assert pdw.witer_launch_plan(_static(ws), 4, block) == (32, False)
    with pytest.raises(ValueError, match="band window .* 227 KB"):
        pdw.witer_launch_plan(_static(ws), 8, block)
    st = pdw.WStatic((0,) * 9, 28_000, 128, 24, 100)
    assert pdw.witer_launch_plan(st, 4, 0) == (64, True)
    with pytest.raises(ValueError, match="column of 28000 slots.* 227 KB"):
        pdw.witer_launch_plan(st, 8, 0)
    with pytest.raises(ValueError, match="column of 40000 slots"):
        pdw.witer_launch_plan(st._replace(Mp=40_000), 4, 0)
    with pytest.raises(ValueError, match="at most 8192 lanes"):
        pdw.witer_launch_plan(st._replace(Mp=800, NTL=8448), 4, 0)


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_tiled_band_replays_the_twin_at_every_iteration_count(iters):
    """The first pass (no merge), the merge and fan moved to the next
    pass, and the last pass that only merges: the centre source block
    starts at +inf and takes its value through the fan."""
    _, cg, _ = pt.init_annulus_circulant(47, 6, 400.0)   # dup 81 > nt
    ws = pdw.pack_wrapped_stencil(cg)
    tbl = pdw.device_wrapped_tables(ws, "cpu")
    rng = np.random.default_rng(iters)
    dist = torch.from_numpy(_field(rng, ws, 2, np.float32, 0.8))
    cen = torch.tensor([np.inf, 3.0], dtype=torch.float32)
    want = pdw.witer_reference(_static(ws), dist, cen, tbl, iters)
    got = pdw.witer_tiles_reference(_static(ws), dist, cen, tbl, iters)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("ntheta", [183, 256])
def test_tap_lists_are_the_finite_weights(ntheta):
    """Row m's list holds every grouped diagonal whose weight is finite
    for m and whose source row lies in [0, Mp), once, within the halo
    of rows the kernel's window holds."""
    _, cg, _ = pt.init_annulus_circulant(ntheta, 63, 20.0)
    ws = pdw.pack_wrapped_stencil(cg)
    tl = pdw.wrapped_tap_lists(ws)
    taps = pdw.wrapped_taps(ws)
    W = ws.wpT[:ws.D, :ws.Mp]
    dm = tl.dmdc >> 16
    dc = ((tl.dmdc & 0xFFFF) ^ 0x8000) - 0x8000
    m = np.repeat(np.arange(ws.Mp), np.diff(tl.ptr))
    assert tl.ptr[0] == 0 and tl.ptr[-1] == len(tl.w) and tl.w.dtype == W.dtype
    assert np.all(np.isfinite(tl.w))
    assert np.abs(dm).max() <= ws.pad2 - 8 and np.abs(dc).max() <= 2
    want = {(int(r), int(taps[j, 0]), int(taps[j, 1]), float(W[j, r]))
            for j, r in zip(*np.nonzero(np.isfinite(W)))
            if 0 <= r + taps[j, 0] < ws.Mp}
    got = {(int(r), int(a), int(b), float(w))
           for r, a, b, w in zip(m, dm, dc, tl.w)}
    assert got == want and len(got) == len(tl.w)
    assert np.diff(tl.ptr).max() <= ws.D   # a tap a diagonal at most


def test_witer_reference_float64_matches_pallas():
    """The float64 twin against the JAX kernel in interpret mode (x64),
    dup 81 > nt and dup 0, S = 2."""
    for ntheta in (47, 128):
        _, jcg, _ = rt.init_annulus_circulant(ntheta, 3, 500.0,
                                              dtype=np.float64)
        ws = wrapped_from_numpy(jdw.pack_wrapped_stencil(jcg,
                                                         dtype=np.float64))
        S = 2
        rng = np.random.default_rng(ntheta)
        dist = _field(rng, ws, S, np.float64)
        cen = rng.uniform(0.0, 800.0, S)
        cen[0] = np.inf
        cen2d = np.broadcast_to(np.repeat(cen, 128)[None, :], (8, S * 128))
        tabs = (ws.offs, ws.wp, ws.wpT, ws.ring_f, ws.ring_b, ws.cfl,
                ws.cbl, ws.fan_w)
        want_d, want_c = jdw._iter_call(
            (ws.rho_starts, ws.Mp, ws.NTL, ws.pad2, ws.nt),
            jnp.asarray(dist), jnp.asarray(cen2d),
            *(jnp.asarray(a) for a in tabs), 3, True, S)
        assert np.asarray(want_d).dtype == np.float64
        tbl = pdw.device_wrapped_tables(ws, "cpu")
        got_d, got_c = pdw.witer_reference(
            _static(ws), torch.from_numpy(dist), torch.from_numpy(cen), tbl,
            3)
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_c.numpy(),
                                      np.asarray(want_c)[0, ::128])
        got_t = pdw.witer_tiles_reference(
            _static(ws), torch.from_numpy(dist), torch.from_numpy(cen), tbl,
            3)
        assert torch.equal(got_t[0], got_d) and torch.equal(got_t[1], got_c)


def test_witer_refuses_tap_lists_of_another_dtype():
    _, cg, _ = pt.init_annulus_circulant(16, 4, 400.0)
    ws = pdw.pack_wrapped_stencil(cg)
    tbl = pdw.device_wrapped_tables(ws, "cpu")
    dist = torch.zeros((ws.Mp, ws.NTL))
    with pytest.raises(TypeError, match="witer tensors"):
        pdw.witer(_static(ws), dist, torch.zeros(1),
                  tbl._replace(tap_w=tbl.tap_w.double()), 1)
    with pytest.raises(ValueError, match="tap_ptr must be"):
        pdw.witer(_static(ws), dist, torch.zeros(1),
                  tbl._replace(tap_ptr=tbl.tap_ptr[:-1]), 1)


def test_chain_tables_are_inf_where_the_scan_wraps():
    """The CUDA kernel reads +inf past the slot axis's ends where the
    plain scans roll around it: the same floats only while the window
    costs there are +inf, which device_wrapped_tables checks at upload."""
    _, cg, _ = pt.init_annulus_circulant(183, 63, 20.0)
    ws = pdw.pack_wrapped_stencil(cg)
    pdw.check_chain_wrap(ws)
    bad = ws.cfl.copy()
    bad[2, 1] = 5.0          # span 4, row 1: a wrapping read
    with pytest.raises(ValueError, match="span 4"):
        pdw.device_wrapped_tables(ws._replace(cfl=bad, dcache={}), "cpu")
