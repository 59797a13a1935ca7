"""PyTorch port: the work partition of the 'twrapped' engine's CUDA kernel
`csrc/titer.cu`, replayed on the CPU, and its float64 twin against the
JAX package.

The kernel's band takes a block of lanes through a run of theta rows:
the rows a run reads (wrapped mod NTT when dup == 0, +inf past the
source block's edge when dup > 0) at the lanes m - maxdm .. m + maxdm
(wrapped mod ML), every (dm, dc) tap of every lane.  Each row's band is
evaluated once: the duplicate merge (rows t < dup take row t+nt's
result, rows t >= nt row t-nt's) and the fan move to the start of the
next pass, and the centre takes its minimum from the band's output
before the merge.  `titer_tiles_reference` replays that partition in
torch ops and must equal `titer_reference` bit for bit: each candidate
is one add, the minimum does not depend on order, and rounding is
monotone, so min(a, b) + f == min(a + f, b + f).  The cases cover dup 0
(the wrap) and dup > 0 (the merge), one and two source blocks, runs of
one and two steps, float32 and float64, and the path's 180x63.  The CUDA
kernel itself runs only on the card; chip_smoke.py holds it to
`titer_reference` there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.ops import wrapped_t as jwt
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.convert import stencil_from_numpy
from raytracer_tpu_torch.ops import wrapped_t as pwt
from jax_mappings import below_the_map_limit  # noqa: F401,E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _static(ws):
    return pwt.TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)


def _case(ntheta, nr, spacing, S, dtype, seed, inf_share=0.5):
    _, cg, _ = pt.init_annulus_circulant(ntheta, nr, spacing)
    ws = pwt.pack_twrapped_stencil(cg, dtype=dtype, band_closure=1)
    tbl = pwt.device_twrapped_tables(ws, "cpu")
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1500.0, (S * ws.NTT, ws.ML)).astype(dtype)
    d[rng.random(d.shape) < inf_share] = np.inf
    d[:, ws.Mp:] = np.inf
    cen = rng.uniform(0.0, 1500.0, S).astype(dtype)
    return ws, tbl, torch.from_numpy(d), torch.from_numpy(cen)


@pytest.mark.parametrize("ntheta,S,dtype,run", [
    (20, 2, np.float32, 4), (21, 1, np.float32, 8), (16, 1, np.float32, 4),
    (16, 2, np.float64, 4), (30, 2, np.float64, 8), (9, 2, np.float32, 4)],
    ids=["dup4-S2", "dup3-S1-run8", "dup0-S1", "dup0-S2-f64",
         "dup2-S2-run8-f64", "dup7-S2"])
def test_tiled_band_replays_the_twin(ntheta, S, dtype, run):
    ws, tbl, dist, cen = _case(ntheta, 4, 400.0, S, dtype, ntheta + S)
    want = pwt.titer_reference(_static(ws), dist, cen, tbl, 2)
    got = pwt.titer_tiles_reference(_static(ws), dist, cen, tbl, 2, run=run)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(want[0]).sum() > torch.isfinite(dist).sum()


def test_tiled_band_replays_the_twin_at_the_paths_shape():
    """180x63 (NTT 184, dup 4, ML 896, maxdm 48 with band closure 1)."""
    ws, tbl, dist, cen = _case(180, 63, 20.0, 1, np.float32, 180)
    want = pwt.titer_reference(_static(ws), dist, cen, tbl, 1)
    got = pwt.titer_tiles_reference(_static(ws), dist, cen, tbl, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_tiled_band_replays_the_twin_at_every_iteration_count(iters):
    """The first pass (no merge), the merge and fan moved to the next
    pass, and the last pass that only merges: the first source block's
    centre starts at +inf and takes its value through the fan."""
    ws, tbl, dist, cen = _case(12, 4, 400.0, 2, np.float32, iters, 0.8)
    cen[0] = float("inf")
    want = pwt.titer_reference(_static(ws), dist, cen, tbl, iters)
    got = pwt.titer_tiles_reference(_static(ws), dist, cen, tbl, iters)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("ntheta", [12, 16])
def test_titer_reference_float64_matches_pallas(ntheta):
    """The float64 twin and the tiles replay against the JAX kernel in
    interpret mode (x64), dup 4 and dup 0, S = 2."""
    _, jcg, _ = rt.init_annulus_circulant(ntheta, 4, 400.0, dtype=np.float64)
    ws = stencil_from_numpy(jwt.pack_twrapped_stencil(jcg, dtype=np.float64,
                                                      band_closure=1))
    S = 2
    rng = np.random.default_rng(ntheta)
    dist = rng.uniform(0.0, 800.0, (S * ws.NTT, ws.ML))
    dist[rng.random(dist.shape) < 0.4] = np.inf
    dist[:, ws.Mp:] = np.inf
    cen = rng.uniform(0.0, 800.0, S)
    cen[0] = np.inf
    cen2d = np.broadcast_to(np.repeat(cen, 128)[None, :], (8, S * 128))
    tabs = (ws.wrows, ws.ring_f, ws.ring_b, ws.cfl, ws.cbl, ws.fan_w)
    want_d, want_c = jwt._titer_call(
        tuple(_static(ws)), jnp.asarray(dist), jnp.asarray(cen2d),
        *(jnp.asarray(a) for a in tabs), 3, True, S)
    assert np.asarray(want_d).dtype == np.float64
    tbl = pwt.TWTables(*(torch.from_numpy(a) for a in tabs))
    got_d, got_c = pwt.titer_reference(_static(ws), torch.from_numpy(dist),
                                       torch.from_numpy(cen), tbl, 3)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c)[0, ::128])
    got_t = pwt.titer_tiles_reference(_static(ws), torch.from_numpy(dist),
                                      torch.from_numpy(cen), tbl, 3)
    assert torch.equal(got_t[0], got_d) and torch.equal(got_t[1], got_c)


def test_launch_plan_takes_the_kernels_strips():
    """The ring's column strip (2, 4 or 8 rows a thread on one warp up to
    256 theta rows, else 32 on several warps) and the chain's row strip
    (exactly ML lanes: the most lanes a thread, a multiple of 4, that
    divide ML / 32, on the fewest warps), float32 and float64 alike."""
    ws, _, _, _ = _case(180, 63, 20.0, 1, np.float32, 0)
    for item in (4, 8):
        assert pwt.titer_launch_plan(_static(ws), item) == (8, 1, 28, 1)
    ws, _, _, _ = _case(16, 4, 400.0, 1, np.float32, 0)
    assert pwt.titer_launch_plan(_static(ws), 4) == (2, 1, 8, 1)   # ML 256
    st = pwt.TWStatic(1000, 2048, 2048, 2044, 48)
    assert pwt.titer_launch_plan(st, 4) == (32, 2, 32, 2)
    assert pwt.titer_launch_plan(st._replace(ML=1408, NTT=128), 4) == \
        (4, 1, 4, 11)


def test_launch_plan_refuses_what_a_block_cannot_hold():
    """Each limit of the kernel's launch is refused by name: a ring
    column of more than 32 warps or of more shared memory than a block
    has (float64), a chain row of more than 32 warps, a band ring wider
    than a block's shared memory."""
    st = pwt.TWStatic(1000, 1024, 20000, 19996, 48)
    assert pwt.titer_launch_plan(st, 4) == (32, 20, 32, 1)
    with pytest.raises(ValueError, match="column of 20000 theta rows.* 227 KB"):
        pwt.titer_launch_plan(st, 8)
    with pytest.raises(ValueError, match="column of 40000 theta rows"):
        pwt.titer_launch_plan(st._replace(NTT=40000, nt=40000), 4)
    with pytest.raises(ValueError, match="row of 33792 lanes"):
        pwt.titer_launch_plan(st._replace(NTT=184, ML=33792), 4)
    with pytest.raises(ValueError, match="row of 4736 lanes"):
        pwt.titer_launch_plan(st._replace(NTT=184, ML=4736), 4)
    with pytest.raises(ValueError, match="band ring of 16 rows"):
        pwt.titer_launch_plan(st._replace(NTT=184, maxdm=2000), 4)


def test_titer_takes_float64_on_the_cpu_twin_and_counts_no_launch():
    ws, tbl, dist, cen = _case(16, 4, 400.0, 1, np.float64, 3)
    n = pwt.titer.launches
    got = pwt.titer(_static(ws), dist, cen, tbl, 2)
    want = pwt.titer_reference(_static(ws), dist, cen, tbl, 2)
    assert got[0].dtype == torch.float64
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert pwt.titer.launches == n
