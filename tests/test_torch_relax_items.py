"""PyTorch port: the work partition of the 'pallas' engine's CUDA kernel
`csrc/relax.cu`, replayed on the CPU.

The kernel reads the stencil as the chunk tables of `relax_chunks` (the
form `csrc/fused.cu` reads too, through `csrc/lane_gather.cuh`) and
takes items of (source, 64 theta rows, chunk); it has no haloed copy of
the state, so it does the theta wrap while it stages each item's
68-row window.  `relax_items_reference` replays that partition in torch
ops and must equal `relax_reference` (the Pallas kernel's 5 theta-rolled
copies and min-gather loop) bit for bit: each candidate is one add and
the minimum does not depend on order.  The cases are the chip run's:
24x12 S=2 (T=3, where the 2 wrapped rows of each window edge meet the
source's own rows) in float32 and float64, and 180x63 S=1; the inputs
hold finite values on the pad rows, which a sweep resets to +inf.
The CUDA kernel runs only on the card; chip_smoke.py holds it to
`relax_reference` there.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu_torch as pt
from raytracer_tpu_torch.contrib import pallas_circulant as ppc

GRIDS = {"24x12": (24, 12, 150.0), "180x63": (180, 63, 20.0),
         "8x4": (8, 4, 400.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(grid, S, dtype, seed):
    _, cg, _ = pt.init_annulus_circulant(*GRIDS[grid])
    ts = ppc.pack_tiled_stencil(cg, dtype)
    tb = ppc.device_pallas_tables(ts, "cpu")
    nt = ts.ntheta
    ntp = -(-nt // 8) * 8
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1500.0, (ts.T, S, ntp, 128)).astype(dtype)
    d[rng.random(d.shape) < 0.3] = np.inf
    d[:, :, nt:] = rng.uniform(0.0, 1500.0, d[:, :, nt:].shape)
    return torch.from_numpy(d), tb, (ts.T, nt, S, ntp)


@pytest.mark.parametrize("grid,S,dtype", [
    ("24x12", 2, np.float32), ("24x12", 2, np.float64),
    ("180x63", 1, np.float32), ("8x4", 3, np.float32)],
    ids=["24x12-S2", "24x12-S2-f64", "180x63-S1", "8x4-S3"])
def test_chunk_items_replay_the_twin(grid, S, dtype):
    x, tb, (T, nt, S, ntp) = _case(grid, S, dtype, S + len(grid))
    want = ppc.relax_reference(x, tb.offs, tb.u_of, tb.idx, tb.w, T, nt, S,
                               ntp)
    chunks = ppc._kernel_chunks(tb.offs, tb.u_of, tb.idx, tb.w, T)
    got = ppc.relax_items_reference(x, chunks, T, nt, S, ntp)
    assert torch.equal(got, want)
    assert not torch.equal(want[:, :, :nt], x[:, :, :nt])  # it relaxed
    assert torch.isinf(want[:, :, nt:]).all()


def test_kernel_chunks_are_packed_once_per_stencil():
    """The kernel's chunk tables come from the stencil tensors it is
    given: relax_chunks' tables, packed once and kept on `w`, packed
    again when a stencil tensor is modified in place."""
    _, cg, _ = pt.init_annulus_circulant(*GRIDS["24x12"])
    ts = ppc.pack_tiled_stencil(cg)
    tb = ppc.device_pallas_tables(ts, "cpu")
    got = ppc._kernel_chunks(tb.offs, tb.u_of, tb.idx, tb.w, ts.T)
    assert len(got) == 4
    for t, a in zip(got, ppc.relax_chunks(ts)):
        assert np.array_equal(t.numpy(), a)
    again = ppc._kernel_chunks(tb.offs, tb.u_of, tb.idx, tb.w, ts.T)
    assert all(a is b for a, b in zip(got, again))
    tb.w[0, 0] = float("inf")
    fresh = ppc._kernel_chunks(tb.offs, tb.u_of, tb.idx, tb.w, ts.T)
    assert fresh[0] is not got[0]
    ts.w[0, 0] = np.inf
    for t, a in zip(fresh, ppc.relax_chunks(ts)):
        assert np.array_equal(t.numpy(), a)


def test_relax_checks_the_stencil_tables():
    x, tb, (T, nt, S, ntp) = _case("24x12", 2, np.float32, 0)
    args = (tb.offs, tb.u_of, tb.idx, tb.w, T, nt, S, ntp)
    # on the CPU the twin runs
    assert torch.equal(ppc.relax(x, *args), ppc.relax_reference(x, *args))
    with pytest.raises(ValueError, match="idx must be"):
        ppc.relax(x, tb.offs, tb.u_of, tb.idx[:, :8], tb.w, T, nt, S, ntp)
    with pytest.raises(TypeError, match="relax tensors"):
        ppc.relax(x, tb.offs, tb.u_of, tb.idx, tb.w.double(), T, nt, S, ntp)
