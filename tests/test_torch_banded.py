"""PyTorch port: the RCM-banded solver and its kernels' twins.

`prepare_banded` bit-equal to the JAX package's (offsets, the dense W,
perm, iperm and the halo in permuted ids); the kernels' per-row finite
tap lists replayed to the dense sweep; the twin sweep against the JAX
package's `_banded_sweep`; `solve_banded` and `solve_banded_gs`, fields
and iteration counts bit-equal to the JAX package's on the fixtures of
tests/test_banded.py (the Delaunay mesh nr=12 spacing 500, the 16x6
annulus with its halo twins, dual velocities, the S-wave zero-velocity
core, a source batch, the natural order) and on a mesh smaller than one
Gauss-Seidel block; a NumPy replay of csrc/banded.cu's Gauss-Seidel read
rule (the block's rows from the pass's snapshot, rows outside from the
input or the output) bit-equal to the twin.  The kernels themselves run
only on the card (chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JC
from raytracer_tpu.models.annulus import node_adjacency
from raytracer_tpu.models.delaunay import add_midpoints, triangle_annulus_2d
from raytracer_tpu.ops import banded as jb
import raytracer_tpu_torch as pt
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.ops import banded as pb

NO_HALO = np.empty((0, 2), np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vel(gr, kind="Vp"):
    prof = rt.velocity_profile("ak135")
    if kind == "dual":
        return rt.dual_velocity(gr.r, rt.LinearInterpolation(prof.r, prof.Vp))
    return rt.interpolate_velocity(gr.r, rt.LinearInterpolation(
        prof.r, getattr(prof, kind)))


@pytest.fixture(scope="module")
def meshes():
    dg = add_midpoints(triangle_annulus_2d(nr=12, spacing=500.0))
    tg = add_midpoints(triangle_annulus_2d(nr=4, spacing=2500.0))
    gr, A, halo = rt.init_annulus(16, 6, spacing=200.0)
    return {"delaunay": (dg, node_adjacency(dg, star=0), NO_HALO),
            "tiny": (tg, node_adjacency(tg, star=0), NO_HALO),
            "16x6": (gr, A, halo)}


def _src(gr, deg=0.0):
    return rt.closest_point(gr, np.deg2rad(deg), rt.R, system="polar")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what}: {int((a != b).sum())} differ"


def _pair(meshes, name, vel="Vp", dtype="float64", order="rcm"):
    gr, A, halo = meshes[name]
    U = _vel(gr, vel)
    jbg = jb.prepare_banded(A, halo, gr, U, JC(dtype=dtype), order=order)
    pbg = pb.prepare_banded(A, halo, gr, U, PC(dtype=dtype), order=order,
                            device="cpu")
    return gr, jbg, pbg


PREPARED = [("delaunay", "Vp", "float32", "rcm"),
            ("delaunay", "Vp", "float64", "rcm"),
            ("delaunay", "Vp", "float64", "natural"),
            ("16x6", "Vp", "float64", "rcm"),
            ("16x6", "dual", "float32", "rcm"),
            ("16x6", "Vs", "float64", "rcm")]


@pytest.mark.parametrize("case", PREPARED, ids="-".join)
def test_prepare_banded_bit_equal(meshes, case):
    _, jbg, pbg = _pair(meshes, *case)
    _same(pbg.offs.numpy(), jbg.offs, "offs")
    _same(pbg.W.numpy(), jbg.W, "W")
    _same(pbg.halo_src.numpy(), jbg.halo_src, "halo_src")
    _same(pbg.halo_dst.numpy(), jbg.halo_dst, "halo_dst")
    _same(pbg.perm, jbg.perm, "perm")
    _same(pbg.iperm, jbg.iperm, "iperm")
    _same(pbg.offsets_np, jbg.offsets_np, "offsets_np")
    assert (pbg.n, pbg.n_pad) == (jbg.n, jbg.n_pad)


def _random_field(rng, S, n_pad, n, dtype):
    d = rng.uniform(0.0, 900.0, (S, n_pad)).astype(dtype)
    d[rng.random((S, n_pad)) < 0.3] = np.inf
    d[:, n:] = np.inf
    return d


@pytest.mark.parametrize("case", PREPARED[:4], ids="-".join)
def test_tap_lists_replay_the_dense_sweep(meshes, case):
    """The kernels' tap lists (every finite W entry, in range) give the
    dense sweep's floats: min over a row's taps of d[i+o] + w."""
    _, jbg, pbg = _pair(meshes, *case)
    toff, tcol, tw = (pbg.toff.numpy(), pbg.tcol.numpy(), pbg.tw.numpy())
    W2 = pbg.W.numpy().reshape(-1, pbg.n_pad)
    assert len(tw) == int(np.isfinite(W2).sum())
    assert tcol.min() >= 0 and tcol.max() < pbg.n
    rng = np.random.default_rng(5)
    d = _random_field(rng, 2, pbg.n_pad, pbg.n, W2.dtype)
    want = pb.banded_sweep_reference(torch.from_numpy(d), pbg.offsets_np,
                                     pbg.W).numpy()
    got = d.copy()
    for i in range(pbg.n_pad):
        for t in range(toff[i], toff[i + 1]):
            got[:, i] = np.minimum(got[:, i], d[:, tcol[t]] + tw[t])
    _same(got, want, "sweep")
    jw = jb._banded_sweep(jnp.asarray(d), jbg.offs, jbg.W)
    _same(want, jw, "JAX sweep")


SOLVES = [("delaunay", "Vp", "float64", "rcm", 1),
          ("delaunay", "Vp", "float32", "rcm", 1),
          ("delaunay", "Vp", "float64", "natural", 1),
          ("16x6", "Vp", "float64", "rcm", 1),
          ("16x6", "dual", "float64", "rcm", 1),
          ("16x6", "Vs", "float64", "rcm", 1),
          ("16x6", "Vp", "float64", "rcm", 3)]


@pytest.mark.parametrize("case", SOLVES,
                         ids=lambda c: "-".join(map(str, c)))
def test_solve_banded_equals_jax(meshes, case):
    name, vel, dtype, order, S = case
    gr, jbg, pbg = _pair(meshes, name, vel, dtype, order)
    srcs = [_src(gr, d) for d in (0.0, 90.0, 210.0)[:S]]
    dj, ij = jb.solve_banded(jbg, srcs, JC(dtype=dtype))
    dp, ip = pb.solve_banded(pbg, srcs, PC(dtype=dtype))
    assert ip == ij > 0
    _same(dp, dj, "field")
    assert not np.isnan(dp).any()


def test_solve_banded_cut_equals_jax(meshes):
    gr, jbg, pbg = _pair(meshes, "delaunay")
    src = _src(gr)
    dj, ij = jb.solve_banded(jbg, [src], JC(dtype="float64", max_iters=5))
    dp, ip = pb.solve_banded(pbg, [src], PC(dtype="float64", max_iters=5))
    assert ip == ij == 5
    _same(dp, dj, "field")


GS = [("delaunay", "float64", 512, 2, 3),
      ("delaunay", "float32", 512, 2, 1),
      ("delaunay", "float64", 512, 1, 1),
      ("16x6", "float64", 512, 2, 1),
      ("tiny", "float64", 2048, 2, 1)]


@pytest.mark.parametrize("case", GS, ids=lambda c: "-".join(map(str, c)))
def test_solve_banded_gs_equals_jax(meshes, case):
    """Rounds and fields bit-equal; 'tiny' takes a block larger than its
    n_pad (512), which halves to one block of 512 rows."""
    name, dtype, block, passes, S = case
    gr, jbg, pbg = _pair(meshes, name, "Vp", dtype)
    srcs = [_src(gr), 3, len(gr.r) - 2][:S]
    dj, ij = jb.solve_banded_gs(jbg, srcs, JC(dtype=dtype), block=block,
                                passes=passes)
    dp, ip = pb.solve_banded_gs(pbg, srcs, PC(dtype=dtype), block=block,
                                passes=passes)
    assert ip == ij > 0
    _same(dp, dj, "field")
    # the same fixpoint as the Jacobi solve
    dJ, iJ = pb.solve_banded(pbg, srcs, PC(dtype=dtype))
    assert ip <= iJ
    np.testing.assert_allclose(dp, dJ, rtol=0,
                               atol=1e-9 if dtype == "float64" else 1e-3)


def _gs_replay(d, pbg, forward, B, P):
    """One direction as csrc/banded.cu computes it: blocks in order; in a
    pass a tap reads the block's row from the pass's snapshot, a row of a
    block already written from the output, any other row from the input;
    then the copy with the halo minimum."""
    toff, tcol, tw = pbg.toff.numpy(), pbg.tcol.numpy(), pbg.tw.numpy()
    S, n_pad = d.shape
    out = np.full_like(d, np.nan)
    NB = n_pad // B
    for g in range(NB):
        r0 = (g if forward else NB - 1 - g) * B
        r1 = r0 + B
        cur = d[:, r0:r1].copy()
        for _ in range(P):
            nxt = cur.copy()
            for i in range(B):
                r = r0 + i
                for t in range(toff[r], toff[r + 1]):
                    j = tcol[t]
                    if r0 <= j < r1:
                        src = cur[:, j - r0]
                    elif (j < r0) if forward else (j >= r1):
                        src = out[:, j]
                    else:
                        src = d[:, j]
                    nxt[:, i] = np.minimum(nxt[:, i], src + tw[t])
            cur = nxt
        out[:, r0:r1] = cur
    didx, hoff, hsrc = pbg.didx.numpy(), pbg.hoff.numpy(), pbg.hsrc.numpy()
    merged = out.copy()
    for i in range(n_pad):
        if didx[i] >= 0:
            for h in range(hoff[didx[i]], hoff[didx[i] + 1]):
                merged[:, i] = np.minimum(merged[:, i], out[:, hsrc[h]])
    return merged


@pytest.mark.parametrize("name,B,P", [("16x6", 512, 2), ("16x6", 1024, 1),
                                      ("delaunay", 512, 2),
                                      ("delaunay", 256, 3)])
def test_gs_kernel_read_rule_replay_equals_twin(meshes, name, B, P):
    _, _, pbg = _pair(meshes, name, "Vp", "float32")
    rng = np.random.default_rng(11)
    d = _random_field(rng, 2, pbg.n_pad, pbg.n, np.float32)
    for forward in (True, False):
        want = pb.banded_gs_reference(torch.from_numpy(d), pbg, forward,
                                      block=B, passes=P).numpy()
        _same(_gs_replay(d, pbg, forward, B, P), want,
              f"forward={forward}")


def test_banded_step_changes_nothing_after_the_fixpoint(meshes):
    gr, _, pbg = _pair(meshes, "16x6")
    s = pb.BandedState(pb._sources(pbg, [_src(gr)], PC(dtype="float64")),
                       torch.ones((), dtype=torch.int32),
                       torch.zeros((), dtype=torch.int32))
    while int(s.changed):
        s = pb.banded_step(s, pbg)
    again = pb.banded_step(s, pbg)
    assert int(again.it) == int(s.it)
    assert torch.equal(again.dist, s.dist)
    capped = pb.banded_step(s._replace(changed=torch.ones((), dtype=torch.int32)),
                            pbg, max_iters=int(s.it))
    assert int(capped.it) == int(s.it)


def test_convert_banded_from_jax(meshes):
    gr, jbg, _ = _pair(meshes, "16x6")
    pbg = convert.banded_from_numpy(
        jbg.offs, jbg.W, jbg.halo_src, jbg.halo_dst, jbg.perm, jbg.iperm,
        jbg.n, jbg.n_pad, jbg.offsets_np, "cpu")
    srcs = [_src(gr), 40]
    dj, ij = jb.solve_banded(jbg, srcs, JC(dtype="float64"))
    dp, ip = pt.solve_banded(pbg, srcs, PC(dtype="float64"))
    assert ip == ij
    _same(dp, dj, "field")


def test_banded_refuses_other_devices_and_wide_blocks(meshes):
    _, _, pbg = _pair(meshes, "delaunay")
    d = torch.zeros((1, pbg.n_pad), dtype=torch.float32)
    with pytest.raises(ValueError, match="differ"):
        pb.banded_gs(d, pbg, True)
    meta = pb.BandedGraph(*[t.to("meta") if torch.is_tensor(t) else t
                            for t in pbg])
    with pytest.raises(ValueError, match="cuda or cpu"):
        pb.banded_gs(d.double().to("meta"), meta, True)
    with pytest.raises(ValueError, match="shared memory"):
        pb.gs_smem_bytes(16384, 8)
    assert pb.gs_smem_bytes(512, 8) == 8192
