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
input or the output) bit-equal to the twin; the window route's per-block
tap layout (`gs_layout`) decoded back to exactly the taps of `tap_lists`
at RCM and natural orders, the route `gs_plan` picks from the shapes,
and a NumPy replay of the window kernel (a ring of rows staged one block
ahead, read through the layout) bit-equal to the twin.  The kernels
themselves run only on the card (chip_smoke.py).
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


# ----------------------------------------------------------------------
# banded_gs's window route: the per-block tap layout, its route choice
# and a NumPy replay of csrc/banded.cu gs_window_kernel
# ----------------------------------------------------------------------

LAYOUTS = [("delaunay", "rcm", 512), ("delaunay", "natural", 256),
           ("delaunay", "rcm", 128), ("16x6", "rcm", 64),
           ("16x6", "natural", 64), ("tiny", "natural", 512)]


def _layout_of(meshes, name, order, B, dtype="float32"):
    _, _, pbg = _pair(meshes, name, "Vp", dtype, order)
    K = pb._gs_reach(pbg)
    lay = pb.gs_layout(pbg.toff, pbg.tcol, pbg.tw, pbg.n_pad, B, K,
                       pbg.tw.element_size(), "cpu")
    return pbg, K, lay


@pytest.mark.parametrize("case", LAYOUTS, ids=lambda c: "-".join(map(str, c)))
def test_gs_layout_holds_exactly_the_tap_lists(meshes, case):
    """Decoded slot by slot, the window layout holds each row's taps of
    `tap_lists` in their order (the ring slot back to the source row: the
    one row of the block's window [b - K, b + B + K) in that slot), each
    row once on a thread slot, groups of 32 slots padded to their widest
    row with the row's own slot at +inf; every block's taps start on a
    multiple of 32."""
    name, order, B = case
    pbg, K, lay = _layout_of(meshes, name, order, B)
    toff, tcol, tw = (pbg.toff.numpy(), pbg.tcol.numpy(), pbg.tw.numpy())
    meta, idx, w, blk = (lay.meta.numpy(), lay.idx.numpy(), lay.w.numpy(),
                         lay.blk.numpy())
    Wr, NB = lay.plan.Wr, pbg.n_pad // B
    assert lay.plan.route == "window" and Wr & (Wr - 1) == 0
    assert Wr // 2 < 2 * K + 2 * B <= Wr
    assert meta.shape == (NB, lay.plan.G32, 2) and (blk % 32 == 0).all()
    assert int(np.diff(blk).max()) == lay.plan.nmax
    assert blk[-1] == len(idx) == len(w) >= len(tw)
    for rb in range(NB):
        b = rb * B
        rows = meta[rb, :, 0]
        assert sorted(rows[rows >= 0].tolist()) == list(range(B))
        degs = np.diff(toff)[b + np.maximum(rows, 0)] * (rows >= 0)
        assert (np.diff(degs[:B]) <= 0).all()        # by tap count
        for t in range(lay.plan.G32):
            start, width = meta[rb, t, 1] & 0xFFFFF, meta[rb, t, 1] >> 20
            assert start == meta[rb, t // 32 * 32, 1] % (1 << 20) + t % 32
            assert width == degs[t // 32 * 32: t // 32 * 32 + 32].max()
            if rows[t] < 0:
                continue
            r = b + rows[t]
            pos = blk[rb] + start + 32 * np.arange(width)
            got_w = w[pos]
            slots = idx[pos].astype(np.int64)
            n = toff[r + 1] - toff[r]
            win = np.arange(b - K, b + B + K)
            src = np.array([win[(win % Wr == s) & (win >= 0)][0]
                            for s in slots[:n]], dtype=np.int64)
            _same(src, tcol[toff[r]:toff[r + 1]].astype(np.int64),
                  f"row {r} sources")
            _same(got_w[:n], tw[toff[r]:toff[r + 1]], f"row {r} weights")
            assert np.isinf(got_w[n:]).all() and (slots[n:] == r % Wr).all()


def test_gs_route_follows_the_shapes(meshes):
    """The window route where its ring (2K + 2B rows rounded up to a power
    of 2, int16 slots) and two tap buffers fit a block's 227 KB; the
    wide-band route otherwise, its rows in shared memory where 2B values
    fit and in global memory where they do not: no shape is refused.  At
    the production Delaunay annulus's RCM shapes (K = 629: a ring of
    4,096; 5,760 slots the fullest block, widest group 24) the window
    route, 95,744 bytes in float32 and 160,256 in float64; at its natural
    order (K = 35,860) the wide one."""
    plan = pb.gs_plan
    assert plan(512, 629, 5760, 24, 4) == pb.GsPlan(
        "window", 512, 95744, 629, 4096, 512, 5760)
    assert plan(512, 629, 5760, 24, 8).smem == 160256 == pb.gs_window_smem(
        4096, 512, 512, 5760, 8)
    assert plan(512, 35860, 5760, 24, 4) == pb.GsPlan("wide", 512, 4096)
    assert plan(16384, 10, 64, 1, 8) == pb.GsPlan("wide", 1024, 0)
    assert plan(100, 3, 32, 1, 8) == pb.GsPlan("window", 128,
                                               pb.gs_window_smem(
                                                   256, 100, 128, 32, 8),
                                               3, 256, 128, 32)
    # the tap buffers over the budget, the ring at its int16 limit, a
    # group too wide for the metadata's 11 bits
    assert plan(512, 629, 20000, 24, 8).route == "wide"
    assert plan(512, 15872, 32, 1, 4).route == "window"
    assert plan(512, 15873, 32, 1, 4).route == "wide"
    assert plan(512, 10, 4096 * 32, 2048, 4).route == "wide"
    # the meshes: the routes _gs_route keeps, the layout only for the
    # window (16x6's rows hold up to 207 taps: 78,624 slots a block of
    # 512)
    _, _, pbg = _pair(meshes, "delaunay", "Vp", "float64")
    got = pb._gs_route(pbg, 512)
    assert isinstance(got, pb.GsLayout) and got.plan.route == "window"
    assert pb._gs_route(pbg, 512) is got
    _, _, pbg = _pair(meshes, "16x6", "Vp", "float64")
    assert pb._gs_route(pbg, 512) == pb.GsPlan("wide", 512, 8192)
    # at B = 64 its float32 layout fits (tested above), float64 not
    assert pb._gs_route(pbg, 64) == pb.GsPlan("wide", 64, 1024)
    assert pb.gs_layout(pbg.toff, pbg.tcol, pbg.tw, pbg.n_pad, 512, 320, 8,
                        "cpu") == pb.GsPlan("wide", 512, 8192)


def _gs_window_replay(d, lay, K, forward, P, n_pad, B):
    """gs_window_kernel in NumPy, one field: the ring of Wr rows starts as
    NaN (a read of a slot never loaded shows), rows staged from d one
    block ahead as the kernel stages them, each pass reading only the
    ring through the layout, the new values written back after it; the
    block's rows out at its end."""
    meta, idx, w, blk = (lay.meta.numpy(), lay.idx.numpy().astype(np.int64),
                         lay.w.numpy(), lay.blk.numpy())
    Wr, NB = lay.plan.Wr, n_pad // B
    ring = np.full(Wr, np.nan, dtype=d.dtype)
    out = np.full_like(d, np.nan)

    def stage(lo, hi):
        j = np.arange(max(lo, 0), min(hi, n_pad))
        ring[j % Wr] = d[j]

    rb0 = 0 if forward else NB - 1
    stage(rb0 * B - K, rb0 * B + B + K)
    for q in range(NB):
        rb = q if forward else NB - 1 - q
        b = rb * B
        if q + 1 < NB:
            if forward:
                stage(b + B + K, b + 2 * B + K)
            else:
                stage(b - B - K, b - K)
        rows = meta[rb, :, 0]
        for _ in range(P):
            nxt = {}
            for t in np.flatnonzero(rows >= 0):
                start, width = meta[rb, t, 1] & 0xFFFFF, meta[rb, t, 1] >> 20
                pos = blk[rb] + start + 32 * np.arange(width)
                v = ring[(b + rows[t]) % Wr]
                cand = ring[idx[pos]] + w[pos]
                nxt[rows[t]] = min(v, cand.min()) if width else v
            for r, v in nxt.items():
                ring[(b + r) % Wr] = v
        out[b: b + B] = ring[(b + np.arange(B)) % Wr]
    return out


@pytest.mark.parametrize("name,order,B,P", [("delaunay", "rcm", 512, 2),
                                            ("delaunay", "natural", 256, 3),
                                            ("16x6", "rcm", 64, 2),
                                            ("tiny", "rcm", 512, 0)])
def test_gs_window_replay_equals_twin(meshes, name, order, B, P):
    """The window route's reads (the ring, staged one block ahead, and
    the layout) give banded_gs_reference's floats, both directions (the
    halo merge aside: 16x6's twin runs without its halo here)."""
    pbg, K, lay = _layout_of(meshes, name, order, B)
    pbg = pbg._replace(halo_src=pbg.halo_src[:0], halo_dst=pbg.halo_dst[:0])
    rng = np.random.default_rng(21)
    d = _random_field(rng, 1, pbg.n_pad, pbg.n, np.float32)
    for forward in (True, False):
        want = pb.banded_gs_reference(torch.from_numpy(d), pbg, forward,
                                      block=B, passes=P).numpy()[0]
        got = _gs_window_replay(d[0], lay, K, forward, P, pbg.n_pad, B)
        _same(got, want, f"forward={forward}")
