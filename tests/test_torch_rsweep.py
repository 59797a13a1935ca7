"""PyTorch port: the radial Gauss-Seidel sweep's plain version against the
JAX package's Pallas kernel (interpret mode), bit for bit.

Each candidate is one f32 add followed by a min, so the row-by-row torch
loop must give exactly the floats of the TPU kernel's 8-row
macro-blocks.  The CUDA kernel itself runs only on the card; chip_smoke.py
holds it bit-equal to `rsweep_reference` there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu_torch as pt
from raytracer_tpu.ops import sweep_theta as jsw
from raytracer_tpu_torch import kernels
from raytracer_tpu_torch.ops import sweep_theta as psw
from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil
from jax_mappings import below_the_map_limit  # noqa: F401,E402


def _statics(NTL, NTB, MT=24, K8=16):
    """Hand-made taps with |dm| below and above 8 and dc in -2..2."""
    pairs = [(1, 0), (1, -1), (2, 1), (3, 2), (5, -2), (8, 0), (9, 1),
             (12, -1), (16, 2), (7, -2)]
    taps_dn = tuple((dm, dc, i) for i, (dm, dc) in enumerate(pairs))
    taps_up = tuple((-dm, dc, i) for dm, dc, i in taps_dn)
    j = jsw.RSweepStatic(MT, K8, NTL, NTB, taps_dn, taps_up, 128, 128)
    return j, psw.RSweepStatic(*j)


def _field(rng, S, rst, inf_share=0.5):
    buf = rng.uniform(0.0, 100.0, (S, rst.MT + rst.K8, rst.NTL))
    buf[rng.random(buf.shape) < inf_share] = np.inf
    return buf.astype(np.float32)


def _weights(rng, rows, D, inf_share=0.2):
    w = rng.uniform(0.5, 3.0, (rows, D))
    w[rng.random(w.shape) < inf_share] = np.inf
    return w.astype(np.float32)


def _jax_sweep(buf, wtab, jrst, upward):
    return np.asarray(jsw._rsweep_call(jnp.asarray(buf), jnp.asarray(wtab),
                                       jrst, upward, True))


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("NTL,NTB", [(128, 128), (256, 128)],
                         ids=["one-block", "lane-blocked"])
def test_reference_matches_pallas_handmade(upward, NTL, NTB):
    rng = np.random.default_rng(1 + NTL + NTB + int(upward))
    jrst, prst = _statics(NTL, NTB)
    buf = _field(rng, 2, prst)
    wtab = _weights(rng, prst.MT + prst.K8, 128)
    want = _jax_sweep(buf, wtab, jrst, upward)
    got = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                               torch.from_numpy(wtab), prst, upward)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, buf)  # the sweep did relax something


@pytest.fixture(scope="module")
def real_tables():
    _, cg, _ = pt.init_annulus_circulant(48, 12, 150.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    (wdn, wup), rst = psw.pack_rsweep_tables(ws, cg, np.float32)
    return cg, wdn, wup, rst


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
def test_reference_matches_pallas_real_tables(real_tables, upward):
    cg, wdn, wup, rst = real_tables
    rng = np.random.default_rng(7 + int(upward))
    buf = np.full((2, rst.MT + rst.K8, rst.NTL), np.inf, np.float32)
    off = rst.K8 if upward else 0
    nt = cg.ntheta
    vals = rng.uniform(0.0, 1500.0, (2, rst.MT, nt))
    vals[rng.random(vals.shape) < 0.3] = np.inf
    buf[:, off:off + rst.MT, :nt] = vals
    wtab = wup if upward else wdn
    jrst = jsw.RSweepStatic(*rst)
    want = _jax_sweep(buf, wtab, jrst, upward)
    got = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                               torch.from_numpy(wtab), rst, upward)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
def test_wrapper_on_cpu_takes_plain_path(real_tables, upward):
    """A CPU tensor goes to the plain version, in place, and never
    counts as a kernel launch."""
    cg, wdn, wup, rst = real_tables
    rng = np.random.default_rng(11)
    buf = _field(rng, 1, rst)
    wtab = torch.from_numpy(wup if upward else wdn)
    before = psw.rsweep.launches
    t = torch.from_numpy(buf.copy())
    out = psw.rsweep(t, wtab, rst, upward)
    want = psw.rsweep_reference(torch.from_numpy(buf.copy()), wtab, rst,
                                upward)
    assert out is t                   # updated in place
    assert torch.equal(out, want)
    assert psw.rsweep.launches == before


def test_wrapper_rejects_bad_inputs(real_tables):
    _, wdn, _, rst = real_tables
    good = torch.full((1, rst.MT + rst.K8, rst.NTL), float("inf"))
    w = torch.from_numpy(wdn)
    with pytest.raises(TypeError):
        psw.rsweep(good.double(), w, rst, False)
    with pytest.raises(ValueError):
        psw.rsweep(good[:, :-1], w, rst, False)
    with pytest.raises(ValueError):
        psw.rsweep(good, w[:-1], rst, False)
    with pytest.raises(ValueError):
        psw.rsweep(good.transpose(1, 2).contiguous().transpose(1, 2), w,
                   rst, False)
    meta = torch.empty(good.shape, device="meta")
    with pytest.raises(ValueError):
        psw.rsweep(meta, w.to("meta"), rst, False)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build says so; the library name
    follows the source's hash."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "DEFAULT_CUDA_BIN", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()
    path = kernels.library_path("rsweep")
    assert path.startswith(kernels.BUILD_DIR)
    assert path.endswith(".so") and "librsweep_" in path


def test_kernel_source_interface():
    """The CUDA source exposes the plain C launch function the wrapper
    binds with ctypes, and nothing of PyTorch's C++ extension API."""
    with open(kernels.source_path("rsweep")) as f:
        src = f.read()
    assert 'extern "C" int rsweep_launch(' in src
    assert "cudaGetLastError()" in src
    assert "torch/extension.h" not in src
    assert "_make_rsweep_kernel" in src   # names the TPU kernel it replaces


# ----------------------------------------------------------------------
# the kernel's packed taps (plan_rsweep) and their plain evaluation
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables_180():
    _, cg, _ = pt.init_annulus_circulant(180, 63, 20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    (wdn, wup), rst = psw.pack_rsweep_tables(ws, cg, np.float32)
    return cg, wdn, wup, rst


def _real_field(rng, rst, nt, upward, S=2):
    buf = np.full((S, rst.MT + rst.K8, rst.NTL), np.inf, np.float32)
    vals = rng.uniform(0.0, 1500.0, (S, rst.MT, nt)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = np.inf
    off = rst.K8 if upward else 0
    buf[:, off:off + rst.MT, :nt] = vals
    return buf


def _layouts(rst):
    """The one-block layout, a lane-blocked one and one wide lane block."""
    return {"single": rst, "blocked": rst._replace(NTB=rst.NTL // 2),
            "wide": rst._replace(NTL=1280, NTB=1280)}


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("NTL,NTB", [(128, 128), (256, 128)],
                         ids=["one-block", "lane-blocked"])
def test_packed_reference_equals_reference_handmade(upward, NTL, NTB):
    rng = np.random.default_rng(21 + NTL + NTB + int(upward))
    _, prst = _statics(NTL, NTB)
    buf = _field(rng, 2, prst)
    wtab = _weights(rng, prst.MT + prst.K8, 128)
    plan = psw.plan_rsweep(wtab, prst, upward)
    want = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                                torch.from_numpy(wtab), prst, upward)
    got = psw.rsweep_packed_reference(torch.from_numpy(buf.copy()), plan,
                                      prst, upward)
    assert torch.equal(got, want)
    assert not np.array_equal(want.numpy(), buf)


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("layout", ["single", "blocked"])
def test_packed_reference_equals_reference_180x63(tables_180, upward,
                                                  layout):
    cg, wdn, wup, rst = tables_180
    st = _layouts(rst)[layout]
    wtab = wup if upward else wdn
    buf = _real_field(np.random.default_rng(5 + int(upward)), st,
                      cg.ntheta, upward)
    plan = psw.plan_rsweep(wtab, st, upward)
    want = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                                torch.from_numpy(wtab), st, upward)
    got = psw.rsweep_packed_reference(torch.from_numpy(buf.copy()), plan,
                                      st, upward)
    assert torch.equal(got, want)


def _unpack(plan, rst, upward):
    """{(row, dm, dc): [weights]} of every packed tap: the far entries and
    the finite entries of the near table."""
    B = psw.RSWEEP_BLOCK
    out = {}
    for g, b in enumerate(psw.rsweep_block_rows(rst, upward).tolist()):
        info = plan.binfo[g]
        for j in range(B):
            lo = int(info[0] + info[2 + j])
            for e in range(lo, lo + int(info[2 + B + j])):
                out.setdefault((b + j, int(plan.dm[e]), int(plan.dc[e])),
                               []).append(float(plan.w[e]))
        for u in range(1, B):
            for us in range(u):
                for t in range(5):
                    w = plan.near[g, (us * (B - 1) + u - us - 1) * 5 + t]
                    if np.isfinite(w):
                        j = u if upward else B - 1 - u
                        js = us if upward else B - 1 - us
                        out.setdefault((b + j, js - j, t - 2),
                                       []).append(float(w))
    return out


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("layout", ["single", "wide"])
def test_plan_packs_every_finite_weight_once(tables_180, upward, layout):
    _, wdn, wup, rst = tables_180
    st = _layouts(rst)[layout]
    wtab = wup if upward else wdn
    plan = psw.plan_rsweep(wtab, st, upward)
    assert np.isfinite(plan.w).all()          # no +inf far entry
    assert np.array_equal(plan.ent[:, 1], plan.w.view(np.int32))
    got = _unpack(plan, st, upward)
    want = {}
    first = st.K8 if upward else 0
    for r in range(first, first + st.MT):
        for dm, dc, iw in (st.taps_up if upward else st.taps_dn):
            if np.isfinite(wtab[r, iw]):
                want[(r, dm, dc)] = [float(wtab[r, iw])]
    assert got == want
    # the ring offsets (shared route) or packed taps (global route)
    B, R = psw.RSWEEP_BLOCK, st.K8 + 2 * psw.RSWEEP_BLOCK
    dst = np.concatenate([
        np.repeat(b + np.arange(B),
                  plan.binfo[g, 2 + B:2 + 2 * B])
        for g, b in enumerate(psw.rsweep_block_rows(st, upward).tolist())])
    if plan.shared:
        want_x = ((dst + plan.dm) % R) * (st.NTB + 8) + 4 + plan.dc
    else:
        want_x = plan.dm * 8 + plan.dc + 2
    assert np.array_equal(plan.ent[:, 0], want_x)


def test_plan_route_by_shape(tables_180):
    """The shared-memory ring where K8+16 rows of NTB+8 lanes, two far-tap
    buffers and two near tables fit in 227 KB; device memory otherwise."""
    _, wdn, _, rst = tables_180
    _, cg1080, _ = pt.init_annulus_circulant(1080, 300, 20.0)
    ws = pack_twrapped_stencil(cg1080, dtype=np.float32, band_closure=0)
    (w1080, _), rst1080 = psw.pack_rsweep_tables(ws, cg1080, np.float32)
    assert (rst.MT, rst.K8, rst.NTL, rst.NTB) == (840, 48, 256, 256)
    assert (rst1080.MT, rst1080.K8, rst1080.NTL, rst1080.NTB) == \
        (768, 8, 1152, 1152)
    cases = {"180x63": (wdn, rst, True),
             "180x63 blocked": (wdn, rst._replace(NTB=128), True),
             "1080x300": (w1080, rst1080, True),
             "1080x300 blocked": (w1080, rst1080._replace(NTB=576), True),
             "180x63 taps on 1280 lanes": (
                 wdn, rst._replace(NTL=1280, NTB=1280), False)}
    for name, (w, st, shared) in cases.items():
        plan = psw.plan_rsweep(w, st, False)
        assert plan.shared == shared, name
        assert plan.smem_bytes == psw.rsweep_smem_bytes(st, plan.ent_cap)
        assert (plan.smem_bytes <= kernels.BLOCK_SMEM) == shared, name
        far, near = psw.rsweep_lanes(st.NTB)
        assert (plan.far_lanes, plan.near_lanes) == (far, near)
        assert st.NTB <= plan.threads * plan.near_lanes
    assert [psw.rsweep_lanes(n) for n in (128, 256, 1152, 2560)] == \
        [(2, 1), (4, 1), (4, 2), (4, 4)]
    # the kernel is built for these pairs only
    assert {psw.rsweep_lanes(n) for n in range(128, 4097, 128)} == \
        {(2, 1), (4, 1), (4, 2), (4, 4)}


_HALO = 4


def _replay_shared(buf, plan, rst, upward):
    """csrc/rsweep.cu's shared-memory route replayed phase by phase in
    NumPy: the ring of K8+16 slots with its halo lanes, the copies of
    block g+1 landing at the start of block g, the far pass, the near
    chain pushing each final row's 5-lane window into the later rows, and
    the write-back.  Unset ring lanes are NaN, so a read of one fails."""
    buf = buf.copy()
    S, _, NTL = buf.shape
    MT, K8, NTB, B = rst.MT, rst.K8, rst.NTB, psw.RSWEEP_BLOCK
    R, stride = K8 + 2 * B, NTB + 2 * _HALO
    blocked = NTB < NTL
    starts = psw.rsweep_block_rows(rst, upward)
    c = np.arange(NTB)

    def pos(u):
        return u if upward else B - 1 - u

    for s in range(S):
        for lb in range(NTL // NTB):
            field = buf[s, :, lb * NTB:(lb + 1) * NTB]
            ring = np.full(R * stride, np.nan, np.float32)
            for row in range(R):
                ring[row * stride:row * stride + _HALO] = np.inf
                ring[row * stride + _HALO + NTB:(row + 1) * stride] = np.inf

            def load(r):
                base = (r % R) * stride + _HALO
                ring[base:base + NTB] = field[r]

            def put(base, v):
                ring[base:base + NTB] = v
                if not blocked:
                    ring[base + NTB:base + NTB + 2] = v[:2]
                    ring[base - 2:base] = v[NTB - 2:]

            for r in range(starts[0], starts[0] + B):
                load(r)
            for r in range(0 if upward else MT, (0 if upward else MT) + K8):
                load(r)
            if not blocked:
                for row in range(R):
                    base = row * stride + _HALO
                    ring[base - 2:base] = ring[base + NTB - 2:base + NTB]
                    ring[base + NTB:base + NTB + 2] = ring[base:base + 2]
            for g, b in enumerate(starts.tolist()):
                if g + 1 < len(starts):
                    for r in range(starts[g + 1], starts[g + 1] + B):
                        load(r)
                info, slot0 = plan.binfo[g], b % R
                for j in range(B):
                    base = (slot0 + j) * stride + _HALO
                    v = ring[base:base + NTB].copy()
                    lo = int(info[0] + info[2 + j])
                    for x, wb in plan.ent[lo:lo + int(info[2 + B + j])]:
                        src = ring[x + c]
                        assert not np.isnan(src).any()
                        v = np.minimum(v, src + np.int32(wb).view(np.float32))
                    put(base, v)
                v = [ring[(slot0 + pos(u)) * stride + _HALO:][:NTB].copy()
                     for u in range(B)]
                for u in range(B - 1):
                    base = (slot0 + pos(u)) * stride + _HALO
                    if u > 0:
                        put(base, v[u])
                    win = [ring[base + c + t - 2] for t in range(5)]
                    for d in range(1, B - u):
                        for t in range(5):
                            w = plan.near[g, (u * (B - 1) + d - 1) * 5 + t]
                            v[u + d] = np.minimum(v[u + d], win[t] + w)
                put((slot0 + pos(B - 1)) * stride + _HALO, v[B - 1])
                for u in range(B):
                    field[b + pos(u)] = v[u]
    return buf


def _replay_global(buf, plan, rst, upward):
    """The device-memory route replayed in NumPy: far taps decoded from
    (dm << 3) | (dc + 2), the near chain pulled from the near table."""
    buf = buf.copy()
    S, _, NTL = buf.shape
    NTB, B = rst.NTB, psw.RSWEEP_BLOCK
    blocked = NTB < NTL
    c = np.arange(NTB)

    def shifted(row, dc):
        sl = c + dc
        out = row[sl % NTB]
        return np.where((sl < 0) | (sl >= NTB), np.inf, out) if blocked \
            else out

    def pos(u):
        return u if upward else B - 1 - u

    for s in range(S):
        for lb in range(NTL // NTB):
            field = buf[s, :, lb * NTB:(lb + 1) * NTB]
            for g, b in enumerate(psw.rsweep_block_rows(rst, upward)):
                info = plan.binfo[g]
                for j in range(B):
                    lo = int(info[0] + info[2 + j])
                    for x, wb in plan.ent[lo:lo + int(info[2 + B + j])]:
                        field[b + j] = np.minimum(
                            field[b + j], shifted(field[b + j + (x >> 3)],
                                                  (x & 7) - 2)
                            + np.int32(wb).view(np.float32))
                for u in range(1, B):
                    r = b + pos(u)
                    for us in range(u):
                        for t in range(5):
                            w = plan.near[g, (us * (B - 1) + u - us - 1) * 5
                                          + t]
                            field[r] = np.minimum(
                                field[r], shifted(field[b + pos(us)], t - 2)
                                + w)
    return buf


@pytest.mark.parametrize("upward", [False, True], ids=["down", "up"])
@pytest.mark.parametrize("layout", ["single", "blocked", "wide"])
def test_kernel_indexing_replayed_in_numpy(tables_180, upward, layout):
    """What the kernel reads and where, replayed on the host at 180x63:
    the shared-memory route for one lane block and for two, the
    device-memory route for one 1,280-lane block."""
    cg, wdn, wup, rst = tables_180
    st = _layouts(rst)[layout]
    wtab = wup if upward else wdn
    plan = psw.plan_rsweep(wtab, st, upward)
    assert plan.shared == (layout != "wide")
    buf = _real_field(np.random.default_rng(9 + int(upward)), st,
                      cg.ntheta, upward, S=1)
    want = psw.rsweep_reference(torch.from_numpy(buf.copy()),
                                torch.from_numpy(wtab), st, upward).numpy()
    replay = _replay_shared if plan.shared else _replay_global
    assert np.array_equal(replay(buf, plan, st, upward), want)


def test_kernel_tables_are_packed_once_per_table(tables_180):
    """The wrapper's packed taps live on the weight tensor: the same
    arrays on a second call, packed again after an in-place change."""
    _, wdn, _, rst = tables_180
    w = torch.from_numpy(wdn.copy())
    first = psw._kernel_tables(w, rst, False)
    assert psw._kernel_tables(w, rst, False)[1] is first[1]
    blocked = psw._kernel_tables(w, rst._replace(NTB=128), False)
    assert blocked[1] is not first[1]
    r, iw = np.argwhere(np.isfinite(wdn[:rst.MT, :len(rst.taps_dn)]))[0]
    w[r, iw] = float("inf")
    again = psw._kernel_tables(w, rst, False)
    assert again[1] is not first[1]
    assert len(again[0].ent) + int(np.isfinite(
        again[0].near).sum()) < len(first[0].ent) + int(np.isfinite(
            first[0].near).sum())
