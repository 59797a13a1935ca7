"""PyTorch port: bfm_ms and bfm_multiphase against the JAX package.

On the 16x6 annulus (tests/conftest.py's tiny_annulus, AK135 Vp): the
ELL path's dist and prev equal the JAX package's bit for bit (float32
and float64, the default levels (1, 15) and a single level from 45
degrees; bfm_multiphase with its boundary velocity swaps); the staged
stream path gives the JAX staged stream solve's field bit for bit in
the same iterations, and the same recovered prev; a reuse dict keeps one
staged setup for each velocity table and dtype; the staged sweep path
is held to the JAX ELL result at the JAX package's own tolerance
(tests/test_multiphase.py: same finite set, rtol 1e-5, atol 5e-3 s),
the JAX staged sweep itself being pinned in tests/test_torch_staged.py
and at 180x63 by chip_smoke.py.  The helpers (directions,
boundary_velocity, find_new_source_min) equal the JAX package's.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JC
from raytracer_tpu.ops import stream_t as jst
from raytracer_tpu.ops.circulant import build_circulant as j_build
from raytracer_tpu.ops.wrapped_t import pack_twrapped_stencil as j_pack
from raytracer_tpu.solvers import multiphase as jmp
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.solvers import multiphase as pmp
from jax_mappings import below_the_map_limit  # noqa: F401,E402

F32J, F32P = JC(dtype="float32"), PC(dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what}: {int((a != b).sum())} differ"


def _src(gr, deg=0.0):
    return rt.closest_point(gr, np.deg2rad(deg), rt.R, system="polar")


@pytest.fixture(scope="module")
def tiny(tiny_annulus, tiny_velocity):
    gr, A, halo = tiny_annulus
    prof = rt.velocity_profile()
    interp = rt.LinearInterpolation(prof.r, prof.Vp)
    return gr, A, halo, tiny_velocity, interp


def test_helpers_equal_jax(tiny):
    gr, A, halo, U, interp = tiny
    for n in (3, 8):
        assert pmp.directions(n) == jmp.directions(n)
    rb = rt.DISCONTINUITY_RADII[3]
    for way in ("above", "below"):
        _same(jmp.boundary_velocity(U, interp, rb, np.array([2, 30]), way),
              pmp.boundary_velocity(U, interp, rb, np.array([2, 30]), way),
              way)
    D = rt.bfm(A, halo, _src(gr), gr, U, JC(dtype="float64"))
    jp, pp = rt.partition_grid(gr), pt.partition_grid(gr)
    for b in ("Boundary_1", "Boundary_7"):
        assert pmp.find_new_source_min(D.dist, pp, b) == \
            jmp.find_new_source_min(D.dist, jp, b)
    with pytest.raises(ValueError, match="method"):
        pmp.bfm_ms(A, halo, _src(gr), gr, U, F32P, method="wrapped",
                   device="cpu")


def test_entry_points_take_the_jax_parameters():
    """The staged entry points take the JAX package's parameters in its
    order, `device` where the JAX function takes `interpret`."""
    import inspect

    from raytracer_tpu.solvers import phases as jph
    from raytracer_tpu_torch.solvers import phases as pph

    for jmod, pmod, names in ((jmp, pmp, ("bfm_ms", "bfm_multiphase")),
                              (jph, pph, ("region_travel_times",
                                          "reflected_travel_times",
                                          "converted_travel_times",
                                          "depth_phase_travel_times",
                                          "phase_travel_times"))):
        for name in names:
            want = ["device" if p == "interpret" else p for p in
                    inspect.signature(getattr(jmod, name)).parameters]
            got = list(inspect.signature(getattr(pmod, name)).parameters)
            assert got == want, name
    assert pt.bfm_ms is pmp.bfm_ms and pt.phase_travel_times is \
        pph.phase_travel_times


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bfm_ms_ell_equals_jax(tiny, dtype):
    gr, A, halo, U, _ = tiny
    for deg, levels in ((0.0, None), (45.0, (1,))):
        src = _src(gr, deg)
        want = jmp.bfm_ms(A, halo, src, gr, U, JC(dtype=dtype),
                          levels=levels)
        got = pmp.bfm_ms(A, halo, src, gr, U, PC(dtype=dtype),
                         levels=levels, device="cpu")
        _same(want.dist, got.dist, f"dist {deg} {levels}")
        _same(want.prev, got.prev, f"prev {deg} {levels}")
        assert np.isfinite(got.dist).sum() > 50


def test_bfm_ms_ell_reuses_its_graph_and_levels(tiny):
    """A second solve through one reuse dict takes the prepared graph and
    the level masks from it (the same objects) and gives the same field;
    another velocity table gets a graph of its own."""
    gr, A, halo, U, _ = tiny
    reuse = {}
    a = pmp.bfm_ms(A, halo, _src(gr), gr, U, F32P, device="cpu",
                   _reuse=reuse)
    kept = dict(reuse)
    assert sorted(k[0] for k in kept) == ["ms_ell_graph", "ms_ell_levels"]
    b = pmp.bfm_ms(A, halo, _src(gr), gr, U, F32P, device="cpu",
                   _reuse=reuse)
    assert reuse.keys() == kept.keys()
    assert all(reuse[k] is kept[k] for k in kept)
    _same(a.dist, b.dist, "dist")
    _same(a.prev, b.prev, "prev")
    pmp.bfm_ms(A, halo, _src(gr), gr, 1.1 * U, F32P, device="cpu",
               _reuse=reuse)
    assert sum(k[0] == "ms_ell_graph" for k in reuse) == 2


@pytest.mark.parametrize("method", ["stream", "sweep"])
def test_staged_reuse_keys_carry_velocity_and_dtype(tiny, method):
    """bfm_ms on the staged engines through one reuse dict: on U, then
    on a faster table, then in float64.  The dict holds three setups, the
    faster table gives earlier times, the float64 solve a float64 field;
    on the stream engine each later solve equals a fresh one."""
    gr, A, halo, U, _ = tiny
    src = _src(gr)
    reuse = {}
    runs = [(U, F32P), (1.1 * U, F32P), (U, PC(dtype="float64"))]
    got = [pmp.bfm_ms(A, halo, src, gr, u, c, method=method, device="cpu",
                      want_prev=False, _reuse=reuse).dist for u, c in runs]
    assert len(reuse) == 3
    ok = np.isfinite(got[0]) & (got[0] > 0)
    assert ok.sum() > 50 and np.all(got[1][ok] < got[0][ok])
    assert got[2].dtype == np.float64
    if method == "stream":
        # each equal to a fresh solve (the sweep's plain twin takes ~0.5
        # s a solve here; its setup key is the same line)
        for (u, c), g in list(zip(runs, got))[1:]:
            fresh = pmp.bfm_ms(A, halo, src, gr, u, c, method=method,
                               device="cpu", want_prev=False).dist
            _same(fresh, g, f"{method} {c.dtype}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bfm_multiphase_ell_equals_jax(tiny, dtype):
    gr, A, _, U, interp = tiny
    src = _src(gr)
    want = jmp.bfm_multiphase(A, src, gr, U, interpolant=interp,
                              config=JC(dtype=dtype))
    got = pmp.bfm_multiphase(A, src, gr, U, interpolant=interp,
                             config=PC(dtype=dtype), device="cpu")
    _same(want.dist, got.dist, "dist")
    _same(want.prev, got.prev, "prev")
    assert got.dist[src] == 0.0


def test_bfm_ms_stream_equals_jax(tiny):
    """The staged stream field bit for bit in the JAX package's
    iterations, and the same recovered prev through the public entry
    point (its _reuse keeps the stages on the device)."""
    gr, A, halo, U, _ = tiny
    src = _src(gr)
    dt = np.dtype("float32")
    cg = j_build(gr, A, halo, U, dtype=dt)
    ws = j_pack(cg, dt, band_closure=0)
    _, static = jst._stream_tables(ws, dt)
    stages = jmp._ms_stages(cg, ws, static, halo, rt.partition_grid(gr),
                            (1, 15), dt)
    want, it_j = jst.solve_stream_staged(cg, ws, stages, [src], F32J,
                                         interpret=True)
    reuse = {}
    got, it_p, _, _ = pmp.bfm_ms_staged(A, halo, src, gr, U, F32P,
                                        method="stream", device="cpu",
                                        _reuse=reuse)
    _same(want[0], got, "dist")
    assert it_p == it_j > 2
    D_p = pmp.bfm_ms(A, halo, src, gr, U, F32P, method="stream",
                     device="cpu", _reuse=reuse)
    assert len(reuse) == 1
    _same(want[0], D_p.dist, "dist")
    _same(_jax_prev(cg, want[0], src), D_p.prev, "prev")


def _jax_prev(cg, dist, src):
    """The prev that the JAX package's staged bfm_ms and bfm_multiphase
    return with a field: recovered over the circulant stencil, the
    source its own predecessor."""
    from raytracer_tpu.ops.circulant import recover_prev_device

    prev = recover_prev_device(cg, dist)
    prev[src] = src
    return prev


def _jax_multiphase_stream_it(A, src, gr, U, interp):
    """The JAX package's _bfm_multiphase_stream, its iteration count
    kept: (dist, iterations, prev)."""
    from raytracer_tpu.solvers.multiphase import (_boundary_nodes,
                                                  _lane_mask_of,
                                                  boundary_velocity,
                                                  directions)

    part = rt.partition_grid(gr)
    bnodes = _boundary_nodes(gr, part)
    ray_dir = directions(part.nlayers)
    bdict = dict(zip(part.boundaries, part.rboundaries))
    U = np.asarray(U, dtype=np.float64).copy()
    dt = np.dtype("float32")
    stages, first = [], None
    for i in range(1, 4):
        cur = part.iterator[i][1:]
        for b in cur:
            U = boundary_velocity(U, interp, bdict[b], bnodes[b],
                                  ray_dir[i][0 if b == cur[0] else 1])
        cg = j_build(gr, A, np.empty((0, 2), np.int64), U, dtype=dt)
        ws = j_pack(cg, dt, band_closure=0)
        _, static = jst._stream_tables(ws, dt)
        first = first or (cg, ws)
        nmask = rt.level_mask(part, i)
        lane = _lane_mask_of(cg, ws, nmask)
        cen_on = cg.cmap.center >= 0 and bool(nmask[cg.cmap.center])
        stages.append(jst.StageSpec(
            tables=jst.masked_stream_tables(ws, lane[: ws.Mp], cen_on, dt),
            static=static, sel_mask=lane))
    d, it = jst.solve_stream_staged(first[0], first[1], stages, [src],
                                    F32J, interpret=True)
    return d[0], it, _jax_prev(first[0], d[0], src)


def test_bfm_multiphase_stream_equals_jax(tiny):
    gr, A, _, U, interp = tiny
    src = _src(gr)
    want, it_j, prev_j = _jax_multiphase_stream_it(A, src, gr, U, interp)
    got, it_p, _ = pmp.bfm_multiphase_staged(A, src, gr, U,
                                             interpolant=interp,
                                             config=F32P, method="stream",
                                             device="cpu")
    _same(want, got, "dist")
    assert it_p == it_j > 3
    D_p = pmp.bfm_multiphase(A, src, gr, U, interpolant=interp, config=F32P,
                             method="stream", device="cpu")
    _same(want, D_p.dist, "dist")
    _same(prev_j, D_p.prev, "prev")


@pytest.fixture(scope="module")
def ell_ref(tiny):
    """The JAX ELL references of the sweep tests."""
    gr, A, halo, U, interp = tiny
    src = _src(gr)
    return (jmp.bfm_ms(A, halo, src, gr, U, F32J).dist,
            jmp.bfm_multiphase(A, src, gr, U, interpolant=interp,
                               config=F32J).dist)


@pytest.mark.parametrize("which", ["bfm_ms", "bfm_multiphase"])
def test_sweep_matches_jax_ell(tiny, ell_ref, which):
    gr, A, halo, U, interp = tiny
    src = _src(gr)
    if which == "bfm_ms":
        want = ell_ref[0]
        got = pmp.bfm_ms(A, halo, src, gr, U, F32P, method="sweep",
                         device="cpu").dist
    else:
        want = ell_ref[1]
        got = pmp.bfm_multiphase(A, src, gr, U, interpolant=interp,
                                 config=F32P, method="sweep",
                                 device="cpu").dist
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=5e-3)
