"""PyTorch port: the staged engines' parts against the JAX package.

The destination-masked stage tables (`masked_stream_tables`, masked
`pack_sweep_tables` and `pack_rsweep_tables`), the halo slot map and the
lane masks equal the JAX package's bit for bit on the 16x6 annulus and
on 24x8 (spacing 150); the level-masked BFM step (`bfm_step_reference`
with a mask, the frontier ANDed with the level) equals the JAX
`_masked_step` step by step and over a whole masked stage (the JAX
`_masked_solve_jit`, same `it`), and a NumPy replay of the masked
frontier pass of csrc/ell_bfm.cu equals it; `solve_stream_staged` gives
the JAX staged stream solve's field bit for bit in its iterations
(float32 and float64); `solve_sweep_staged` the JAX staged sweep's
rounds and field within PALLAS_ATOL (tests/test_torch_sweep.py: the
unstaged engine's tolerance) on a masked stage with the twin merge, on
8x3 (spacing 400), where the JAX interpret-mode sweep compiles
quickest (the stage sequence itself - resets, `it` carried - is the
stream test's code path).  The JAX reference solves run
once per module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JC
from raytracer_tpu.ops import relax as jrelax
from raytracer_tpu.ops import stream_t as jst
from raytracer_tpu.ops import sweep_theta as jsw
from raytracer_tpu.ops.circulant import build_circulant as j_build
from raytracer_tpu.ops.wrapped_t import pack_twrapped_stencil as j_pack
from raytracer_tpu.solvers import bfm as jbfm
from raytracer_tpu.solvers import multiphase as jmp
from raytracer_tpu.solvers import phases as jph
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.ops import relax as prelax
from raytracer_tpu_torch.ops import stream_t as pst
from raytracer_tpu_torch.ops import sweep_theta as psw
from raytracer_tpu_torch.ops.circulant import build_circulant as p_build
from raytracer_tpu_torch.ops.wrapped_t import \
    pack_twrapped_stencil as p_pack
from raytracer_tpu_torch.solvers import multiphase as pmp
from raytracer_tpu_torch.solvers import phases as pph
from jax_mappings import below_the_map_limit  # noqa: F401,E402

PALLAS_ATOL = 1e-4     # tests/test_torch_sweep.py
GRIDS = {"16x6": (16, 6, 200.0), "24x8": (24, 8, 150.0)}
LEVELS = (1, 2, 8, 15)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vp(gr):
    prof = rt.velocity_profile("ak135")
    return rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                                prof.Vp))


def _src(gr, deg=0.0):
    return rt.closest_point(gr, np.deg2rad(deg), rt.R, system="polar")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b, equal_nan=True), what


def _same_tables(jt, pt_, what):
    assert jt._fields == pt_._fields
    for k in jt._fields:
        a, b = getattr(jt, k), getattr(pt_, k)
        if isinstance(a, tuple) and a and hasattr(a[0], "shape"):
            assert len(a) == len(b), f"{what}.{k}"
            for i, (u, v) in enumerate(zip(a, b)):
                _same(u, v, f"{what}.{k}[{i}]")
        elif hasattr(a, "shape"):
            _same(a, b, f"{what}.{k}")
        else:
            assert a == b, f"{what}.{k}"


@pytest.fixture(scope="module", params=sorted(GRIDS))
def layouts(request):
    """Both packages' circulant layouts (band_closure 0) of one grid."""
    nt, nr, spacing = GRIDS[request.param]
    gr, A, halo = rt.init_annulus(nt, nr, spacing=spacing)
    U = _vp(gr)
    jcg = j_build(gr, A, halo, U, dtype=np.float32)
    pcg = p_build(gr, A, halo, U, dtype=np.float32)
    return (gr, A, halo, U, jcg, j_pack(jcg, np.float32, band_closure=0),
            pcg, p_pack(pcg, np.float32, band_closure=0))


def test_halo_slot_map_and_lane_masks_equal_jax(layouts):
    gr, _, halo, _, jcg, jws, pcg, pws = layouts
    _same(jmp._halo_slot_map(jcg, jws, halo),
          pmp._halo_slot_map(pcg, pws, halo), "halo_map")
    assert pmp._halo_slot_map(pcg, pws, np.empty((0, 2), np.int64)) is None
    part = pt.partition_grid(gr)
    for level in range(1, 16):
        m = pt.level_mask(part, level)
        _same(jmp._lane_mask_of(jcg, jws, m), pmp._lane_mask_of(pcg, pws, m),
              f"lane mask of level {level}")
    for k in (2, 7):
        for name in ("_region_mask_above", "_region_mask_below"):
            m = getattr(pph, name)(part, k)
            _same(getattr(jph, name)(rt.partition_grid(gr), k), m, name)


@pytest.mark.parametrize("level", LEVELS)
def test_masked_stream_tables_equal_jax(layouts, level):
    gr, _, _, _, jcg, jws, pcg, pws = layouts
    lane = pmp._lane_mask_of(pcg, pws, pt.level_mask(pt.partition_grid(gr),
                                                     level))
    for cen_on in (True, False):
        jt = jst.masked_stream_tables(jws, lane[: jws.Mp], cen_on,
                                      np.float32)
        ptab = pst.masked_stream_tables(pws, lane[: pws.Mp], cen_on,
                                        np.float32)
        _same_tables(jst.StreamTables(*(np.asarray(a) for a in jt)), ptab,
                     f"level {level} cen_on {cen_on}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("level", LEVELS)
def test_masked_sweep_tables_equal_jax(layouts, level, dtype):
    """Masked sweep and rsweep tables equal the JAX package's, and they
    are not cached: the unmasked tables packed afterwards are the
    unmasked ones."""
    gr, _, _, _, jcg, jws, pcg, pws = layouts
    dt = np.dtype(dtype)
    lane = pmp._lane_mask_of(pcg, pws, pt.level_mask(pt.partition_grid(gr),
                                                     level))
    cen_on = level == 8
    jt, js = jsw.pack_sweep_tables(jws, jcg, dt, slot_mask=lane[: jws.Mp],
                                   cen_on=cen_on)
    ptab, ps = psw.pack_sweep_tables(pws, pcg, dt, slot_mask=lane[: pws.Mp],
                                     cen_on=cen_on)
    _same_tables(psw.SweepTables(*(
        tuple(np.asarray(u) for u in a) if isinstance(a, tuple)
        else np.asarray(a) for a in jt)), ptab, f"sweep level {level}")
    assert js == ps
    (jdn, jup), jr = jsw.pack_rsweep_tables(jws, jcg, dt,
                                            slot_mask=lane[: jws.Mp])
    (pdn, pup), pr = psw.pack_rsweep_tables(pws, pcg, dt,
                                            slot_mask=lane[: pws.Mp])
    _same(jdn, pdn, "wtab_dn")
    _same(jup, pup, "wtab_up")
    assert jr == pr
    assert "sweep_tables" not in pws.dcache or \
        pws.dcache["sweep_tables"][0].fan_w is not ptab.fan_w
    full, _ = psw.pack_sweep_tables(pws, pcg, dt)
    (fdn, _), _ = psw.pack_rsweep_tables(pws, pcg, dt)
    jfull, _ = jsw.pack_sweep_tables(jws, jcg, dt)
    (jfdn, _), _ = jsw.pack_rsweep_tables(jws, jcg, dt)
    _same(np.asarray(jfull.cfp), full.cfp, "unmasked cfp")
    _same(np.asarray(jfdn), fdn, "unmasked wtab_dn")
    if level == 1 and dtype == "float32":
        # level 1 leaves whole 8-row blocks without a finite tap
        for upward, w in ((False, pdn), (True, pup)):
            plan = psw.plan_rsweep(w, pr, upward)
            assert (plan.binfo[:, 1] == 0).any()
            assert plan.ent_cap >= 1


# ----------------------------------------------------------------------
# the level-masked BFM step
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ell16():
    gr, A, halo = rt.init_annulus(16, 6, spacing=200.0)
    U = _vp(gr)
    return gr, A, halo, U


def _masks(gr, n_pad, level):
    m = np.zeros(n_pad, bool)
    m[: gr.nnods] = pt.level_mask(pt.partition_grid(gr), level)
    return m


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_masked_step_equals_jax_step_by_step_and_stage(ell16, dtype):
    """Level 1 from the surface source, then level 15 restarted from
    the best Boundary_1 node as bfm_ms does: every step's dist, prev and
    frontier equal to the JAX `_masked_step`, and the whole stage equal
    to `_masked_solve_jit` with the same `it`."""
    gr, A, halo, U = ell16
    jg = jbfm.prepare(A, halo, gr, U, JC(dtype=dtype))
    pg = pt.prepare(A, halo, gr, U, PC(dtype=dtype), device="cpu")
    n_pad = pg.nbr.shape[0]
    m1 = _masks(gr, n_pad, 1)
    src = _src(gr)
    js = jrelax.init_state(jg, jnp.asarray(src, jnp.int32), jnp.dtype(dtype))
    js = js._replace(front=js.front & jnp.asarray(m1))
    ps = prelax.init_state(pg, src, dtype, mask=torch.from_numpy(m1))
    _same(np.asarray(js.front), ps.front.numpy(), "init front")
    steps = 0
    # jitted as the JAX package runs it (inside `_masked_solve_jit`);
    # eager, each JAX op compiles on its first call
    step = jax.jit(jmp._masked_step)
    while bool(np.asarray(js.front).any()):
        js = step(js, jg, jnp.asarray(m1))
        ps = prelax.bfm_step_reference(ps, pg, mask=torch.from_numpy(m1))
        steps += 1
        for f in ("dist", "prev", "front"):
            _same(np.asarray(getattr(js, f)), getattr(ps, f).numpy(),
                  f"{f} step {steps}")
        assert int(ps.live) == int(np.asarray(js.front).any())
    assert steps > 2 and int(ps.it) == int(js.it) == steps
    # a whole stage, restarted at level 15 as bfm_ms restarts it
    m15 = _masks(gr, n_pad, 15)
    dist = ps.dist.clone()
    b1 = np.flatnonzero(pt.partition_grid(gr).boundary_of == 1)
    new = int(b1[np.argmin(dist.numpy()[b1])])
    keep = np.zeros(n_pad, bool)
    keep[b1] = True
    dist[torch.from_numpy(~keep)] = float("inf")
    front = prelax.init_state(pg, new, dtype).front
    want = jmp._masked_solve_jit(jg, jnp.asarray(dist.numpy()),
                                 jnp.asarray(ps.prev.numpy()),
                                 jnp.asarray(front.numpy()),
                                 jnp.asarray(m15), 10_000, dtype)
    got = pmp.masked_solve(pg, dist, ps.prev, front, torch.from_numpy(m15),
                           10_000)
    for f in ("dist", "prev", "front"):
        _same(np.asarray(getattr(want, f)), getattr(got, f).numpy(), f)
    assert int(got.it) == int(want.it) > 2
    cut = pmp.masked_solve(pg, dist, ps.prev, front, torch.from_numpy(m15),
                           2)
    assert int(cut.it) == 2


def test_masked_frontier_replay_equals_twin(ell16):
    """csrc/ell_bfm.cu's frontier pass with a mask, replayed row by row:
    a row outside the level is never in the frontier and skips its
    scan; a row inside takes improved[i] or improved[nbr[i, :deg[i]]]."""
    gr, A, halo, U = ell16
    pg = pt.prepare(A, halo, gr, U, PC(dtype="float32"), device="cpu")
    n_pad = pg.nbr.shape[0]
    mask = _masks(gr, n_pad, 2)
    mt = torch.from_numpy(mask)
    st = prelax.init_state(pg, [_src(gr), _src(gr, 200.0)], "float32",
                           mask=mt)
    nbr, deg = pg.nbr.numpy(), pg.deg.numpy()
    for _ in range(5):
        want = prelax.bfm_step_reference(st, pg, mask=mt)
        imp = want.dist.numpy() < st.dist.numpy()
        f1 = np.zeros_like(imp)
        for b in range(imp.shape[0]):
            for i in range(n_pad):
                if mask[i]:
                    f1[b, i] = imp[b, i] or imp[b, nbr[i, : deg[i]]].any()
        _same(f1, want.front.numpy(), "masked front")
        assert int(want.live) == int(f1.any())
        st = want


def test_mask_is_checked(ell16):
    gr, A, halo, U = ell16
    pg = pt.prepare(A, halo, gr, U, PC(dtype="float32"), device="cpu")
    st = prelax.init_state(pg, 3, "float32")
    n_pad = pg.nbr.shape[0]
    for bad in (torch.ones(n_pad - 1, dtype=torch.bool),
                torch.ones(n_pad, dtype=torch.uint8)):
        with pytest.raises(ValueError, match="mask"):
            prelax.bfm_step(st, pg, mask=bad)
        with pytest.raises(ValueError, match="mask"):
            prelax.init_state(pg, 3, "float32", mask=bad)


# ----------------------------------------------------------------------
# the staged solves
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_stream_staged_equals_jax(ell16, dtype):
    """bfm_ms's two stages (level 1, then level 15 restarted at
    Boundary_1, the unmasked twin merge in both) from one surface and
    one mid-mantle source: the JAX package's field bit for bit in the
    same iterations."""
    gr, A, halo, U = ell16
    dt = np.dtype(dtype)
    part = pt.partition_grid(gr)
    jcg = j_build(gr, A, halo, U, dtype=dt)
    jws = j_pack(jcg, dt, band_closure=0)
    _, jstatic = jst._stream_tables(jws, dt)
    jstages = jmp._ms_stages(jcg, jws, jstatic, halo,
                             rt.partition_grid(gr), (1, 15), dt)
    pcg = p_build(gr, A, halo, U, dtype=dt)
    pws = p_pack(pcg, dt, band_closure=0)
    pstages = pmp._ms_stages(pcg, pws, halo, part, (1, 15), dt)
    for sp_j, sp_p in zip(jstages, pstages):
        _same(sp_j.sel_mask, sp_p.sel_mask, "sel")
        _same(sp_j.halo_map, sp_p.halo_map, "halo_map")
    cfg_j, cfg_p = JC(dtype=dtype), PC(dtype=dtype)
    its = []
    for src in (_src(gr), rt.closest_point(gr, np.deg2rad(100.0), 5000.0,
                                           system="polar")):
        want, it_j = jst.solve_stream_staged(jcg, jws, jstages, [src], cfg_j,
                                             interpret=True)
        got, it_p = pst.solve_stream_staged(pcg, pws, pstages, [src], cfg_p,
                                            device="cpu")
        _same(want, got, f"staged stream field from {src}")
        assert it_p == it_j
        its.append(it_p)
    # the mid-mantle source lies outside both levels: one iteration a
    # stage, nothing in the level improves
    assert its[0] > 2 and its[1] == 2
    # a stage list uploaded once is kept as it is
    dev = [pst.stage_to_device(sp, "cpu") for sp in pstages]
    again = pst.stage_to_device(dev[1], "cpu")
    assert again.tables.cfp is dev[1].tables.cfp
    assert again.reset_keep is dev[1].reset_keep


@pytest.fixture(scope="module")
def region8x3():
    """The JAX staged sweep of the region above the CMB (PcP's down leg)
    on 8x3 (spacing 400): a destination-masked stage with the twin
    merge; field and rounds."""
    gr, A, halo = rt.init_annulus(8, 3, spacing=400.0)
    U = _vp(gr)
    src = _src(gr)
    cfg = JC(dtype="float32")
    setup = jph._phase_setup(A, halo, gr, U, 7, cfg, engine="sweep")
    cg, ws, static, tables, lane, keep, halo_map = setup
    stages = jph._phase_stages(static, tables, lane, keep, halo_map,
                               "sweep", reflected=False)
    d, it = jsw.solve_sweep_staged(cg, ws, stages, [src], cfg,
                                   interpret=True)
    return gr, A, halo, U, src, d[0], it


def test_solve_sweep_staged_equals_jax(region8x3):
    gr, A, halo, U, src, want, it_j = region8x3
    reuse = {}
    cg, ws, down, up = pph._phase_setup(A, halo, gr, U, 7,
                                        PC(dtype="float32"), reuse,
                                        "sweep", torch.device("cpu"))
    got, it_p = psw.solve_sweep_staged(cg, ws, [down], [src],
                                       PC(dtype="float32"), device="cpu")
    got = got[0]
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=PALLAS_ATOL)
    assert it_p == it_j >= 2
    # the region leg through its entry point, on the setup kept in reuse
    # (the reflected leg shares its tables)
    again = pph.region_travel_times(A, halo, src, gr, U, "cmb",
                                    PC(dtype="float32"), device="cpu",
                                    _reuse=reuse, engine="sweep")
    np.testing.assert_array_equal(again, got)
    assert len(reuse) == 1 and up.wtab_dn is down.wtab_dn
