"""PyTorch port: host grid and table builders equal the JAX package's.

The port keeps its own copies of the NumPy builders (it must import
nothing of the JAX package); these tests hold every copy equal, bit for
bit and dtype for dtype, to the original at a small grid and at the
180x63 main-path grid.
"""
import os

import numpy as np
import pytest

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.ops import sweep_theta as jsw
from raytracer_tpu.ops.circulant import build_circulant as j_build
from raytracer_tpu.models import velocity as jvel
from raytracer_tpu.ops import diag_circulant as jdc
from raytracer_tpu.ops import diag_wrapped as jdw
from raytracer_tpu.ops.diag_circulant import decompose_diagonals as j_decomp
from raytracer_tpu.ops.wrapped_t import pack_twrapped_stencil as j_pack
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.models import velocity as pvel
from raytracer_tpu_torch.ops import diag_circulant as pdc
from raytracer_tpu_torch.ops import diag_wrapped as pdw
from raytracer_tpu_torch.ops import sweep_theta as psw
from raytracer_tpu_torch.ops.diag_circulant import \
    decompose_diagonals as p_decomp
from raytracer_tpu_torch.ops.wrapped_t import \
    pack_twrapped_stencil as p_pack
from jax_mappings import below_the_map_limit  # noqa: F401,E402

SIZES = {"48x12": (48, 12, 150.0), "180x63": (180, 63, 20.0)}


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b, equal_nan=True), what


def _same_tuple(x, y, what):
    assert type(x).__name__ == type(y).__name__
    assert x._fields == y._fields, what
    for k in x._fields:
        a, b = getattr(x, k), getattr(y, k)
        if isinstance(a, tuple) and a and hasattr(a[0], "shape"):
            assert len(a) == len(b), f"{what}.{k}"
            for i, (u, v) in enumerate(zip(a, b)):
                _same(u, v, f"{what}.{k}[{i}]")
        elif hasattr(a, "shape"):
            _same(a, b, f"{what}.{k}")
        else:
            assert a == b, f"{what}.{k}"


@pytest.fixture(scope="module", params=sorted(SIZES))
def both(request):
    nt, nr, spacing = SIZES[request.param]
    j = rt.init_annulus_circulant(nt, nr, spacing)
    p = pt.init_annulus_circulant(nt, nr, spacing)
    jws = j_pack(j[1], dtype=np.float32, band_closure=0)
    pws = p_pack(p[1], dtype=np.float32, band_closure=0)
    return j, p, jws, pws


def test_velocity_profile_and_sampling():
    r = np.linspace(0.0, 6371.0, 1001)
    r = np.concatenate([r, np.asarray(rt.DISCONTINUITY_RADII)])
    jp, pp = rt.velocity_profile("ak135"), pt.velocity_profile("ak135")
    for k in ("r", "Vp", "Vs"):
        _same(getattr(jp, k), getattr(pp, k), k)
    ji = rt.LinearInterpolation(jp.r, jp.Vp)
    pi = pt.LinearInterpolation(pp.r, pp.Vp)
    _same(rt.interpolate_velocity(r, ji), pt.interpolate_velocity(r, pi), "U")


@pytest.mark.parametrize("model", sorted(jvel._PROFILE_FILES))
def test_velocity_tables_are_copies(model):
    """Every table the JAX package loads is in the port's own data
    directory, byte for byte, under the same model name."""
    assert pvel._PROFILE_FILES[model] == jvel._PROFILE_FILES[model]
    fname = jvel._PROFILE_FILES[model]
    with open(os.path.join(jvel._DATA_DIR, fname), "rb") as f:
        want = f.read()
    with open(os.path.join(pvel._DATA_DIR, fname), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("model", ["ak135", "iasp91", "ak135-true",
                                   "AK135-True"])
def test_velocity_profile_every_model(model):
    jp, pp = rt.velocity_profile(model), pt.velocity_profile(model)
    for k in ("r", "Vp", "Vs"):
        _same(getattr(jp, k), getattr(pp, k), f"{model}.{k}")


def test_solver_config_tol():
    for dt in ("float32", "float64"):
        assert (pt.SolverConfig(dtype=dt).tol_value()
                == rt.SolverConfig(dtype=dt).tol_value())
    assert pt.SolverConfig(tol=0.5).tol_value() == 0.5


def test_init_annulus_circulant_grid(both):
    (jgr, _, jU), (pgr, _, pU), _, _ = both
    for k in ("x", "z", "theta", "r", "twin_class"):
        _same(getattr(jgr, k), getattr(pgr, k), k)
    assert (jgr.ntheta, jgr.nr, jgr.nnods) == (pgr.ntheta, pgr.nr, pgr.nnods)
    _same(jU, pU, "U")


def test_init_annulus_circulant_stencil(both):
    (_, jcg, _), (_, pcg, _), _, _ = both
    for k in ("src_flat", "w", "fan_slots", "fan_w"):
        _same(getattr(jcg, k), getattr(pcg, k), k)
    assert jcg.n == pcg.n
    for k in ("c_of", "m_of", "node_of"):
        _same(getattr(jcg.cmap, k), getattr(pcg.cmap, k), k)
    assert (jcg.cmap.center, jcg.cmap.M, jcg.cmap.ntheta) == \
        (pcg.cmap.center, pcg.cmap.M, pcg.cmap.ntheta)


def test_decompose_diagonals(both):
    (_, jcg, _), (_, pcg, _), _, _ = both
    _same_tuple(j_decomp(jcg), p_decomp(pcg), "dec")


@pytest.mark.parametrize("band_closure", [0, 1])
def test_pack_twrapped_stencil(both, band_closure):
    (_, jcg, _), (_, pcg, _), jws, pws = both
    if band_closure:
        jws = j_pack(jcg, dtype=np.float32, band_closure=band_closure)
        pws = p_pack(pcg, dtype=np.float32, band_closure=band_closure)
    for k in ("wrows", "ring_f", "ring_b", "cfl", "cbl", "fan_w"):
        _same(getattr(jws, k), getattr(pws, k), k)
    for k in ("maxdm", "Mp", "ML", "M", "nt", "NTT"):
        assert getattr(jws, k) == getattr(pws, k), k


@pytest.mark.parametrize("vertical_closure", [0, 2])
def test_pack_wrapped_stencil(both, vertical_closure):
    (_, jcg, _), (_, pcg, _), _, _ = both
    j = jdw.pack_wrapped_stencil(jcg, dtype=np.float32,
                                 vertical_closure=vertical_closure)
    p = pdw.pack_wrapped_stencil(pcg, dtype=np.float32,
                                 vertical_closure=vertical_closure)
    for k in ("offs", "wp", "wpT", "ring_f", "ring_b", "cfl", "cbl",
              "fan_w"):
        _same(getattr(j, k), getattr(p, k), k)
    for k in ("rho_starts", "pad2", "D", "Mp", "M", "nt", "NTL"):
        assert getattr(j, k) == getattr(p, k), k
    assert pdw.supports_wrapped(pcg) == jdw.supports_wrapped(jcg)


def test_pack_diag_stencil(both):
    (_, jcg, _), (_, pcg, _), _, _ = both
    j = jdc.pack_diag_stencil(jcg, dtype=np.float32)
    p = pdc.pack_diag_stencil(pcg, dtype=np.float32)
    for k in ("u_idx", "offs", "wp", "ring_f", "ring_b", "chain_f",
              "chain_b", "fan_w"):
        _same(getattr(j, k), getattr(p, k), k)
    for k in ("pad", "D", "Mp", "M", "ntheta", "NTL"):
        assert getattr(j, k) == getattr(p, k), k


def test_wrapped_and_diag_geometry():
    """The shapes the witer and diag kernels are sized for: 183x63 goes
    to 'wrapped' (no twrapped support, dup 73), 127x63 to 'diag' (dup 1:
    neither twrapped nor wrapped support)."""
    _, cg, _ = pt.init_annulus_circulant(183, 63, 20.0)
    ws = pdw.pack_wrapped_stencil(cg, dtype=np.float32)
    assert cg.n == 150_244 and pdw.supports_wrapped(cg)
    assert (ws.Mp, ws.NTL, ws.NTL - ws.nt, ws.D, ws.cfl.shape[0]) == \
        (824, 256, 73, 404, 6)
    _, cg, _ = pt.init_annulus_circulant(127, 63, 20.0)
    ds = pdc.pack_diag_stencil(cg, dtype=np.float32)
    assert cg.n == 131_065 and not pdw.supports_wrapped(cg)
    assert (ds.Mp, ds.NTL, ds.D, ds.pad) == (1032, 128, 534, 56)


def test_pack_sweep_tables(both):
    (_, jcg, _), (_, pcg, _), jws, pws = both
    jt, js = jsw.pack_sweep_tables(jws, jcg, np.float32)
    pt_, ps = psw.pack_sweep_tables(pws, pcg, np.float32)
    _same_tuple(jt, pt_, "SweepTables")
    _same_tuple(js, ps, "SweepStatic")


def test_pack_rsweep_tables(both):
    (_, jcg, _), (_, pcg, _), jws, pws = both
    (jdn, jup), jr = jsw.pack_rsweep_tables(jws, jcg, np.float32)
    (pdn, pup), pr = psw.pack_rsweep_tables(pws, pcg, np.float32)
    _same(jdn, pdn, "wtab_dn")
    _same(jup, pup, "wtab_up")
    _same_tuple(jr, pr, "RSweepStatic")


def test_main_path_geometry():
    """The 180x63 shapes the CUDA kernel is sized for."""
    _, cg, _ = pt.init_annulus_circulant(180, 63, 20.0)
    ws = p_pack(cg, dtype=np.float32, band_closure=0)
    (wdn, wup), rst = psw.pack_rsweep_tables(ws, cg, np.float32)
    assert cg.n == 150_121
    assert (rst.MT, rst.K8, rst.NTL, rst.NTB) == (840, 48, 256, 256)
    assert len(rst.taps_dn) == len(rst.taps_up) == 200
    assert wdn.shape == wup.shape == (888, 256)
    assert (ws.nt, ws.ML) == (180, 896)


def test_tables_from_numpy_round_trip(both):
    """The JAX package's packed tables, carried over, equal the port's
    own tables bit for bit."""
    (_, jcg, _), (_, pcg, _), jws, pws = both
    jt, js = jsw.pack_sweep_tables(jws, jcg, np.float32)
    (jdn, jup), jr = jsw.pack_rsweep_tables(jws, jcg, np.float32)
    tbl, st, (wdn, wup), rst, cg = convert.tables_from_numpy(
        jt, js, jdn, jup, jr, jcg)
    pt_, ps = psw.pack_sweep_tables(pws, pcg, np.float32)
    (pdn, pup), pr = psw.pack_rsweep_tables(pws, pcg, np.float32)
    _same_tuple(tbl, pt_, "SweepTables")
    _same_tuple(st, ps, "SweepStatic")
    _same_tuple(rst, pr, "RSweepStatic")
    _same(wdn, pdn, "wtab_dn")
    _same(wup, pup, "wtab_up")
    for k in ("src_flat", "w", "fan_slots", "fan_w"):
        _same(getattr(cg, k), getattr(pcg, k), k)
    _same(cg.cmap.node_of, pcg.cmap.node_of, "node_of")
    assert cg.cmap.center == pcg.cmap.center and cg.n == pcg.n


def test_full_mesh_builder_and_extraction():
    """init_annulus (scipy adjacency) + build_circulant on a full small
    mesh equal the JAX package's, and give the fast builder's stencil."""
    jgr, jA, jhalo = rt.init_annulus(16, 6, spacing=200.0)
    pgr, pA, phalo = pt.init_annulus(16, 6, spacing=200.0)
    for k in ("x", "z", "theta", "r", "twin_class"):
        _same(getattr(jgr, k), getattr(pgr, k), k)
    _same(jhalo, phalo, "halo")
    assert (jA != pA).nnz == 0 and jA.shape == pA.shape
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(pgr.r, pt.LinearInterpolation(prof.r, prof.Vp))
    jcg = j_build(jgr, jA, jhalo, U)
    pcg = pt.build_circulant(pgr, pA, phalo, U)
    for k in ("src_flat", "w", "fan_slots", "fan_w"):
        _same(getattr(jcg, k), getattr(pcg, k), k)
    _, fcg, _ = pt.init_annulus_circulant(16, 6, 200.0)
    _same(pcg.w, fcg.w, "fast builder w")


def test_closest_point():
    gr, _, _ = pt.init_annulus_circulant(48, 12, 150.0)
    jgr, _, _ = rt.init_annulus_circulant(48, 12, 150.0)
    for deg in (0.0, 37.0, 181.0, 359.0):
        for rad in (pt.R, 3480.0):
            assert (pt.closest_point(gr, np.deg2rad(deg), rad, system="polar")
                    == rt.closest_point(jgr, np.deg2rad(deg), rad,
                                        system="polar"))


def test_partition_and_level_masks(both):
    """The copied radial partition (models/partition) labels every node
    as the JAX package's does, with the same level iterator and masks,
    on the circulant grids and on a full mesh with its twins."""
    from raytracer_tpu.models import partition as jpart
    from raytracer_tpu_torch.models import partition as ppart

    (jgr, _, _), (pgr, _, _), _, _ = both
    grids = [(jgr, pgr), (rt.init_annulus(16, 6, spacing=200.0)[0],
                          pt.init_annulus(16, 6, spacing=200.0)[0])]
    for jg, pg in grids:
        jp, pp = jpart.partition_grid(jg), ppart.partition_grid(pg)
        assert jp.id.dtype == pp.id.dtype and list(jp.id) == list(pp.id)
        for k in ("layer_of", "boundary_of"):
            _same(getattr(jp, k), getattr(pp, k), k)
        for k in ("rboundaries", "layers", "boundaries", "nlayers",
                  "nboundaries", "iterator"):
            assert getattr(jp, k) == getattr(pp, k), k
        for level in range(1, 2 * pp.nlayers):
            _same(jpart.level_mask(jp, level), ppart.level_mask(pp, level),
                  f"level {level}")
    for r in (pt.R - 5.0, pt.R - 27.0, 5000.0, 1000.0):
        assert ppart.find_layer_number(r) == jpart.find_layer_number(r)
    with pytest.raises(ValueError):
        ppart.find_layer_number(pt.config.DISCONTINUITY_RADII[2])
    assert pt.partition_grid is ppart.partition_grid


def test_dual_velocity():
    r = np.concatenate([np.linspace(0.0, 6371.0, 501),
                        np.asarray(rt.DISCONTINUITY_RADII)])
    prof = pt.velocity_profile("ak135")
    for wave in ("Vp", "Vs"):
        ji = rt.LinearInterpolation(prof.r, getattr(prof, wave))
        pi = pt.LinearInterpolation(prof.r, getattr(prof, wave))
        _same(rt.dual_velocity(r, ji), pt.dual_velocity(r, pi), wave)
