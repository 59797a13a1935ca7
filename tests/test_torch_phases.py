"""PyTorch port: the named phases against the JAX package.

On 24x8 (spacing 150, as tests/test_phases.py): the single-leg region
field and PcP on the staged stream engine equal the JAX package's bit
for bit, PcP in the same iterations; PcP on the staged sweep engine
within the JAX package's engine tolerance of the stream field
(tests/test_phases.py: rtol 1e-6, atol 5e-3 s); one `_reuse` dict
serves PcP (Vp) and ScS (Vs) apart, its keys carrying U's fingerprint;
PP equals the JAX composition.  On 36x12 (spacing 100, as
tests/test_converted.py and tests/test_depth_phases.py): SKS (three
packs) equals the JAX package's field in the same iterations; pP from
a 400-km source equals the JAX package's; sP is held to the independent
tau-p anchor (models/flatearth.depth_phase_first_arrival, through the
JAX package) within the tolerance tests/test_depth_phases.py gives pP
(anchor - 0.5 s < t < 1.05 anchor) - through the bounce the graph
fields carry, which the test picks itself, since the margin floor the
port keeps equal to the JAX package's rejects it (ROADMAP C.6): the
returned sP equals the JAX package's and lies above the anchor.  The port's
CLI `--phases PcP,SKS,PP` writes the JAX CLI's CSV.  Where a field is
compared "equal", the bound is 2e-3 s (the stream engine's TOL,
tests/test_torch_stream.py), and in practice it is bit for bit.
"""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JC
from raytracer_tpu.models.flatearth import depth_phase_first_arrival
from raytracer_tpu.ops import stream_t as jst
from raytracer_tpu.solvers import phases as jph
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.solvers import phases as pph
from jax_mappings import below_the_map_limit  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32J, F32P = JC(dtype="float32"), PC(dtype="float32")
TOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_field(got, want, atol=TOL):
    ok = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=atol)


def _tables(gr):
    prof = rt.velocity_profile()
    return (rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                                 prof.Vp)),
            rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                                 prof.Vs)))


def _rcv(gr, degs):
    return [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in degs]


@pytest.fixture(scope="module")
def mid():
    gr, A, halo = rt.init_annulus(24, 8, spacing=150.0)
    Up, Us = _tables(gr)
    return gr, A, halo, Up, Us, rt.closest_point(gr, 0.0, rt.R,
                                                 system="polar")


@pytest.fixture(scope="module")
def deep():
    gr, A, halo = rt.init_annulus(36, 12, spacing=100.0)
    Up, Us = _tables(gr)
    return gr, A, halo, Up, Us


@pytest.fixture(scope="module")
def pcp_mid(mid):
    """The JAX package's PcP on the stream engine: field and iterations
    (its two-stage staged solve)."""
    gr, A, halo, Up, _, src = mid
    cg, ws, static, tables, lane, keep, halo_map = jph._phase_setup(
        A, halo, gr, Up, 7, F32J)
    stages = jph._phase_stages(static, tables, lane, keep, halo_map,
                               "stream", reflected=True)
    d, it = jst.solve_stream_staged(cg, ws, stages, [src], F32J,
                                    interpret=True)
    return d[0], it


def test_region_and_pcp_stream_equal_jax(mid, pcp_mid):
    gr, A, halo, Up, _, src = mid
    want = jph.region_travel_times(A, halo, src, gr, Up, "cmb", F32J,
                                   interpret=True)
    reuse = {}
    got = pph.region_travel_times(A, halo, src, gr, Up, "cmb", F32P,
                                  device="cpu", _reuse=reuse)
    _same_field(got, want)
    pcp_j, it_j = pcp_mid
    pcp, it_p = pph.reflected_travel_times_it(A, halo, src, gr, Up, "cmb",
                                              F32P, device="cpu",
                                              _reuse=reuse)
    _same_field(pcp, pcp_j)
    assert it_p == it_j > 2
    assert len(reuse) == 1          # the region leg and PcP share a setup
    surf = np.flatnonzero(gr.r == gr.r.max())
    assert np.isfinite(pcp[surf]).all()
    rcvs = _rcv(gr, (20.0, 60.0))
    via = pph.phase_travel_times(A, halo, src, gr, Up, "PcP", F32P,
                                 receivers=rcvs, device="cpu", _reuse=reuse)
    np.testing.assert_array_equal(via, pcp[rcvs])


def test_pcp_sweep_engine_matches_stream(mid, pcp_mid):
    gr, A, halo, Up, _, src = mid
    d_sw = pph.reflected_travel_times(A, halo, src, gr, Up, "cmb", F32P,
                                      device="cpu", engine="sweep")
    ok = np.isfinite(pcp_mid[0])
    np.testing.assert_array_equal(np.isfinite(d_sw), ok)
    np.testing.assert_allclose(d_sw[ok], pcp_mid[0][ok], rtol=1e-6,
                               atol=5e-3)


def test_reuse_keys_carry_the_velocity(mid, pcp_mid):
    """PcP (Vp) then ScS (Vs) through one reuse dict: ScS is solved on
    the Vs pack, equal to a fresh ScS, and the dict holds two setups."""
    gr, A, halo, Up, Us, src = mid
    reuse = {}
    pcp = pph.phase_travel_times(A, halo, src, gr, Up, "PcP", F32P,
                                 device="cpu", _reuse=reuse)
    scs = pph.phase_travel_times(A, halo, src, gr, Us, "ScS", F32P,
                                 device="cpu", _reuse=reuse)
    assert len(reuse) == 2
    fresh = pph.reflected_travel_times(A, halo, src, gr, Us, "cmb", F32P,
                                       device="cpu")
    np.testing.assert_array_equal(scs, fresh)
    _same_field(pcp, pcp_mid[0])
    surf = np.flatnonzero(gr.r == gr.r.max())
    assert np.all(scs[surf] > pcp[surf] + 100.0)


@pytest.mark.parametrize("phase", ["PcP", "SKS"])
def test_reuse_keys_carry_the_dtype(mid, phase):
    """A float32 solve, then a float64 one, through one reuse dict: the
    float64 call builds its own tables (ROADMAP C.13) and equals a fresh
    float64 solve."""
    gr, A, halo, Up, Us, src = mid
    F64P = PC(dtype="float64")
    Ustab = Us if phase == "SKS" else None
    reuse = {}
    pph.phase_travel_times(A, halo, src, gr, Up, phase, F32P, device="cpu",
                           Us=Ustab, _reuse=reuse)
    got = pph.phase_travel_times(A, halo, src, gr, Up, phase, F64P,
                                 device="cpu", Us=Ustab, _reuse=reuse)
    fresh = pph.phase_travel_times(A, halo, src, gr, Up, phase, F64P,
                                   device="cpu", Us=Ustab)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, fresh)


def test_pp_and_guards_equal_jax(mid):
    gr, A, halo, Up, Us, src = mid
    rcvs = _rcv(gr, (60.0, 90.0))
    want = jph.phase_travel_times(A, halo, src, gr, Up, "PP", F32J,
                                  receivers=rcvs, interpret=True)
    got = pph.phase_travel_times(A, halo, src, gr, Up, "PP", F32P,
                                 receivers=rcvs, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.isfinite(got).all()
    with pytest.raises(ValueError, match="unknown phase"):
        pph.phase_travel_times(A, halo, src, gr, Up, "PcS", F32P,
                               device="cpu")
    with pytest.raises(ValueError, match="receivers"):
        pph.phase_travel_times(A, halo, src, gr, Up, "PP", F32P,
                               device="cpu")
    with pytest.raises(ValueError, match="S leg"):
        pph.phase_travel_times(A, halo, src, gr, Up, "SKS", F32P,
                               device="cpu")
    with pytest.raises(ValueError, match="engine"):
        pph.reflected_travel_times(A, halo, src, gr, Up, "cmb", F32P,
                                   device="cpu", engine="ell")


def test_sks_equals_jax(deep, monkeypatch):
    gr, A, halo, Up, Us = deep
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    seen = []
    solve = jst.solve_stream_staged

    def spy(*args, **kwargs):
        out = solve(*args, **kwargs)
        seen.append(int(out[1]))
        return out

    monkeypatch.setattr(jst, "solve_stream_staged", spy)
    want = jph.phase_travel_times(A, halo, src, gr, Up, "SKS", F32J,
                                  interpret=True, Us=Us)
    reuse = {}
    got, it_p = pph.converted_travel_times_it(A, halo, src, gr, Us, Up,
                                              config=F32P, device="cpu",
                                              _reuse=reuse)
    _same_field(got, want)
    assert [it_p] == seen and it_p > 3
    # through the dispatcher, on the packs and stages kept in reuse
    n = len(reuse)
    rcvs = _rcv(gr, (100.0, 120.0))
    via = pph.phase_travel_times(A, halo, src, gr, Up, "SKS", F32P,
                                 receivers=rcvs, device="cpu", Us=Us,
                                 _reuse=reuse)
    np.testing.assert_array_equal(via, got[rcvs])
    assert len(reuse) == n
    deep_core = (pt.partition_grid(gr).layer_of == 8) & (gr.r < 3400.0)
    assert not np.isfinite(got[deep_core]).any()


@pytest.fixture(scope="module")
def buried(deep):
    """A 400-km source (tests/test_depth_phases.py), three receivers,
    the port's sP through its entry point, and the direct fields the
    depth phases compose, kept as `depth_phase_pick` receives them
    there: Vs from the source and Vp from each receiver, then Vp from
    the source."""
    gr, A, halo, Up, Us = deep
    src = rt.closest_point(gr, 0.0, rt.R - 400.0, system="polar")
    degs = np.array([40.0, 60.0, 80.0])
    rcvs = _rcv(gr, degs)
    seen = []
    pick = pph.depth_phase_pick

    def spy(t_src, t_rcv, *args, **kwargs):
        seen.append((t_src, t_rcv))
        return pick(t_src, t_rcv, *args, **kwargs)

    pph.depth_phase_pick = spy
    try:
        sP = pph.phase_travel_times(A, halo, src, gr, Up, "sP", F32P,
                                    receivers=rcvs, device="cpu", Us=Us)
    finally:
        pph.depth_phase_pick = pick
    fields = {"s_src": seen[0][0], "p_rcv": [t for _, t in seen],
              "p_src": pph._direct_solver(gr, A, halo, Up, F32P, "cpu")
              .solve(src, want_prev=False).dist}
    return gr, A, halo, Up, Us, src, degs, rcvs, fields, sP


def test_pP_equals_jax(buried):
    """pP composed from the port's fields (the entry point's own
    composition, `depth_phase_pick`) equals the JAX package's pP and
    lies within the anchor tolerance of tests/test_depth_phases.py."""
    gr, A, halo, Up, Us, src, degs, rcvs, fields, _ = buried
    want = jph.phase_travel_times(A, halo, src, gr, Up, "pP", F32J,
                                  receivers=rcvs, interpret=True, Us=Us)
    surf = pph.surface_ring(gr)
    got = np.array([pph.depth_phase_pick(fields["p_src"], t, surf, src, r)
                    for t, r in zip(fields["p_rcv"], rcvs)])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    h_eff = rt.R - float(gr.r[src])
    anchor = depth_phase_first_arrival(degs, h_eff, "pP")
    assert np.all(got > anchor - 0.5) and np.all(got < anchor * 1.05)


def _interior_minimum(t_src, t_rcv, surf, src, rcv):
    """The bounce the fields carry: the smallest interior cyclic local
    minimum of t_src + t_rcv along the surface ring, with only the
    receiver's and the source's own nodes left out (no margin floor)."""
    f = t_src[surf] + t_rcv[surf]
    fl, fr = np.roll(f, 1), np.roll(f, -1)
    ok = (np.isfinite(f) & (f <= fl) & (f <= fr) & ((f < fl) | (f < fr))
          & (surf != rcv) & (surf != src))
    return float(f[ok].min())


def test_sP_against_the_anchor(buried):
    """sP from the fields the port solves: the bounce they carry (the
    smallest interior local minimum of the composition, computed here
    with no margin floor) lies within the anchor tolerance; the floor
    kept equal to the JAX package's rejects it, and the entry point
    returns the JAX package's later minimum, which does not (ROADMAP
    C.6)."""
    gr, A, halo, Up, Us, src, degs, rcvs, fields, sP = buried
    surf = pph.surface_ring(gr)
    h_eff = rt.R - float(gr.r[src])
    anchor = depth_phase_first_arrival(degs, h_eff, "sP")
    bounce = np.array([_interior_minimum(fields["s_src"], t, surf, src, r)
                       for t, r in zip(fields["p_rcv"], rcvs)])
    assert np.all(bounce > anchor - 0.5) and np.all(bounce < anchor * 1.05)
    want = jph.phase_travel_times(A, halo, src, gr, Up, "sP", F32J,
                                  receivers=rcvs, interpret=True, Us=Us)
    np.testing.assert_allclose(sP, want, rtol=0, atol=TOL)
    assert np.all(sP >= bounce)
    pP = [pph.depth_phase_pick(fields["p_src"], t, surf, src, r)
          for t, r in zip(fields["p_rcv"], rcvs)]
    assert np.all(bounce > pP)


def test_cli_phases_csv_equals_jax_cli(tmp_path):
    from raytracer_tpu_torch import main_annulus

    grid = ["--ntheta", "16", "--nr", "4", "--spacing", "600",
            "--phases", "PcP,SKS,PP"]
    jprefix, pprefix = str(tmp_path / "jax"), str(tmp_path / "port")
    argv_old = sys.argv
    sys.argv = ["main_annulus.py", *grid, "--out-prefix", jprefix]
    try:
        runpy.run_path(os.path.join(ROOT, "main_annulus.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv_old
    main_annulus.main([*grid, "--device", "cpu", "--out-prefix", pprefix])
    with open(jprefix + "_phases.csv") as fj, \
            open(pprefix + "_phases.csv") as fp:
        hj, hp = fj.readline(), fp.readline()
    assert hj == hp == "deg,PcP,SKS,PP\n"
    want = np.genfromtxt(jprefix + "_phases.csv", delimiter=",",
                         skip_header=2)
    got = np.genfromtxt(pprefix + "_phases.csv", delimiter=",",
                        skip_header=2)
    assert got.shape == want.shape == (150, 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=TOL)
    assert np.isfinite(got[:, 1:]).sum() > 200
