"""PyTorch port: the 3-D spherical-shell solve against the JAX package on
the CPU.

`solve3d(engine="auto")` in the port takes the JAX package's accelerator
route on every device: the kernel engine ('pallas', the CUDA kernel
`csrc/sweep3d.cu` on the card, its plain twin on the CPU) for the star-1
stencil.  On the CPU it must equal the JAX package's `engine="pallas"`
run in interpret mode bit for bit, with the same iteration count, for
single sources, source groups with a padded tail, receivers and the axis
scans; the port's 'xla' engine must equal JAX's in float32 and float64.
The directional-sweep engine ('sweep', the plane-pass kernel
`csrc/plane3d.cu` on the card) must give the JAX package's floats and
rounds for single sources, padded source groups and receivers, in
float32 and float64, and star 2 must route 'auto' to it.
`recover_prev3d` must give the JAX package's predecessor trees.  The
JAX-side TPU routing figures (`_kernel_vmem_bytes`, `_auto_source_batch`)
are kept so that a grid takes the same engine and source batch in both
packages.  Mirrors tests/test_sweep3d.py, tests/test_grid3d.py and
tests/test_prev3d.py.
"""
import contextlib
import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import R
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.models import grid3d as jg
from raytracer_tpu.ops import sweep3d as jk
from raytracer_tpu.solvers import solve3d as js
from raytracer_tpu.utils.coords import spherical2cart
import raytracer_tpu_torch as pt
from raytracer_tpu_torch import example_grid3d
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.convert import packed3d_from_numpy
from raytracer_tpu_torch.ops import sweep3d as pk
from raytracer_tpu_torch.solvers import solve3d as ps
from jax_mappings import below_the_map_limit  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JF32, PF32 = JConfig(dtype="float32"), PConfig(dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests (see
    tests/test_torch_sweep3d.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wedge(dims=(9, 6, 5), dtype="float32"):
    """JAX and port grids, U, and both packages' packed weights, on the
    JAX kernel tests' wedge (theta, phi 80-100 deg, depth 600 km)."""
    c0 = (np.deg2rad(80.0), np.deg2rad(80.0), R - 600.0)
    c1 = (np.deg2rad(100.0), np.deg2rad(100.0), R)
    gj, gp = jg.grid3d(c0, c1, dims), pt.grid3d(c0, c1, dims)
    prof = rt.velocity_profile()
    U = rt.LinearInterpolation(prof.r, prof.Vp)(gj.r)
    jp = js.prepare3d(gj, U, JConfig(dtype=dtype))
    pp = ps.prepare3d(gp, U, PConfig(dtype=dtype), device="cpu")
    return gj, gp, U, jp, pp


@pytest.fixture(scope="module")
def wedge():
    return _wedge()


def _sources(g):
    return [len(g) // 2, 3, len(g) - 2]


@pytest.mark.parametrize("scan_every", [0, 8])
@pytest.mark.parametrize("source_batch", [1, 2])
def test_auto_equals_jax_pallas_interpret(wedge, scan_every, source_batch):
    gj, gp, U, jp, pp = wedge
    srcs = _sources(gj)
    want, it_j = js.solve3d(gj, U, srcs, JF32, scan_every=scan_every,
                            engine="pallas", interpret=True,
                            source_batch=source_batch, _packed=jp)
    got, it_p = ps.solve3d(gp, U, srcs, PF32, scan_every=scan_every,
                           source_batch=source_batch, _packed=pp,
                           device="cpu")
    assert it_p == it_j > 0 and it_p % 8 == 0
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scan_every", [0, 8])
def test_auto_receivers_equal_jax_pallas_interpret(wedge, scan_every):
    gj, gp, U, jp, pp = wedge
    srcs = _sources(gj)
    recs = [0, len(gj) // 3, len(gj) - 1]
    want, it_j = js.solve3d(gj, U, srcs, JF32, scan_every=scan_every,
                            receivers=recs, engine="pallas", interpret=True,
                            source_batch=2, _packed=jp)
    got, it_p = ps.solve3d(gp, U, srcs, PF32, scan_every=scan_every,
                           receivers=recs, source_batch=2, _packed=pp,
                           device="cpu")
    assert it_p == it_j and got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)
    full, _ = ps.solve3d(gp, U, srcs, PF32, scan_every=scan_every,
                         source_batch=2, _packed=pp, device="cpu")
    np.testing.assert_array_equal(got, full[:, recs])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_xla_engine_equals_jax(dtype):
    gj, gp, U, jp, pp = _wedge(dtype=dtype)
    srcs = _sources(gj)
    recs = [0, len(gj) // 3, len(gj) - 1]
    for kw in ({}, {"scan_every": 0}, {"receivers": recs}):
        want, it_j = js.solve3d(gj, U, srcs, JConfig(dtype=dtype),
                                engine="xla", _packed=jp, **kw)
        got, it_p = ps.solve3d(gp, U, srcs, PConfig(dtype=dtype),
                               engine="xla", _packed=pp, device="cpu", **kw)
        assert it_p == it_j > 0 and got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, want)


def test_star2_xla_engine_equals_jax():
    gj, gp, U, _, _ = _wedge((7, 6, 4))
    want, it_j = js.solve3d(gj, U, [5, 40], JF32, engine="xla", star=2)
    got, it_p = ps.solve3d(gp, U, [5, 40], PF32, engine="xla", star=2,
                           device="cpu")
    assert it_p == it_j
    np.testing.assert_array_equal(got, want)


def test_float64_auto_matches_jax_solve3d_on_the_example_grid():
    """tests/test_grid3d.py's grid and tolerance: the port's kernel route
    in float64 against the JAX package's solve3d (its xla engine on the
    CPU)."""
    c0 = (np.deg2rad(70.0), np.deg2rad(70.0), R - 2000.0)
    c1 = (np.deg2rad(110.0), np.deg2rad(110.0), R)
    gj, gp = jg.grid3d(c0, c1, (6, 6, 5)), pt.grid3d(c0, c1, (6, 6, 5))
    prof = rt.velocity_profile()
    U = rt.LinearInterpolation(prof.r, prof.Vp)(gj.r)
    src = [jg.closest_point3d(gj, *spherical2cart(np.deg2rad(90.0),
                                                 np.deg2rad(90.0), R))]
    cfg_j, cfg_p = JConfig(dtype="float64"), PConfig(dtype="float64")
    want, _ = js.solve3d(gj, U, src, cfg_j)
    pp = ps.prepare3d(gp, U, cfg_p, device="cpu")
    assert ps.select_engine3d(pp, "auto", np.float64) == "pallas"
    got, _ = ps.solve3d(gp, U, src, cfg_p, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9)


def _statics_plan(module, shape, block_rows=1024):
    n1, BR, NB, L0, H8 = pk.sweep3d_statics(shape, block_rows)
    return module.Sweep3DPlan(W4=None, shape=shape, n1=n1, BR=BR, NB=NB,
                              L0=L0, H8=H8)


@pytest.mark.parametrize("shape", [(5, 6, 9), (16, 24, 24), (64, 128, 128)])
def test_kernel_vmem_and_auto_source_batch_equal_jax(shape):
    """From the plan's statics alone (no weights are built): the same
    footprint estimate, source batch and route as the JAX package; at
    128x128x64 (shape (64, 128, 128)) 7 sources per group."""
    pplan, jplan = _statics_plan(pk, shape), _statics_plan(jk, shape)
    for itemsize in (4, 8):
        for S in range(1, 9):
            assert ps._kernel_vmem_bytes(pplan, itemsize, S) == \
                js._kernel_vmem_bytes(jplan, itemsize, S)
        for nsrc in (1, 3, 7, 64):
            assert ps._auto_source_batch(pplan, itemsize, nsrc) == \
                js._auto_source_batch(jplan, itemsize, nsrc)
    if shape == (64, 128, 128):
        assert ps._auto_source_batch(pplan, 4, 64) == 7
        assert ps._kernel_vmem_bytes(pplan, 4) < ps.VMEM_BUDGET


def test_recover_prev3d_equals_jax_and_descends(wedge):
    gj, gp, U, jp, pp = wedge
    srcs = _sources(gj)
    d, _ = ps.solve3d(gp, U, srcs, PF32, _packed=pp, device="cpu")
    got = ps.recover_prev3d(gp, U, d, srcs, PF32, _packed=pp, device="cpu")
    want = js.recover_prev3d(gj, U, d, srcs, JF32, _packed=jp)
    assert got.dtype == np.int32 and got.shape == (3, len(gj))
    np.testing.assert_array_equal(got, want)
    one = ps.recover_prev3d(gp, U, d[1], [srcs[1]], PF32, _packed=pp,
                            device="cpu")
    np.testing.assert_array_equal(one[0], got[1])
    for s, (src, prev) in enumerate(zip(srcs, got)):
        assert prev[src] == src
        for r in (0, len(gj) // 3, len(gj) - 1):
            p = pt.recontruct_path(prev, src, r)
            assert p[0] == r and p[-1] == src
            assert np.all(np.diff(d[s][p]) < 0)


def test_sweep_engine_equals_jax(wedge):
    """The directional-sweep engine: the JAX package's floats and rounds
    for single sources, groups of source_batch=2 on 3 sources (the tail
    group padded with its last source) and receivers gathered on the
    device (mirrors tests/test_sweep3d.py's sweep test)."""
    gj, gp, U, jp, pp = wedge
    srcs = _sources(gj)
    want, it_w = js.solve3d(gj, U, srcs, JF32, engine="sweep", _packed=jp)
    got, it_g = ps.solve3d(gp, U, srcs, PF32, engine="sweep", _packed=pp,
                           device="cpu")
    assert it_g == it_w and 0 < it_g
    np.testing.assert_array_equal(got, want)
    d_xla, it_x = ps.solve3d(gp, U, srcs, PF32, engine="xla", _packed=pp,
                             device="cpu")
    assert it_g <= it_x     # rounds, not Jacobi iterations
    np.testing.assert_allclose(got, d_xla, rtol=1e-6, atol=5e-3)
    want_b, it_wb = js.solve3d(gj, U, srcs, JF32, engine="sweep",
                               source_batch=2, _packed=jp)
    got_b, it_gb = ps.solve3d(gp, U, srcs, PF32, engine="sweep",
                              source_batch=2, _packed=pp, device="cpu")
    assert it_gb == it_wb
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_allclose(got_b, got, rtol=1e-6, atol=5e-3)
    recs = [0, len(gj) // 3, len(gj) - 1]
    tab, _ = ps.solve3d(gp, U, srcs, PF32, engine="sweep", source_batch=2,
                        receivers=recs, _packed=pp, device="cpu")
    np.testing.assert_array_equal(tab, got_b[:, recs])


def test_sweep_engine_float64_equals_jax():
    gj, gp, U, jp, pp = _wedge((9, 6, 5), "float64")
    srcs = _sources(gj)
    want, it_w = js.solve3d(gj, U, srcs, JConfig(dtype="float64"),
                            engine="sweep", _packed=jp)
    got, it_g = ps.solve3d(gp, U, srcs, PConfig(dtype="float64"),
                           engine="sweep", _packed=pp, device="cpu")
    assert got.dtype == np.float64 and it_g == it_w
    np.testing.assert_array_equal(got, want)


def test_star2_auto_routes_to_sweep_and_equals_jax():
    """star 2 (98 taps) has no kernel-engine plan: 'auto' takes the sweep
    engine, as the JAX package does off the TPU; the same floats and
    rounds as JAX's sweep, within 1e-3 s of the port's star-2 xla solve,
    never above star 1 by more than 1e-3 s (mirrors
    tests/test_grid3d_disc.py's star-2 test on a smaller p_wedge: 19x4x10
    in place of 57x4x29)."""
    c0, c1 = (0.0, np.deg2rad(87.0), 3000.0), (np.deg2rad(70.0),
                                               np.deg2rad(93.0), R)
    gj, gp = jg.grid3d(c0, c1, (19, 4, 10)), pt.grid3d(c0, c1, (19, 4, 10))
    prof = rt.velocity_profile("ak135")
    U = jg.velocity3d(gj, rt.LinearInterpolation(prof.r, prof.Vp))
    jp2 = js.prepare3d(gj, U, JF32, star=2)
    pp2 = ps.prepare3d(gp, U, PF32, star=2, device="cpu")
    assert pp2.plan is None and len(pp2.shifts) == 98
    assert ps.select_engine3d(pp2, "auto", np.float32) == "sweep"
    x, y, z = spherical2cart(0.0, np.deg2rad(90.0), R)
    src = jg.closest_point3d(gj, x, y, z)
    want, it_w = js.solve3d(gj, U, [src], JF32, engine="sweep", _packed=jp2)
    got, it_g = ps.solve3d(gp, U, [src], PF32, _packed=pp2, device="cpu")
    assert it_g == it_w < 10
    np.testing.assert_array_equal(got, want)
    d2x, _ = ps.solve3d(gp, U, [src], PF32, engine="xla", _packed=pp2,
                        device="cpu")
    d1, _ = ps.solve3d(gp, U, [src], PF32, engine="sweep", device="cpu")
    fin = np.isfinite(d1[0])
    np.testing.assert_allclose(got[0][fin], d2x[0][fin], rtol=0, atol=1e-3)
    assert np.all(got[0][fin] <= d1[0][fin] + 1e-3)
    assert float(np.mean(d1[0][fin] - got[0][fin])) > 0.0


def test_star2_pallas_engine_names_the_star1_limit():
    """The kernel engine's plan is star-1 only: an explicit
    engine='pallas' on a star-2 stencil raises ValueError."""
    _, gp, U, _, _ = _wedge((7, 6, 4))
    pp = ps.prepare3d(gp, U, PF32, star=2, device="cpu")
    with pytest.raises(ValueError, match="star-1"):
        ps.solve3d(gp, U, [3], PF32, engine="pallas", _packed=pp,
                   device="cpu")


def test_interpret_on_a_cuda_device_raises(wedge):
    _, gp, U, _, pp = wedge
    with pytest.raises(ValueError, match="interpret"):
        ps.solve3d(gp, U, [3], PF32, interpret=True, _packed=pp,
                   device="cuda")
    # on the CPU it is accepted and runs the twin, as JAX's interpreter
    a, _ = ps.solve3d(gp, U, [3], PF32, interpret=True, _packed=pp,
                      device="cpu")
    b, _ = ps.solve3d(gp, U, [3], PF32, _packed=pp, device="cpu")
    np.testing.assert_array_equal(a, b)


def test_device_layout_uploads_once_per_card(wedge, monkeypatch):
    """One upload per layout and card: a second call returns the cached
    tensor, and 'cuda' and 'cuda:<current>' are one key."""
    _, _, _, _, pp = wedge
    cpu = torch.device("cpu")
    assert ps._device_layout(pp, "W", cpu) is ps._device_layout(pp, "W", cpu)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    key = ps._device_key
    assert key(torch.device("cuda")) == key(torch.device("cuda:0"))
    assert key(torch.device("cuda")) != key(torch.device("cuda:1"))
    assert key(cpu) == "cpu"


def test_entry_points_default_to_the_card(wedge):
    """Without a card the default device raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    gj, gp, U, _, pp = wedge
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.prepare3d(gp, U, PF32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.solve3d(gp, U, [3], PF32, _packed=pp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.recover_prev3d(gp, U, np.zeros(len(gp)), [3], PF32, _packed=pp)


def test_packed3d_from_jax_weights_gives_the_same_solve(wedge):
    gj, gp, U, jp, pp = wedge
    conv = packed3d_from_numpy(jp.W_np, jp.shape, jp.shifts, "cpu")
    np.testing.assert_array_equal(conv.W_np, pp.W_np)
    np.testing.assert_array_equal(conv.plan.W4, np.asarray(jp.plan.W4))
    assert conv.plan._replace(W4=None) == pp.plan._replace(W4=None)
    assert conv.shape == pp.shape and conv.shifts == pp.shifts
    srcs = _sources(gj)
    got, it_p = ps.solve3d(gp, U, srcs, PF32, scan_every=8, _packed=conv,
                           device="cpu")
    want, it_j = js.solve3d(gj, U, srcs, JF32, scan_every=8, engine="pallas",
                            interpret=True, _packed=jp)
    assert it_p == it_j
    np.testing.assert_array_equal(got, want)


def _table(out: str) -> np.ndarray:
    rows = [ln for ln in out.splitlines() if ln.strip().startswith("src (")]
    return np.array([[float(v) for v in ln.split(":")[1].split()]
                     for ln in rows])


def test_example_grid3d_on_cpu_matches_the_root_example(monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["example_grid3d.py"])
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "example_grid3d.py"),
                       run_name="__main__")
    want = _table(buf.getvalue())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-m",
                           "raytracer_tpu_torch.example_grid3d", "--device",
                           "cpu"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = _table(proc.stdout)
    assert got.shape == want.shape == (3, 3)
    # both printed to 0.01 s
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01 + 1e-9)
    assert "engine pallas, source batch 3, on cpu" in proc.stdout


def test_example_grid3d_parser_defaults():
    args = example_grid3d.build_parser().parse_args([])
    assert (args.n, args.depth, args.dtype, args.engine, args.device) == \
        ([24, 24, 16], 2000.0, "float32", "stencil", "cuda")


def test_example_grid3d_ell_engine_prints_the_root_table(monkeypatch):
    """--engine ell (nodal_incidence3d -> prepare -> solve_many) prints the
    root example's --engine ell table: the same BFM floats."""
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["example_grid3d.py", "--engine", "ell"])
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "example_grid3d.py"),
                       run_name="__main__")
    want = _table(buf.getvalue())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        table, iters = example_grid3d.main(["--engine", "ell", "--device",
                                            "cpu"])
    assert iters is None
    got = _table(out.getvalue())
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_array_equal(got, want)
    assert "multi-source solve (ell, on cpu)" in out.getvalue()