"""PyTorch port: AnnulusSolver end to end on the CPU against the JAX
package's prev recovery, paths and travel-time CSV; the ported methods,
travel-time tables and device-resident fields against the JAX
AnnulusSolver; the generic-graph methods 'ell' and 'banded' and the
fallback of a mesh without a circulant layout, as the JAX package routes
it on its accelerator; the auto routing; the outputs of a
device-resident result; the CLI's defaults; the solver's parameters and
stencil cache; and the port's refusals (no silent CPU run, no silent
engine change)."""
import ast
import inspect
import os
import warnings

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops.circulant import recover_prev_device as j_prev
from raytracer_tpu.solvers.path import recontruct_path as j_path
from raytracer_tpu.utils.cache import build_circulant_cached as j_cached
from raytracer_tpu.utils.io import travel_times as j_tt
from raytracer_tpu_torch import main_annulus
from raytracer_tpu_torch.utils.cache import build_circulant_cached as p_cached
from jax_mappings import below_the_map_limit  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the plain versions
    run thousands of small ops, and while the suite's workers share the
    cores, torch's thread pool stalls at each op (a solve that takes
    half a second alone took minutes that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 2e-3


@pytest.fixture(scope="module")
def solved():
    gr, cg, U = pt.init_annulus_circulant(48, 12, 150.0)
    jgr, jcg, _ = rt.init_annulus_circulant(48, 12, 150.0)
    solver = pt.AnnulusSolver(gr, None, None, U, circulant=cg, device="cpu")
    src = pt.closest_point(gr, 0.0, pt.R, system="polar")
    D = solver.solve(src)
    return gr, cg, U, jgr, jcg, solver, src, D


def _receivers(gr):
    degs = main_annulus.receiver_degrees()
    return degs, [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
                  for d in degs]


def test_solver_routes_to_sweep_on_cpu(solved):
    _, _, _, _, _, solver, _, D = solved
    assert solver.method == "sweep"
    assert solver.device == torch.device("cpu")
    assert 1 <= solver.last_iterations < 10
    assert D.dist.dtype == np.float32 and np.isfinite(D.dist).all()


def test_prev_equals_jax_recover_prev_device(solved):
    gr, _, _, _, jcg, _, src, D = solved
    want = j_prev(jcg, D.dist)
    want[src] = src
    np.testing.assert_array_equal(D.prev, want)
    assert D.prev.dtype == want.dtype


def test_paths_and_csv_match_jax(solved, tmp_path):
    gr, _, _, jgr, _, _, src, D = solved
    degs, recs = _receivers(gr)
    for r in recs:
        p = pt.recontruct_path(D.prev, src, r)
        np.testing.assert_array_equal(p, j_path(D.prev, src, r))
        assert p[0] == r and p[-1] == src
        d_along = D.dist[p]
        assert np.all(np.diff(d_along) <= TOL)    # receiver -> source
    fp, fj = tmp_path / "port.csv", tmp_path / "jax.csv"
    tt = pt.travel_times(D, gr, recs, isave=True, flname=str(fp))
    tj = j_tt(D, jgr, recs, isave=True, flname=str(fj))
    np.testing.assert_array_equal(tt, tj)
    assert fp.read_text() == fj.read_text()


def test_full_mesh_input_matches_fast_builder(solved):
    """AnnulusSolver on the materialised mesh (A, halo) extracts the same
    stencil and solves to the same field."""
    _, cg, _, _, _, _, _, D = solved
    gr, A, halo = pt.init_annulus(48, 12, spacing=150.0)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r, prof.Vp))
    solver = pt.AnnulusSolver(gr, A, halo, U, device="cpu")
    src = pt.closest_point(gr, 0.0, pt.R, system="polar")
    Df = solver.solve(src, want_prev=False)
    full = solver.circulant.cmap
    np.testing.assert_array_equal(solver.circulant.w, cg.w)
    # same (slot, column) layout, different node numbering
    np.testing.assert_allclose(Df.dist[full.node_of],
                               D.dist[cg.cmap.node_of], atol=TOL, rtol=0)
    assert abs(Df.dist[full.center] - D.dist[cg.cmap.center]) <= TOL


def test_cuda_default_raises_without_cuda(solved, monkeypatch):
    gr, cg, U, *_ = solved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.AnnulusSolver(gr, None, None, U, circulant=cg)


NO_HALO = np.empty((0, 2), np.int64)


@pytest.fixture(scope="module")
def graph48():
    """The materialised 48x12 annulus (with its halo twins) of both
    packages, and its AK135 Vp."""
    gr, A, halo = pt.init_annulus(48, 12, spacing=150.0)
    jgr, jA, jhalo = rt.init_annulus(48, 12, spacing=150.0)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r, prof.Vp))
    return gr, A, halo, jgr, jA, jhalo, U


@pytest.mark.parametrize("method", ["ell", "banded"])
def test_graph_methods_equal_jax(graph48, method):
    """'ell' (BFM's own prev, last_iterations untouched) and 'banded'
    (prev from the host PrevRecovery) give the JAX AnnulusSolver's dist,
    prev, iterations and travel-time table."""
    gr, A, halo, jgr, jA, jhalo, U = graph48
    port = pt.AnnulusSolver(gr, A, halo, U, method=method, device="cpu")
    jax_ = rt.AnnulusSolver(jgr, jA, jhalo, U, JConfig(), method=method)
    assert port.method == jax_.method == method
    src = pt.closest_point(gr, 0.0, pt.R, system="polar")
    D, J = port.solve(src), jax_.solve(src)
    np.testing.assert_array_equal(D.dist, J.dist)
    np.testing.assert_array_equal(D.prev, J.prev)
    assert D.prev.dtype == J.prev.dtype
    assert port.last_iterations == jax_.last_iterations
    assert (port.last_iterations is None) == (method == "ell")
    np.testing.assert_array_equal(port.recover_prev(D.dist),
                                  jax_.recover_prev(J.dist))
    _, recs = _receivers(gr)
    srcs = [src, 17, 3000]
    tab = port.travel_time_table(srcs, recs[::7], batch=2)
    np.testing.assert_array_equal(
        tab, jax_.travel_time_table(srcs, recs[::7], batch=2))
    assert tab.dtype == np.float32


@pytest.mark.parametrize("method", ["ell", "banded"])
def test_graph_methods_refuse_a_prebuilt_circulant(solved, method):
    gr, cg, U, jgr, jcg, *_ = solved
    with pytest.raises(ValueError) as port:
        pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                         device="cpu")
    with pytest.raises(ValueError) as jax_:
        rt.AnnulusSolver(jgr, None, None, U, method=method, circulant=jcg)
    assert str(port.value) == str(jax_.value)


@pytest.fixture(scope="module")
def delaunay():
    """The small Delaunay mesh of tests/test_banded.py, both packages."""
    from raytracer_tpu.models.delaunay import add_midpoints, triangle_annulus_2d

    dg = pt.add_midpoints(pt.triangle_annulus_2d(nr=12, spacing=500.0))
    jdg = add_midpoints(triangle_annulus_2d(nr=12, spacing=500.0))
    A = pt.node_adjacency(dg, star=0)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(dg.r, pt.LinearInterpolation(prof.r, prof.Vp))
    return dg, jdg, A, U


def _built_with_warning(make):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        solver = make()
    msgs = [str(w.message) for w in rec if "circulant" in str(w.message)]
    assert len(msgs) == 1, msgs
    return solver, msgs[0]


def test_auto_on_a_delaunay_mesh_warns_and_routes_to_banded(delaunay,
                                                            monkeypatch):
    """auto on a mesh without a circulant layout: the JAX package's
    accelerator route (its platform check patched to a TPU while the
    solver is built) warns and takes 'banded'; the port does the same,
    with the same warning, field, prev and iterations.  Off its
    accelerator the JAX auto route falls back to 'ell' instead."""
    import jax

    dg, jdg, A, U = delaunay
    F64 = pt.SolverConfig(dtype="float64")
    port, msg = _built_with_warning(lambda: pt.AnnulusSolver(
        dg, A, NO_HALO, U, F64, device="cpu"))
    cpu_route, cpu_msg = _built_with_warning(lambda: rt.AnnulusSolver(
        jdg, A, NO_HALO, U, JConfig(dtype="float64")))
    assert cpu_route.method == "ell"
    assert cpu_msg.endswith("falling back to ell")

    class _Tpu:
        platform = "tpu"

    real_devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: [_Tpu()])
    jax_, jmsg = _built_with_warning(lambda: rt.AnnulusSolver(
        jdg, A, NO_HALO, U, JConfig(dtype="float64")))
    monkeypatch.setattr(jax, "devices", real_devices)
    assert port.method == jax_.method == "banded"
    assert msg == jmsg == ("circulant layout unavailable (mesh has no "
                           "theta-column structure (ntheta=0)); falling "
                           "back to banded")
    src = pt.closest_point(dg, 0.0, pt.R, system="polar")
    D, J = port.solve(src), jax_.solve(src)
    np.testing.assert_array_equal(D.dist, J.dist)
    np.testing.assert_array_equal(D.prev, J.prev)
    assert port.last_iterations == jax_.last_iterations > 0


def test_explicit_sweep_on_a_delaunay_mesh_falls_back_to_ell(delaunay):
    """An explicit circulant-family method on that mesh falls back to
    'ell' in both packages, with the same warning and field."""
    dg, jdg, A, U = delaunay
    port, msg = _built_with_warning(lambda: pt.AnnulusSolver(
        dg, A, NO_HALO, U, method="sweep", device="cpu"))
    jax_, jmsg = _built_with_warning(lambda: rt.AnnulusSolver(
        jdg, A, NO_HALO, U, JConfig(), method="sweep"))
    assert port.method == jax_.method == "ell"
    assert msg == jmsg and msg.endswith("falling back to ell")
    src = pt.closest_point(dg, np.deg2rad(120.0), pt.R, system="polar")
    D, J = port.solve(src), jax_.solve(src)
    np.testing.assert_array_equal(D.dist, J.dist)
    np.testing.assert_array_equal(D.prev, J.prev)


def _jax_solver(jgr, jcg, U, method):
    return rt.AnnulusSolver(jgr, None, None, U, JConfig(dtype="float32"),
                            method=method, circulant=jcg)


@pytest.fixture
def jax_fused_in_interpret_mode(monkeypatch):
    """The JAX AnnulusSolver's 'fused' route calls solve_circulant_fused
    without `interpret`, which raises on the CPU ("Only interpret mode is
    supported on CPU backend"); run the same route with the Pallas kernel
    in interpret mode, as its 'pallas' route does on the CPU."""
    from raytracer_tpu.contrib import fused_circulant as jfc

    orig = jfc.solve_circulant_fused
    monkeypatch.setattr(jfc, "solve_circulant_fused",
                        lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize("method", ["pallas", "fused"])
def test_lane_gather_methods_equal_jax(solved, method,
                                       jax_fused_in_interpret_mode):
    """'pallas' and 'fused' through AnnulusSolver: the JAX AnnulusSolver's
    field and table bit for bit, the same last_iterations (-1 for fused,
    whose count stays on the device), the prev tree of the field, and a
    host array whatever device_dist says, as in the JAX package."""
    gr, cg, U, jgr, jcg, _, src, D_sweep = solved
    solver = pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                              device="cpu")
    jsolver = _jax_solver(jgr, jcg, U, method)
    D = solver.solve(src, device_dist=True)
    Dj = jsolver.solve(src, want_prev=False)
    assert solver.method == jsolver.method == method
    assert isinstance(D.dist, np.ndarray)
    np.testing.assert_array_equal(D.dist, Dj.dist)
    assert solver.last_iterations == jsolver.last_iterations
    assert (solver.last_iterations == -1) == (method == "fused")
    want = j_prev(jcg, D.dist)
    want[src] = src
    np.testing.assert_array_equal(D.prev, want)
    np.testing.assert_allclose(D.dist, D_sweep.dist, rtol=0, atol=TOL)
    srcs = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
            for d in (0.0, 100.0, 250.0)] + [cg.cmap.center]
    recs = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
            for d in (10.0, 60.0, 150.0, 200.0)] + [cg.cmap.center]
    table = solver.travel_time_table(srcs, recs, batch=2)
    np.testing.assert_array_equal(
        table, jsolver.travel_time_table(srcs, recs, batch=2))
    assert solver.last_iterations == jsolver.last_iterations


@pytest.mark.parametrize("method", ["twrapped", "stream", "wrapped", "diag",
                                    "circulant"])
def test_ported_methods_solve_like_jax(solved, method):
    """The Jacobi engines and the plain oracle through AnnulusSolver: the
    same field, iteration count and prev tree as the JAX AnnulusSolver
    (its Pallas kernels in interpret mode)."""
    gr, cg, U, jgr, jcg, _, src, D_sweep = solved
    solver = pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                              device="cpu")
    D = solver.solve(src)
    jsolver = _jax_solver(jgr, jcg, U, method)
    Dj = jsolver.solve(src, want_prev=False)
    assert solver.method == jsolver.method == method
    np.testing.assert_allclose(D.dist, Dj.dist, rtol=0, atol=TOL)
    assert solver.last_iterations == jsolver.last_iterations
    want = j_prev(jcg, D.dist)
    want[src] = src
    np.testing.assert_array_equal(D.prev, want)
    np.testing.assert_allclose(D.dist, D_sweep.dist, rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["sweep", "twrapped", "stream",
                                    "wrapped", "diag", "circulant"])
def test_travel_time_table_matches_jax_and_single_solves(solved, method):
    gr, cg, U, jgr, jcg, *_ = solved
    srcs = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
            for d in (0.0, 100.0, 250.0)] + [cg.cmap.center]
    recs = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
            for d in (10.0, 60.0, 150.0, 200.0)] + [cg.cmap.center]
    solver = pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                              device="cpu")
    table = solver.travel_time_table(srcs, recs, batch=2)
    assert table.shape == (len(srcs), len(recs))
    single = np.stack([solver.solve(s, want_prev=False).dist[recs]
                       for s in srcs])
    np.testing.assert_allclose(table, single, rtol=0, atol=TOL)
    want = _jax_solver(jgr, jcg, U, method).travel_time_table(srcs, recs,
                                                              batch=2)
    np.testing.assert_allclose(table, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["sweep", "twrapped", "stream",
                                    "wrapped"])
def test_device_dist_leaves_the_field_on_the_device(solved, method):
    """device_dist=True returns the converged field as a tensor on the
    solver's device, equal to the host result and, within the solver
    tolerance, to the JAX solver's device-resident field."""
    gr, cg, U, jgr, jcg, _, src, D_sweep = solved
    solver = pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                              device="cpu")
    D = solver.solve(src, device_dist=True)
    assert isinstance(D.dist, torch.Tensor)
    assert D.dist.device == torch.device("cpu")
    host = solver.solve(src)
    np.testing.assert_array_equal(D.dist.numpy(), host.dist)
    np.testing.assert_array_equal(D.prev, host.prev)
    Dj = _jax_solver(jgr, jcg, U, method).solve(src, want_prev=False,
                                                device_dist=True)
    assert not isinstance(Dj.dist, np.ndarray)
    np.testing.assert_allclose(D.dist.numpy(), np.asarray(Dj.dist), rtol=0,
                               atol=TOL)


def test_device_dist_on_circulant_is_a_host_array(solved):
    """As in the JAX package, the plain oracle ignores device_dist."""
    gr, cg, U, *_, src, _ = solved
    solver = pt.AnnulusSolver(gr, None, None, U, method="circulant",
                              circulant=cg, device="cpu")
    D = solver.solve(src, want_prev=False, device_dist=True)
    assert isinstance(D.dist, np.ndarray)


def test_device_dist_on_diag_is_a_host_array(solved):
    """As in the JAX package, 'diag' returns full host rows whatever
    device_dist says."""
    gr, cg, U, *_, src, D_sweep = solved
    solver = pt.AnnulusSolver(gr, None, None, U, method="diag",
                              circulant=cg, device="cpu")
    D = solver.solve(src, device_dist=True)
    assert isinstance(D.dist, np.ndarray)
    np.testing.assert_allclose(D.dist, D_sweep.dist, rtol=0, atol=TOL)


class _OnCard(torch.Tensor):
    """Stands in for a tensor on the card: `numpy()` raises as it does for
    a CUDA tensor, and `.cpu()` gives a plain host tensor."""

    def numpy(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy. "
                        "Use Tensor.cpu() to copy the tensor to host memory "
                        "first.")

    def cpu(self, *args, **kwargs):
        return torch.Tensor(self.as_subclass(torch.Tensor)).clone()


def test_outputs_take_a_tensor_on_any_device(solved, tmp_path):
    """A `solve(device_dist=True)` result holds `dist` on the card:
    travel_times and save_solution_npz copy it to the host first."""
    gr, _, _, jgr, _, _, src, D = solved
    Dc = pt.BellmanFordMoore(prev=D.prev,
                             dist=torch.from_numpy(D.dist).as_subclass(_OnCard))
    with pytest.raises(TypeError, match="cuda"):
        np.asarray(Dc.dist)
    _, recs = _receivers(gr)
    fp = tmp_path / "card.csv"
    tt = pt.travel_times(Dc, gr, recs, isave=True, flname=str(fp))
    np.testing.assert_array_equal(tt, j_tt(D, jgr, recs))
    assert fp.read_text() == (tmp_path / "card.csv").read_text()
    pt.save_solution_npz(str(tmp_path / "card.npz"), Dc, gr, src)
    with np.load(tmp_path / "card.npz") as f:
        np.testing.assert_array_equal(f["dist"], D.dist)
        np.testing.assert_array_equal(f["prev"], D.prev)


def test_auto_without_sweep_support_raises():
    """ntheta=47 pads to 48 with one duplicate row, so it has no sweep
    support.  At 350k nodes or fewer the JAX package's auto route goes to
    twrapped, which refuses this wrap structure and falls on to 'wrapped'
    (81 duplicated lanes of 128): the port takes the same route and
    solves to the JAX package's explicit 'wrapped' field (off the TPU the
    JAX auto route takes 'circulant')."""
    gr, cg, U = pt.init_annulus_circulant(47, 6, 400.0)
    jgr, jcg, _ = rt.init_annulus_circulant(47, 6, 400.0)
    assert gr.nnods <= 350_000
    solver = pt.AnnulusSolver(gr, None, None, U, circulant=cg, device="cpu")
    assert solver.method == "wrapped"
    src = pt.closest_point(gr, np.deg2rad(33.0), pt.R, system="polar")
    d = solver.solve(src, want_prev=False).dist
    jsolver = _jax_solver(jgr, jcg, U, "wrapped")
    np.testing.assert_allclose(d, jsolver.solve(src, want_prev=False).dist,
                               rtol=0, atol=TOL)
    assert solver.last_iterations == jsolver.last_iterations


def test_explicit_twrapped_without_support_raises():
    """An explicit 'twrapped' on a grid it does not support falls on to
    'wrapped', in both packages."""
    gr, cg, U = pt.init_annulus_circulant(47, 6, 400.0)
    jgr, jcg, _ = rt.init_annulus_circulant(47, 6, 400.0)
    solver = pt.AnnulusSolver(gr, None, None, U, method="twrapped",
                              circulant=cg, device="cpu")
    jsolver = _jax_solver(jgr, jcg, U, "twrapped")
    assert solver.method == jsolver.method == "wrapped"
    src = pt.closest_point(gr, np.deg2rad(200.0), pt.R, system="polar")
    np.testing.assert_allclose(solver.solve(src, want_prev=False).dist,
                               jsolver.solve(src, want_prev=False).dist,
                               rtol=0, atol=TOL)
    assert solver.last_iterations == jsolver.last_iterations


@pytest.mark.parametrize("method", ["auto", "twrapped", "wrapped"])
def test_ntheta_127_goes_on_to_diag(method):
    """ntheta=127 has one duplicated lane of 128, which neither twrapped
    nor wrapped supports: auto, twrapped and wrapped all end at 'diag',
    whose field is the JAX package's explicit 'diag' field."""
    gr, cg, U = pt.init_annulus_circulant(127, 3, 500.0)
    jgr, jcg, _ = rt.init_annulus_circulant(127, 3, 500.0)
    solver = pt.AnnulusSolver(gr, None, None, U, method=method,
                              circulant=cg, device="cpu")
    assert solver.method == "diag"
    src = pt.closest_point(gr, np.deg2rad(91.0), pt.R, system="polar")
    d = solver.solve(src, want_prev=False).dist
    jsolver = _jax_solver(jgr, jcg, U, "diag" if method == "auto" else method)
    assert jsolver.method == "diag"
    np.testing.assert_allclose(d, jsolver.solve(src, want_prev=False).dist,
                               rtol=0, atol=TOL)
    assert solver.last_iterations == jsolver.last_iterations


def test_stream_solves_grid_without_sweep_support():
    gr, cg, U = pt.init_annulus_circulant(47, 6, 400.0)
    jgr, jcg, _ = rt.init_annulus_circulant(47, 6, 400.0)
    src = pt.closest_point(gr, np.deg2rad(33.0), pt.R, system="polar")
    solver = pt.AnnulusSolver(gr, None, None, U, method="stream",
                              circulant=cg, device="cpu")
    d = solver.solve(src, want_prev=False).dist
    jsolver = _jax_solver(jgr, jcg, U, "stream")
    np.testing.assert_allclose(d, jsolver.solve(src, want_prev=False).dist,
                               rtol=0, atol=TOL)
    assert solver.last_iterations == jsolver.last_iterations


def test_auto_routes_large_grid_without_sweep_support_to_stream():
    """Above 350k nodes a grid without sweep support goes to the streamed
    engine under auto (routing only; no solve at this size here)."""
    gr, cg, U = pt.init_annulus_circulant(1087, 300, 20.0)
    assert gr.nnods > 350_000
    assert not pt.ops.wrapped_t.supports_twrapped(cg)
    solver = pt.AnnulusSolver(gr, None, None, U, circulant=cg, device="cpu")
    assert solver.method == "stream"


def test_main_annulus_cli_on_cpu(tmp_path, capsys):
    prefix = tmp_path / "run"
    main_annulus.main(["--ntheta", "48", "--nr", "12", "--spacing", "150",
                       "--device", "cpu", "--out-prefix", str(prefix)])
    out = capsys.readouterr().out
    assert "solver method: sweep on cpu" in out
    lines = (tmp_path / "run_travel_times.csv").read_text().splitlines()
    assert lines[0] == "degree,travel_time" and len(lines) == 151
    with np.load(tmp_path / "run.npz") as f:
        assert f["dist"].shape == f["prev"].shape
        assert int(f["source"]) == int(f["path_0"][-1])


def test_main_annulus_cli_method_on_cpu(tmp_path, capsys):
    """--method takes the JAX driver's choices: each circulant engine runs
    and prints its iterations ('ell' and 'banded': the test below)."""
    for method in ("twrapped", "wrapped", "diag", "pallas", "fused"):
        prefix = tmp_path / method
        main_annulus.main(["--ntheta", "48", "--nr", "12", "--spacing", "150",
                           "--method", method, "--device", "cpu",
                           "--out-prefix", str(prefix)])
        out = capsys.readouterr().out
        assert f"solver method: {method} on cpu" in out
        assert "iterations" in out
        assert len((tmp_path / f"{method}_travel_times.csv").read_text()
                   .splitlines()) == 151


@pytest.mark.parametrize("method", ["ell", "banded"])
def test_main_annulus_graph_methods_equal_the_jax_cli(tmp_path, capsys,
                                                      monkeypatch, method):
    """--method ell and banded build the materialised graph with
    init_annulus, as the JAX driver does, and write the JAX CLI's travel
    times and npz at 48x12; 'ell' prints no iteration count, as the JAX
    driver does."""
    import runpy
    import sys

    args = ["--ntheta", "48", "--nr", "12", "--spacing", "150", "--method",
            method]
    monkeypatch.setattr(sys, "argv", ["main_annulus.py", *args,
                                      "--out-prefix", str(tmp_path / "j")])
    runpy.run_path(os.path.join(ROOT, "main_annulus.py"),
                   run_name="__main__")
    capsys.readouterr()
    main_annulus.main([*args, "--device", "cpu", "--out-prefix",
                       str(tmp_path / "p")])
    out = capsys.readouterr().out
    assert f"solver method: {method} on cpu" in out
    assert ("Converged in" in out) == (method == "banded")
    assert (tmp_path / "p_travel_times.csv").read_text() == \
        (tmp_path / "j_travel_times.csv").read_text()
    with np.load(tmp_path / "p.npz") as fp, np.load(tmp_path / "j.npz") as fj:
        for k in ("dist", "prev", "source"):
            np.testing.assert_array_equal(fp[k], fj[k])


def test_main_annulus_dtype_float64_equals_the_jax_cli(tmp_path, capsys,
                                                       monkeypatch):
    """--dtype float64 (the JAX CLI's option, default float32): the port's
    CLI solves in float64 on the CPU and writes the JAX CLI's travel
    times at a tiny grid (the JAX CLI runs its circulant engine there,
    the port its directional sweep: the same float64 fixpoint, within
    1e-9 s, the rounding of the same path sums in another order)."""
    import runpy
    import sys

    args = ["--ntheta", "16", "--nr", "4", "--spacing", "400", "--dtype",
            "float64"]
    monkeypatch.setattr(sys, "argv", ["main_annulus.py", *args,
                                      "--out-prefix", str(tmp_path / "j")])
    runpy.run_path(os.path.join(ROOT, "main_annulus.py"),
                   run_name="__main__")
    main_annulus.main([*args, "--device", "cpu", "--out-prefix",
                       str(tmp_path / "p")])
    out = capsys.readouterr().out
    assert "solver method: sweep on cpu" in out
    want = np.loadtxt(tmp_path / "j_travel_times.csv", delimiter=",",
                      skiprows=1)
    got = np.loadtxt(tmp_path / "p_travel_times.csv", delimiter=",",
                     skiprows=1)
    assert got.shape == want.shape == (150, 2)
    # the receivers' degrees: the JAX CLI's full mesh and the port's
    # circulant grid place the same nodes to the last bit or two
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-15, atol=0)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-9)
    with np.load(tmp_path / "p.npz") as f:
        assert f["dist"].dtype == np.float64
    assert main_annulus.build_parser().parse_args([]).dtype == "float32"


def _jax_cli_options() -> dict:
    """option -> (default, choices) of the root main_annulus.py, read
    from its source text (importing it would configure JAX)."""
    with open(os.path.join(ROOT, "main_annulus.py")) as f:
        tree = ast.parse(f.read())
    opts = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            name = node.args[0].value
            action = (ast.literal_eval(kw["action"]) if "action" in kw
                      else None)
            # argparse's implicit defaults of the flag actions
            implicit = {"store_true": False, "store_false": True}
            opts[name] = (ast.literal_eval(kw["default"]) if "default" in kw
                          else implicit.get(action),
                          ast.literal_eval(kw["choices"]) if "choices" in kw
                          else None)
    return opts


def test_main_annulus_defaults_equal_the_jax_cli():
    """Every option the port's CLI shares with the JAX package's
    main_annulus.py has that one's default and choices, so both write the
    same run (the 180x50 grid) when called with no arguments."""
    want = _jax_cli_options()
    assert want["--nr"] == (50, None)
    shared = 0
    for action in main_annulus.build_parser()._actions:
        for opt in action.option_strings:
            if opt in want:
                shared += 1
                assert (action.default, action.choices) == \
                    (want[opt][0], want[opt][1] and list(want[opt][1])), opt
    assert shared >= 5


def test_solver_parameters_are_jax_s():
    """AnnulusSolver takes the JAX package's parameters in the JAX
    package's order; `device` comes last."""
    port = list(inspect.signature(pt.AnnulusSolver).parameters)
    jax_ = list(inspect.signature(rt.AnnulusSolver).parameters)
    assert port[-1] == "device"
    assert port[:-1] == jax_


def test_circulant_cache_round_trip_with_jax(tmp_path):
    """The port's stencil cache writes the JAX package's file (same name,
    same keys) and reads the one the JAX package writes."""
    gr, A, halo = pt.init_annulus(16, 4, spacing=400.0)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r, prof.Vp))
    jgr, jA, jhalo = rt.init_annulus(16, 4, spacing=400.0)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    p_cg = p_cached(gr, A, halo, U, np.float32, str(port_dir))
    j_cg = j_cached(jgr, jA, jhalo, U, np.float32, str(jax_dir))
    assert os.listdir(port_dir) == os.listdir(jax_dir)
    name = os.listdir(port_dir)[0]
    with np.load(port_dir / name) as fp, np.load(jax_dir / name) as fj:
        assert sorted(fp.files) == sorted(fj.files)
        for k in fj.files:
            np.testing.assert_array_equal(fp[k], fj[k])
    # each package reads the other's file (an empty dir would rebuild)
    os.replace(jax_dir / name, port_dir / name)
    got = p_cached(gr, None, None, U, np.float32, str(port_dir))
    back = j_cached(jgr, None, None, U, np.float32, str(port_dir))
    for k in ("src_flat", "w", "fan_slots", "fan_w"):
        np.testing.assert_array_equal(getattr(got, k), getattr(j_cg, k))
        np.testing.assert_array_equal(getattr(back, k), getattr(p_cg, k))
    assert got.cmap.center == j_cg.cmap.center and got.n == j_cg.n
    solver = pt.AnnulusSolver(gr, A, halo, U, pt.SolverConfig(),
                              "diag", str(port_dir), device="cpu")
    np.testing.assert_array_equal(solver.circulant.w, j_cg.w)


def test_main_annulus_model_wave_equal_the_jax_cli(tmp_path, capsys,
                                                   monkeypatch):
    """--model iasp91 --wave Vs (the JAX CLI's options): the port's CLI
    solves the IASP91 Vs field and writes the JAX CLI's travel times at a
    tiny grid in float64 (the same fixpoint within 1e-9 s, as above),
    far from the AK135 Vp run's."""
    import runpy
    import sys

    args = ["--ntheta", "16", "--nr", "4", "--spacing", "400", "--dtype",
            "float64", "--model", "iasp91", "--wave", "Vs"]
    monkeypatch.setattr(sys, "argv", ["main_annulus.py", *args,
                                      "--out-prefix", str(tmp_path / "j")])
    runpy.run_path(os.path.join(ROOT, "main_annulus.py"),
                   run_name="__main__")
    main_annulus.main([*args, "--device", "cpu", "--out-prefix",
                       str(tmp_path / "p")])
    main_annulus.main([*args[:6], "--device", "cpu", "--out-prefix",
                       str(tmp_path / "vp")])
    want = np.loadtxt(tmp_path / "j_travel_times.csv", delimiter=",",
                      skiprows=1)
    got = np.loadtxt(tmp_path / "p_travel_times.csv", delimiter=",",
                     skiprows=1)
    vp = np.loadtxt(tmp_path / "vp_travel_times.csv", delimiter=",",
                    skiprows=1)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-9)
    assert (got[:, 1] > 1.5 * vp[:, 1]).all()     # S is slower than P
    parser = main_annulus.build_parser()
    assert (parser.parse_args([]).model, parser.parse_args([]).wave) == \
        ("ak135", "Vp")


def test_main_annulus_cache_dir_reads_the_jax_cache(tmp_path, capsys,
                                                    monkeypatch):
    """--cache-dir as in the JAX driver: init_annulus_cached for the grid
    and the solver's stencil cache.  The port's CLI writes the JAX CLI's
    files (same names), reads a cache the JAX CLI wrote without
    rewriting it, and both give the same travel times."""
    import runpy
    import sys

    args = ["--ntheta", "16", "--nr", "4", "--spacing", "400", "--dtype",
            "float64"]
    jdir, pdir = tmp_path / "jcache", tmp_path / "pcache"
    monkeypatch.setattr(sys, "argv", ["main_annulus.py", *args,
                                      "--cache-dir", str(jdir),
                                      "--out-prefix", str(tmp_path / "j")])
    runpy.run_path(os.path.join(ROOT, "main_annulus.py"),
                   run_name="__main__")
    main_annulus.main([*args, "--device", "cpu", "--cache-dir", str(pdir),
                       "--out-prefix", str(tmp_path / "cold")])
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert any(f.startswith("annulus_v1_16x4") for f in os.listdir(pdir))
    assert any(f.startswith("circ_v1_16x") for f in os.listdir(pdir))
    stamps = {f: os.path.getmtime(jdir / f) for f in os.listdir(jdir)}
    out = capsys.readouterr().out
    assert "solver method: sweep on cpu" in out and "init_annulus" in out
    main_annulus.main([*args, "--device", "cpu", "--cache-dir", str(jdir),
                       "--out-prefix", str(tmp_path / "warm")])
    assert {f: os.path.getmtime(jdir / f) for f in os.listdir(jdir)} == stamps
    want = np.loadtxt(tmp_path / "j_travel_times.csv", delimiter=",",
                      skiprows=1)
    for name in ("cold", "warm"):
        got = np.loadtxt(tmp_path / f"{name}_travel_times.csv",
                         delimiter=",", skiprows=1)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-9)


def test_main_annulus_plot_writes_the_figure(tmp_path, capsys):
    main_annulus.main(["--ntheta", "16", "--nr", "4", "--spacing", "400",
                       "--device", "cpu", "--plot", "--out-prefix",
                       str(tmp_path / "p")])
    assert os.path.getsize(tmp_path / "p_ray_paths.png") > 0


def test_main_annulus_plot_refuses_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib cannot be imported, --plot refuses by name before
    any solve (nothing is installed in its place, nothing is skipped)."""
    import builtins

    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    def no_solver(*a, **kw):
        raise AssertionError("a solver was built before the refusal")

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    monkeypatch.setattr(main_annulus, "AnnulusSolver", no_solver)
    with pytest.raises(ImportError, match="matplotlib"):
        main_annulus.main(["--ntheta", "16", "--nr", "4", "--spacing", "400",
                           "--device", "cpu", "--plot", "--out-prefix",
                           str(tmp_path / "p")])
    assert not os.listdir(tmp_path)


def test_main_annulus_prints_the_timer_report(tmp_path, capsys):
    """The sections' table of utils.timing.Timer, as the JAX driver
    prints it."""
    timer = main_annulus.main(["--ntheta", "16", "--nr", "4", "--spacing",
                               "400", "--device", "cpu", "--out-prefix",
                               str(tmp_path / "p")])
    out = capsys.readouterr().out
    assert timer.report() in out
    assert {"velocity", "init_annulus_circulant", "solver pack",
            "solve (steady)", "receivers+paths", "outputs"} <= \
        set(timer.totals)
