"""PyTorch port: AnnulusSolver end to end on the CPU against the JAX
package's prev recovery, paths and travel-time CSV; the ported methods,
travel-time tables and device-resident fields against the JAX
AnnulusSolver; the auto routing; and the port's refusals (no silent CPU
run, no silent engine change)."""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.ops.circulant import recover_prev_device as j_prev
from raytracer_tpu.solvers.path import recontruct_path as j_path
from raytracer_tpu.utils.io import travel_times as j_tt
from raytracer_tpu_torch import main_annulus

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


@pytest.mark.parametrize("method", ["ell", "banded", "wrapped", "diag",
                                    "pallas", "fused"])
def test_unported_methods_name_their_roadmap_item(solved, method):
    gr, cg, U, *_ = solved
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                         device="cpu")


def _jax_solver(jgr, jcg, U, method):
    return rt.AnnulusSolver(jgr, None, None, U, JConfig(dtype="float32"),
                            method=method, circulant=jcg)


@pytest.mark.parametrize("method", ["twrapped", "stream", "circulant"])
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
                                    "circulant"])
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


@pytest.mark.parametrize("method", ["sweep", "twrapped", "stream"])
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


def test_auto_without_sweep_support_raises():
    """ntheta=47 pads to 48 with one duplicate row, so it has no sweep
    support.  At 350k nodes or fewer the JAX package's auto route goes to
    twrapped, which refuses this wrap structure and falls on to
    'wrapped'/'diag' (ROADMAP A.11): the port says so instead of running
    another solver."""
    gr, cg, U = pt.init_annulus_circulant(47, 6, 400.0)
    assert gr.nnods <= 350_000
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        pt.AnnulusSolver(gr, None, None, U, circulant=cg, device="cpu")


def test_explicit_twrapped_without_support_raises():
    gr, cg, U = pt.init_annulus_circulant(47, 6, 400.0)
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        pt.AnnulusSolver(gr, None, None, U, method="twrapped", circulant=cg,
                         device="cpu")


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
    """--method takes the JAX driver's choices: a ported engine runs, an
    unported one raises naming its ROADMAP item."""
    prefix = tmp_path / "tw"
    main_annulus.main(["--ntheta", "48", "--nr", "12", "--spacing", "150",
                       "--method", "twrapped", "--device", "cpu",
                       "--out-prefix", str(prefix)])
    out = capsys.readouterr().out
    assert "solver method: twrapped on cpu" in out
    assert "iterations" in out
    assert len((tmp_path / "tw_travel_times.csv").read_text()
               .splitlines()) == 151
    with pytest.raises(NotImplementedError, match="ROADMAP A.11"):
        main_annulus.main(["--ntheta", "48", "--nr", "12", "--spacing",
                           "150", "--method", "wrapped", "--device", "cpu",
                           "--out-prefix", str(tmp_path / "w")])
