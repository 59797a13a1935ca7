"""PyTorch port: AnnulusSolver end to end on the CPU against the JAX
package's prev recovery, paths and travel-time CSV, and the port's
refusals (no silent CPU run, no silent engine change)."""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
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


@pytest.mark.parametrize("method", ["twrapped", "stream", "circulant",
                                    "ell", "banded", "wrapped", "diag",
                                    "pallas", "fused"])
def test_unported_methods_name_their_roadmap_item(solved, method):
    gr, cg, U, *_ = solved
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                         device="cpu")


def test_auto_without_sweep_support_raises():
    """ntheta=47 pads to 48 with one duplicate row: the JAX package's
    auto route re-routes it to twrapped/stream, which this slice does not
    carry - the port says so instead of running another solver."""
    gr, cg, U = pt.init_annulus_circulant(47, 6, 400.0)
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        pt.AnnulusSolver(gr, None, None, U, circulant=cg, device="cpu")


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
