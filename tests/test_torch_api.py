"""PyTorch port: AnnulusSolver end to end on the CPU against the JAX
package's prev recovery, paths and travel-time CSV; the ported methods,
travel-time tables and device-resident fields against the JAX
AnnulusSolver; the auto routing; the outputs of a device-resident
result; the CLI's defaults; the solver's parameters and stencil
cache; and the port's refusals (no silent CPU run, no silent engine
change)."""
import ast
import inspect
import os

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


@pytest.mark.parametrize("method", ["ell", "banded"])
def test_unported_methods_name_their_roadmap_item(solved, method):
    gr, cg, U, *_ = solved
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                         device="cpu")


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
    """--method takes the JAX driver's choices: a ported engine runs, an
    unported one raises naming its ROADMAP item."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        main_annulus.main(["--ntheta", "48", "--nr", "12", "--spacing",
                           "150", "--method", "ell", "--device", "cpu",
                           "--out-prefix", str(tmp_path / "p")])


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
            opts[name] = (ast.literal_eval(kw["default"]) if "default" in kw
                          else None,
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
