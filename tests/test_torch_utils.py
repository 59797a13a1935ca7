"""PyTorch port: the host utilities against the JAX package's.

The annulus cache (a file written by either package is read by the
other, field for field), the npz and MAT export, the ray-path figure,
the profiling hooks (`iteration_stats` equal to the JAX package's list,
`trace` writing a Chrome trace on the CPU), `Timer`, the coordinate
helpers and `discontinuity_mask`; and name parity: every public
top-level name of every module of the JAX package exists in the port's
module at the same path, and the JAX package's `__all__` is a subset of
the port's.
"""
import ast
import importlib
import json
import os

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.config import discontinuity_mask as j_mask
from raytracer_tpu.utils import cache as j_cache
from raytracer_tpu.utils import coords as j_coords
from raytracer_tpu.utils import io as j_io
from raytracer_tpu.utils import plotting as j_plot
from raytracer_tpu.utils import profiling as j_prof
from raytracer_tpu.utils import timing as j_timing
from raytracer_tpu_torch.config import discontinuity_mask as p_mask
from raytracer_tpu_torch.utils import cache as p_cache
from raytracer_tpu_torch.utils import coords as p_coords
from raytracer_tpu_torch.utils import io as p_io
from raytracer_tpu_torch.utils import plotting as p_plot
from raytracer_tpu_torch.utils import profiling as p_prof
from raytracer_tpu_torch.utils import timing as p_timing
from jax_mappings import below_the_map_limit  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "raytracer_tpu")
GRID_FIELDS = ("x", "z", "theta", "r", "e2n_flat", "e2n_off", "nbr_flat",
               "nbr_off", "is_quad", "twin_class")
# JAX names the port does not carry, each with its reason (none today:
# `*_jit` wrappers and `_make_*_kernel` builders are private names, which
# the parity rule leaves out, and PallasCircState is the port's pallas
# loop state)
PARITY_EXCEPTIONS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process: the suite runs several workers,
    and the twins' many small ops slow down badly when each worker's
    thread pool competes for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- caches


@pytest.fixture(scope="module")
def annulus_16x4():
    return (rt.init_annulus(16, 4, spacing=400.0),
            pt.init_annulus(16, 4, spacing=400.0))


def _grid_field(gr, name):
    if name in ("e2n_flat", "e2n_off"):
        return gr.flat_e2n()[name == "e2n_off"]
    if name in ("nbr_flat", "nbr_off"):
        return gr.flat_neighbours()[name == "nbr_off"]
    return getattr(gr, name)


def _same_annulus(a, b):
    (ga, Aa, ha), (gb, Ab, hb) = a, b
    for name in GRID_FIELDS:
        x, y = _grid_field(ga, name), _grid_field(gb, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (ga.ntheta, ga.nr, ga.nel, ga.nnods) == \
        (gb.ntheta, gb.nr, gb.nel, gb.nnods)
    np.testing.assert_array_equal(Aa.indptr, Ab.indptr)
    np.testing.assert_array_equal(Aa.indices, Ab.indices)
    np.testing.assert_array_equal(ha, hb)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_annulus_cache_is_read_by_the_other_package(tmp_path, annulus_16x4,
                                                    writer):
    """save_annulus of one package, load_annulus of the other: the same
    file name, every field equal to the build."""
    (j, p) = annulus_16x4
    save, load, built = ((j_cache.save_annulus, p_cache.load_annulus, j)
                         if writer == "jax" else
                         (p_cache.save_annulus, j_cache.load_annulus, p))
    path = save(str(tmp_path), 16, 4, 400.0, 1, *built)
    assert os.path.basename(path) == "annulus_v1_16x4_sp400_star1.npz"
    _same_annulus(load(str(tmp_path), 16, 4, 400.0, 1), built)
    assert p_cache.load_annulus(str(tmp_path), 16, 4, 300.0, 1) is None


def test_init_annulus_cached_writes_the_jax_file(tmp_path, annulus_16x4):
    """init_annulus_cached builds and writes on a miss, the JAX package's
    file byte for byte in its arrays, and reads it back on a hit."""
    j_dir, p_dir = tmp_path / "jax", tmp_path / "port"
    j_cache.init_annulus_cached(16, 4, 400.0, cache_dir=str(j_dir))
    got = p_cache.init_annulus_cached(16, 4, 400.0, cache_dir=str(p_dir))
    _same_annulus(got, annulus_16x4[1])
    assert os.listdir(j_dir) == os.listdir(p_dir)
    name = os.listdir(p_dir)[0]
    with np.load(j_dir / name) as fj, np.load(p_dir / name) as fp:
        assert sorted(fj.files) == sorted(fp.files)
        for k in fj.files:
            assert fj[k].dtype == fp[k].dtype, k
            np.testing.assert_array_equal(fj[k], fp[k], err_msg=k)
    mtime = os.path.getmtime(p_dir / name)
    _same_annulus(p_cache.init_annulus_cached(16, 4, 400.0,
                                              cache_dir=str(p_dir)),
                  annulus_16x4[1])
    assert os.path.getmtime(p_dir / name) == mtime


# ---------------------------------------------------------------- export


@pytest.fixture(scope="module")
def solution():
    gr, A, halo = pt.init_annulus(16, 4, spacing=400.0)
    prof = pt.velocity_profile("ak135")
    U = pt.interpolate_velocity(gr.r, pt.LinearInterpolation(prof.r, prof.Vp))
    solver = pt.AnnulusSolver(gr, A, halo, U, method="circulant",
                              device="cpu")
    src = pt.closest_point(gr, 0.0, pt.R, system="polar")
    D = solver.solve(src)
    recs = [pt.closest_point(gr, np.deg2rad(d), pt.R, system="polar")
            for d in (30.0, 90.0, 150.0)]
    paths = [pt.recontruct_path(D.prev, src, r) for r in recs]
    return gr, D, src, recs, paths


def test_load_solution_npz_reads_a_jax_archive(tmp_path, solution):
    gr, D, src, _, paths = solution
    j_io.save_solution_npz(str(tmp_path / "j.npz"), D, gr, src, paths)
    p_io.save_solution_npz(str(tmp_path / "p.npz"), D, gr, src, paths)
    for path in ("j.npz", "p.npz"):
        got = p_io.load_solution_npz(str(tmp_path / path))
        want = j_io.load_solution_npz(str(tmp_path / path))
        assert sorted(got[0]) == sorted(want[0])
        for a, b in zip(got[1:3], want[1:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3] == src
        assert len(got[4]) == len(paths)
        for a, b in zip(got[4], paths):
            np.testing.assert_array_equal(a, b)


def test_save_matfile_gives_the_jax_arrays(tmp_path, solution):
    from scipy.io import loadmat

    gr, D, _, _, paths = solution
    j_io.save_matfile(str(tmp_path / "j.mat"), D, gr, paths)
    tD = D._replace(dist=torch.from_numpy(D.dist))   # a tensor result too
    p_io.save_matfile(str(tmp_path / "p.mat"), tD, gr, paths)
    want, got = loadmat(tmp_path / "j.mat"), loadmat(tmp_path / "p.mat")
    keys = sorted(k for k in want if not k.startswith("__"))
    assert keys == sorted(k for k in got if not k.startswith("__"))
    assert "travel_time_path3" in keys
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------------- plotting


def _figure_data(fig):
    ax = fig.axes[0]
    return ([line.get_xydata() for line in ax.lines],
            [c.get_offsets() for c in ax.collections],
            [(p.center, p.radius) for p in ax.patches])


def test_plot_paths_draws_the_jax_figure(tmp_path, solution):
    gr, _, src, recs, paths = solution
    jfig = j_plot.plot_paths(gr, paths, src, recs)
    pfig = p_plot.plot_paths(gr, paths, src, recs,
                             fname=str(tmp_path / "rays.png"))
    (jl, jc, jp), (pl, pc, pp) = _figure_data(jfig), _figure_data(pfig)
    assert len(pl) == len(jl) == 1 + 8 + len(paths)
    for a, b in zip(pl + pc, jl + jc):
        np.testing.assert_array_equal(a, b)
    assert pp == jp
    assert os.path.getsize(tmp_path / "rays.png") > 0
    for a, b in zip(p_plot.layers2plot(), j_plot.layers2plot()):
        np.testing.assert_array_equal(a, b)


def test_plotting_without_matplotlib_refuses_by_name(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        p_plot.require_matplotlib()


# ------------------------------------------------------------- profiling


@pytest.fixture(scope="module")
def circulant_24x12():
    gr, cg, _ = pt.init_annulus_circulant(24, 12, 250.0)
    _, jcg, _ = rt.init_annulus_circulant(24, 12, 250.0)
    src = pt.closest_point(gr, 0.0, pt.R, system="polar")
    return gr, cg, jcg, src


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_iteration_stats_equal_the_jax_list(circulant_24x12, dtype):
    """The host-stepped circulant solve records the JAX package's
    statistics step for step, as many as the circulant solve's
    iterations."""
    gr, cg, jcg, src = circulant_24x12
    got = p_prof.iteration_stats(cg, src, pt.SolverConfig(dtype=dtype),
                                 device="cpu")
    want = j_prof.iteration_stats(jcg, src, rt.SolverConfig(dtype=dtype))
    assert got == want
    assert type(got[0]).__name__ == "IterationStat"
    assert got[0]._fields == want[0]._fields
    solver = pt.AnnulusSolver(gr, None, None, None, pt.SolverConfig(dtype=dtype),
                              method="circulant", circulant=cg, device="cpu")
    solver.solve(src, want_prev=False)
    assert len(got) == solver.last_iterations
    assert got[-1].improved_nodes == 0 and got[0].improved_nodes > 0


def test_iteration_stats_stops_at_max_iters(circulant_24x12):
    _, cg, jcg, src = circulant_24x12
    got = p_prof.iteration_stats(cg, src, max_iters=3, device="cpu")
    assert got == j_prof.iteration_stats(jcg, src, max_iters=3)
    assert len(got) == 3


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, circulant_24x12):
    gr, cg, _, src = circulant_24x12
    solver = pt.AnnulusSolver(gr, None, None, None, method="circulant",
                              circulant=cg, device="cpu")
    with p_prof.trace(str(tmp_path / "prof")) as prof:
        solver.solve(src, want_prev=False)
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


# ------------------------------------------------- timing, coords, config


def test_timer_equals_the_jax_one(monkeypatch):
    """The same sections, calls and report (the clock read is patched to
    a fixed sequence for both)."""
    reports = []
    for mod in (j_timing, p_timing):
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 4.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        t = mod.Timer()
        for name in ("solve", "pack", "solve"):
            with t.section(name):
                pass
        reports.append((dict(t.totals), dict(t.counts), t.report()))
    assert reports[0] == reports[1]
    assert reports[1][1] == {"solve": 2, "pack": 1}


@pytest.mark.parametrize("name", ["polar2cartesian", "cartesian2polar",
                                  "distance2d", "polardistance",
                                  "arclength", "spherical2cart",
                                  "distance3d"])
def test_coords_equal_the_jax_ones(name):
    rng = np.random.default_rng(7)
    nargs = {"polar2cartesian": 2, "cartesian2polar": 2, "distance2d": 4,
             "polardistance": 4, "arclength": 3, "spherical2cart": 3,
             "distance3d": 6}[name]
    args = [rng.uniform(-7000.0, 7000.0, 33) for _ in range(nargs)]
    got = getattr(p_coords, name)(*args)
    want = getattr(j_coords, name)(*args)
    for a, b in zip(np.atleast_1d(got) if not isinstance(got, tuple)
                    else got, np.atleast_1d(want)
                    if not isinstance(want, tuple) else want):
        np.testing.assert_array_equal(a, b)
    scalar = getattr(p_coords, name)(*[float(a[0]) for a in args])
    assert np.allclose(scalar, getattr(j_coords, name)(
        *[float(a[0]) for a in args]))


def test_discontinuity_mask_equals_the_jax_one(annulus_16x4):
    gr = annulus_16x4[1][0]
    got = p_mask(gr.r)
    np.testing.assert_array_equal(got, j_mask(gr.r))
    assert got.sum() > 0 and not got.all()


# ----------------------------------------------------------- name parity


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                out.append(rel)
    return sorted(out)


def _defined_public_names(path):
    """Top-level functions, classes and assigned names not starting with
    an underscore (imports are left out: they are the module's tools,
    not its interface)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_jax_name_is_in_the_port(rel):
    """The port's module at the same path exists and binds every public
    top-level name the JAX module defines."""
    mod = rel[:-3].replace(os.sep, ".")
    if mod.endswith("__init__"):
        mod = mod[: -len(".__init__")] if "." in mod else ""
    name = "raytracer_tpu_torch" + ("." + mod if mod else "")
    port = importlib.import_module(name)
    missing = sorted(n for n in _defined_public_names(
        os.path.join(JAX_PKG, rel)) if not hasattr(port, n)
        and n not in PARITY_EXCEPTIONS.get(rel, ()))
    assert not missing, f"{name} lacks {missing}"


def test_jax_all_is_a_subset_of_the_port_all():
    missing = sorted(set(rt.__all__) - set(pt.__all__))
    assert not missing, missing
    assert all(hasattr(pt, n) for n in pt.__all__)
