"""PyTorch port: nothing on the card's side needs JAX.

The machine with the GPU has PyTorch and the CUDA toolkit but no JAX, so
the port and chip_smoke.py must import neither jax, jaxlib nor anything
of the JAX package (not even its NumPy-only modules, whose package
__init__ loads JAX).  A subprocess that refuses those imports loads every
module of the port and builds the 180x63 tables; an AST scan checks the
sources; the kernel build goes through plain nvcc, never through
torch.utils.cpp_extension.
"""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "raytracer_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
BLOCKED = ("jax", "jaxlib", "raytracer_tpu")


def _sources():
    out = [SMOKE]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


_REFUSING_RUN = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys
    BLOCKED = {blocked!r}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("refused import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {root!r})
    import numpy as np
    import raytracer_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        raytracer_tpu_torch.__path__, "raytracer_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops.sweep_theta import (pack_rsweep_tables,
                                                     pack_sweep_tables)
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil
    gr, cg, U = init_annulus_circulant(180, 63, 20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    pack_sweep_tables(ws, cg, np.float32)
    (wdn, wup), rst = pack_rsweep_tables(ws, cg, np.float32)
    assert wdn.shape == (888, 256) and rst.MT == 840
    from raytracer_tpu_torch.ops.stream_t import _stream_tables
    from raytracer_tpu_torch.ops.wrapped_t import max_twrapped_batch
    wsj = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=1)
    assert wsj.wrows.shape == (488, 896) and max_twrapped_batch(wsj) >= 8
    _stream_tables(wsj, np.float32)
    import raytracer_tpu_torch as pt
    gr, cg, U = init_annulus_circulant(48, 12, 150.0)
    src = pt.closest_point(gr, 0.0, pt.R, system="polar")
    for method in ("twrapped", "stream", "wrapped", "diag", "circulant"):
        s = pt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg,
                             device="cpu")
        assert s.method == method
        assert np.isfinite(s.solve(src, want_prev=False).dist).all()
    for model in ("ak135", "iasp91", "ak135-true"):
        assert len(pt.velocity_profile(model).r) > 100
    g3 = pt.grid3d((1.4, 1.4, pt.R - 600.0), (1.7, 1.7, pt.R), (9, 6, 5))
    prof = pt.velocity_profile()
    U3 = pt.LinearInterpolation(prof.r, prof.Vp)(g3.r)
    d3, it3 = pt.solve3d(g3, U3, [3, 100], device="cpu")
    assert it3 > 0 and np.isfinite(d3).all()
    p3 = pt.recover_prev3d(g3, U3, d3, [3, 100], device="cpu")
    assert p3.shape == d3.shape
    from raytracer_tpu_torch import example_grid3d
    example_grid3d.main(["--n", "8", "8", "5", "--device", "cpu"])
    example_grid3d.main(["--n", "8", "8", "5", "--engine", "ell",
                         "--device", "cpu"])
    # the generic graphs: the Delaunay mesher, auto -> banded, ell, bfm,
    # dijkstra, radius stepping, the Gauss-Seidel banded solve
    import warnings
    dg = pt.add_midpoints(pt.triangle_annulus_2d(nr=6, spacing=1500.0))
    dA = pt.node_adjacency(dg, star=0)
    prof = pt.velocity_profile()
    dU = pt.interpolate_velocity(dg.r, pt.LinearInterpolation(prof.r,
                                                              prof.Vp))
    nohalo = np.empty((0, 2), np.int64)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        s = pt.AnnulusSolver(dg, dA, nohalo, dU, device="cpu")
    assert s.method == "banded" and np.isfinite(s.solve(5).dist).all()
    s = pt.AnnulusSolver(dg, dA, nohalo, dU, method="ell", device="cpu")
    assert np.isfinite(s.solve(5).dist).all()
    d_b = pt.bfm(dA, nohalo, 5, dg, dU, device="cpu").dist
    d_d = pt.dijkstra(dA, nohalo, 5, dg, dU).dist
    assert np.abs(d_b - d_d).max() < 1e-3
    assert np.isfinite(pt.radius_stepping(dA, nohalo, 5, dg, dU,
                                          device="cpu").dist).all()
    bg = pt.prepare_banded(dA, nohalo, dg, dU, device="cpu")
    assert np.isfinite(pt.solve_banded_gs(bg, [5])[0]).all()
    # the staged solvers: bfm_ms on its three engines, a named phase
    gt, At, ht = pt.init_annulus(16, 6, spacing=200.0)
    Ut = pt.interpolate_velocity(gt.r, pt.LinearInterpolation(prof.r,
                                                              prof.Vp))
    st = pt.closest_point(gt, 0.0, pt.R, system="polar")
    assert pt.partition_grid(gt).nlayers == 8
    for m in ("ell", "stream", "sweep"):
        assert np.isfinite(pt.bfm_ms(At, ht, st, gt, Ut, method=m,
                                     device="cpu").dist).sum() > 50
    assert np.isfinite(pt.phase_travel_times(At, ht, st, gt, Ut, "PcP",
                                             device="cpu")).sum() > 100
    # paths, bending refinement, sensitivity kernels
    sv = pt.AnnulusSolver(gt, At, ht, Ut, method="circulant", device="cpu")
    Dt = sv.solve(st)
    rt_ = [pt.closest_point(gt, np.deg2rad(d), pt.R, system="polar")
           for d in (30.0, 90.0)]
    G = sv.sensitivity_matrix(Dt, st, rt_)
    assert G.shape == (2, gt.nnods) and bool((G <= 0).all())
    assert pt.backtrace_paths(Dt.prev, st, rt_, 8, device="cpu").shape == (2, 8)
    t_ref = sv.refined_travel_times(st, rt_, m=16, iters=5)
    assert np.all(t_ref <= Dt.dist[rt_])
    # the faithful mesh on the native adjacency builder, the utilities
    import shutil
    from raytracer_tpu_torch import native
    gf, Af, hf = pt.init_annulus(16, 6, spacing=200.0, faithful=True)
    assert gf.nnods > gt.nnods and Af.nnz > 0
    if shutil.which("g++"):
        assert native.node_adjacency_native_flat.calls > 0
    from raytracer_tpu_torch.utils.profiling import iteration_stats
    from raytracer_tpu_torch.utils.timing import Timer
    gc, cgc, Uc = init_annulus_circulant(16, 4, 400.0)
    assert len(iteration_stats(cgc, 0, device="cpu")) > 1
    assert "section" in Timer().report()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("ISOLATED", len(names))
""")


def test_port_imports_and_builds_tables_without_jax(tmp_path):
    code = _REFUSING_RUN.format(blocked=BLOCKED, root=ROOT, smoke=SMOKE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_modules = int(proc.stdout.split("ISOLATED")[1])
    assert n_modules >= 31


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_name_no_jax_and_no_cpp_extension(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            mods = []
        for m in mods:
            assert m.split(".")[0] not in BLOCKED, f"{path}: imports {m}"
            assert "cpp_extension" not in m, f"{path}: imports {m}"
        if isinstance(node, ast.Attribute):
            assert node.attr != "cpp_extension", path
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert node.value.split(".")[0] not in BLOCKED or " " in node.value, \
                f"{path}: names module {node.value!r}"


@pytest.mark.parametrize(
    "path", sorted(os.path.join(PKG, "csrc", f)
                   for f in os.listdir(os.path.join(PKG, "csrc")))
    + [os.path.join(PKG, "native", "graphbuild.cpp")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_cuda_sources_include_no_pytorch_headers(path):
    """The kernels build with plain nvcc behind a C interface, and the
    host adjacency builder with plain g++: no PyTorch or ATen header,
    which would put the build at minutes."""
    with open(path) as f:
        includes = [ln for ln in f if ln.lstrip().startswith("#include")]
    assert includes
    for ln in includes:
        assert "torch" not in ln and "ATen" not in ln and "c10" not in ln, ln


def test_every_kernel_source_is_in_the_port():
    """The ported kernels, and the port's own (plane3d, the generic
    graphs' ell_bfm and banded, and paths and bend), build from the
    port's own csrc/."""
    have = set(os.listdir(os.path.join(PKG, "csrc")))
    assert {"rsweep.cu", "titer.cu", "band.cu", "witer.cu",
            "diag.cu", "sweep3d.cu", "relax.cu", "fused.cu", "plane3d.cu",
            "ell_bfm.cu", "banded.cu", "paths.cu", "bend.cu"} <= have


def test_port_has_its_own_velocity_tables():
    """The three velocity tables live in the port's data directory (the
    JAX package's copies are out of reach on the card's machine)."""
    from raytracer_tpu_torch.models import velocity

    assert velocity._DATA_DIR == os.path.join(PKG, "data")
    have = set(os.listdir(velocity._DATA_DIR))
    assert set(velocity._PROFILE_FILES.values()) <= have
    assert {"ak135", "iasp91", "ak135-true"} == set(velocity._PROFILE_FILES)


def test_build_directory_is_ignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        lines = [ln.strip() for ln in f]
    assert "raytracer_tpu_torch/_build/" in lines


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card here: the smoke run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, SMOKE], cwd=tmp_path,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    smoke run fails even where torch reports a card."""
    alone = tmp_path / "chip_smoke.py"
    with open(SMOKE) as f:
        alone.write_text(f.read())
    code = ("import runpy, torch; torch.cuda.is_available = lambda: True; "
            f"runpy.run_path({str(alone)!r}, run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "raytracer_tpu_torch" in proc.stderr
