"""PyTorch port: the native C++ adjacency builder (`native/`).

The port's copy of `graphbuild.cpp` builds with g++ at first use into the
package's `_build/` (named by a hash of the source, the flags and the
host CPU) and gives the matrix of its scipy twin `_node_adjacency_scipy`
and of the JAX package's `node_adjacency`, at star 0, 1 and 2, on the
deduplicated and the faithful annulus and on a Delaunay mesh.  Without
g++ on PATH the builder returns None and `node_adjacency` takes the
twin; with g++, a failed compile raises.
"""
import os
import shutil

import numpy as np
import pytest

import raytracer_tpu as rt
import raytracer_tpu_torch as pt
from raytracer_tpu.models import annulus as j_ann
from raytracer_tpu_torch import native
from raytracer_tpu_torch.models import annulus as p_ann
from jax_mappings import below_the_map_limit  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"dedup": False, "faithful": True}

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on PATH: the native route "
                                      "is not taken here")


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    faithful = MESHES[request.param]
    return (rt.init_annulus(16, 6, spacing=200.0, faithful=faithful),
            pt.init_annulus(16, 6, spacing=200.0, faithful=faithful))


def _same(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.data.dtype == b.data.dtype == bool and a.data.all()


@needs_gxx
@pytest.mark.parametrize("star", [0, 1, 2])
def test_native_equals_the_twin_and_the_jax_builder(meshes, star):
    (jgr, _, _), (gr, _, _) = meshes
    before = native.node_adjacency_native_flat.calls
    got = p_ann.node_adjacency(gr, star=star)
    assert native.node_adjacency_native_flat.calls == before + 1
    _same(got, p_ann._node_adjacency_scipy(gr, star=star))
    _same(got, j_ann.node_adjacency(jgr, star=star))


@needs_gxx
def test_native_on_a_delaunay_mesh():
    """The production mesher's triangles (star 0, as the generic-graph
    tests build them)."""
    dg = pt.add_midpoints(pt.triangle_annulus_2d(nr=6, spacing=1500.0))
    _same(p_ann.node_adjacency(dg, star=0),
          p_ann._node_adjacency_scipy(dg, star=0))


@needs_gxx
def test_ragged_wrapper_equals_the_flat_one(meshes):
    _, (gr, A, _) = meshes
    got = native.node_adjacency_native(list(gr.e2n), list(gr.neighbours),
                                       gr.nnods, 1)
    _same(got, A)


@needs_gxx
def test_library_lands_in_the_ignored_build_dir():
    native._load()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "raytracer_tpu_torch",
                                                 "_build")
    assert os.path.exists(path)
    assert os.path.basename(path).startswith("libgraphbuild_")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "raytracer_tpu_torch/_build/" in [ln.strip() for ln in f]


def test_library_name_follows_source_and_flags(monkeypatch, tmp_path):
    """A changed source or flag set names another library, so a stale
    one is never loaded."""
    base = native.library_path()
    src = tmp_path / "graphbuild.cpp"
    src.write_text(open(native._SRC).read() + "\n// changed\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    changed = native.library_path()
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    assert len({base, changed, native.library_path()}) == 3


def test_without_gxx_the_twin_is_taken(monkeypatch, meshes):
    """No g++ on PATH: the builder returns None and node_adjacency builds
    the scipy twin's matrix, as the JAX package's contract has it."""
    _, (gr, A, _) = meshes
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    e2n_flat, e2n_off = gr.flat_e2n()
    nbr_flat, nbr_off = gr.flat_neighbours()
    assert native.node_adjacency_native_flat(e2n_flat, e2n_off, nbr_flat,
                                             nbr_off, gr.nnods, 1) is None
    before = native.node_adjacency_native_flat.calls
    _same(p_ann.node_adjacency(gr, star=1), A)
    assert native.node_adjacency_native_flat.calls == before


@needs_gxx
def test_a_failed_compile_raises(monkeypatch, tmp_path):
    """With g++ present a compile error raises; nothing falls back."""
    gr, _, _ = pt.init_annulus(8, 3, spacing=800.0)
    bad = tmp_path / "graphbuild.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        p_ann.node_adjacency(gr, star=1)
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "_build"))


def test_cpp_source_includes_no_pytorch_header():
    with open(native._SRC) as f:
        includes = [ln for ln in f if ln.lstrip().startswith("#include")]
    assert includes
    for ln in includes:
        assert "torch" not in ln and "ATen" not in ln and "c10" not in ln, ln
