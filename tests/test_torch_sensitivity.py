"""PyTorch port: tomographic sensitivity kernels against the JAX package.

On the tiny annulus (16x6, its halo), float64, the Dijkstra prev tree of
a surface source: the host kernels `path_sensitivity` and
`path_sensitivity_dual` and the device ones `sensitivity_coo` and
`sensitivity_matrix` (the `paths` kernel's work; on the CPU its plain
twin) equal the JAX package's within 1e-12 relative to the largest entry
(the same float64 formulas; XLA may fuse the JAX side's products, so not
bit for bit; ids are equal bit for bit).  The homogeneity identity
sum_k U_k dt/dU_k = -t holds on every row within 1e-12 relative, the
JAX package's rules hold (a padded tail, a zero-cost twin hop and an
impassable pair add 0; (n, 2) duals raise on the device), and
`AnnulusSolver.sensitivity_matrix` equals the JAX solver's.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import R, SolverConfig
from raytracer_tpu.solvers import sensitivity as js
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.solvers import sensitivity as ps
from jax_mappings import below_the_map_limit  # noqa: F401,E402

F64 = SolverConfig(dtype="float64")
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= RTOL * scale


@pytest.fixture(scope="module")
def solved(tiny_annulus, tiny_velocity):
    gr, A, halo = tiny_annulus
    src = rt.closest_point(gr, 0.0, R, system="polar")
    D = rt.dijkstra(A, halo, src, gr, tiny_velocity, F64)
    recs = [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
            for d in (10.0, 60.0, 120.0, 200.0, 300.0)]
    return gr, A, halo, src, D, recs


def test_path_sensitivity_equals_jax(solved, tiny_velocity):
    gr, _, halo, src, D, recs = solved
    for r in recs:
        path = rt.recontruct_path(D.prev, src, r)
        want = js.path_sensitivity(gr, tiny_velocity, path, halo)
        got = pt.path_sensitivity(gr, tiny_velocity, path, halo)
        _close(got, want)
        # homogeneity: sum_k U_k dt/dU_k = -t
        np.testing.assert_allclose(np.dot(tiny_velocity, got),
                                   -D.dist[r], rtol=RTOL)
    with pytest.raises(ValueError, match="scalar"):
        pt.path_sensitivity(gr, np.stack([tiny_velocity] * 2, 1), path)
    assert not pt.path_sensitivity(gr, tiny_velocity, path[:1]).any()


def test_path_sensitivity_dual_equals_jax(solved, tiny_velocity):
    gr, A, halo, src, _, recs = solved
    Ud = np.stack([tiny_velocity, tiny_velocity * 1.01], axis=1)
    Dd = rt.dijkstra(A, halo, src, gr, Ud, F64)
    for r in recs:
        path = rt.recontruct_path(Dd.prev, src, r)
        want = js.path_sensitivity_dual(gr, Ud, path, halo)
        got = pt.path_sensitivity_dual(gr, Ud, path, halo)
        _close(got, want)
        np.testing.assert_allclose(np.sum(Ud * got), -Dd.dist[r],
                                   rtol=RTOL)


@pytest.mark.parametrize("max_len", [2, 40, 88])
def test_device_coo_and_dense_equal_jax(solved, tiny_velocity, max_len):
    gr, _, halo, src, D, recs = solved
    ij, vj = js.sensitivity_coo(gr, tiny_velocity, D.prev, src,
                                np.asarray(recs), max_len, halo)
    ip, vp = pt.sensitivity_coo(gr, tiny_velocity, D.prev, src, recs,
                                max_len, halo, device="cpu")
    assert ip.shape == (len(recs), 2 * (max_len - 1))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    _close(vp.numpy(), vj)
    Gj = js.sensitivity_matrix(gr, tiny_velocity, D.prev, src,
                               np.asarray(recs), max_len, halo)
    Gp = pt.sensitivity_matrix(gr, tiny_velocity, D.prev, src, recs,
                               max_len, halo, device="cpu")
    assert Gp.dtype == torch.float64
    _close(Gp.numpy(), Gj)
    if max_len == 88:   # deep enough to reach the source on every row
        np.testing.assert_allclose(Gp.numpy() @ tiny_velocity,
                                   -D.dist[recs], rtol=RTOL)


def test_device_rules(solved, tiny_velocity):
    """A padded tail, a twin hop and an impassable pair add 0; duals
    raise on the device."""
    gr, _, halo, src, D, _ = solved
    n = gr.nnods
    # a chain through a twin pair, then an impassable hop, then the
    # source, padded
    a, b = int(halo[0, 0]), int(halo[0, 1])
    c = int(np.flatnonzero(tiny_velocity > 0)[3])
    prev = np.arange(n)
    prev[a], prev[b], prev[c] = b, c, src
    U = np.array(tiny_velocity, np.float64)
    U[c] = -U[src]                               # U_c + U_src = 0
    ids, vals = pt.sensitivity_coo(gr, U, prev, src, [a], 6, halo,
                                   device="cpu")
    K = 5
    assert ids[0, :K].tolist() == [a, b, c, src, src]
    v = vals[0].numpy()
    assert v[0] == 0.0 and v[2] == 0.0 and v[3] == 0.0 and v[4] == 0.0
    assert v[1] < 0.0
    ij, vj = js.sensitivity_coo(gr, U, prev, src, np.asarray([a]), 6, halo)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ij))
    _close(vals.numpy(), vj)
    with pytest.raises(ValueError, match="scalar"):
        pt.sensitivity_matrix(gr, np.stack([U, U], 1), prev, src, [a], 6,
                              halo, device="cpu")


def test_solver_sensitivity_matrix_equals_jax(tiny_annulus, tiny_velocity):
    gr, A, halo = tiny_annulus
    src = rt.closest_point(gr, 0.0, R, system="polar")
    recs = [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
            for d in (40.0, 90.0, 250.0)]
    js_ = rt.AnnulusSolver(gr, A, halo, tiny_velocity, F64,
                           method="circulant")
    ps_ = pt.AnnulusSolver(gr, A, halo, tiny_velocity,
                           PC(dtype="float64"), method="circulant",
                           device="cpu")
    Dj, Dp = js_.solve(src), ps_.solve(src)
    np.testing.assert_array_equal(Dp.prev, Dj.prev)
    Gj = np.asarray(js_.sensitivity_matrix(Dj, src, recs))
    Gp = ps_.sensitivity_matrix(Dp, src, recs)
    assert Gp.device.type == "cpu" and Gp.shape == (3, gr.nnods)
    _close(Gp.numpy(), Gj)
    # the rows whose walk reaches the source within max_len (ROADMAP C.9:
    # a walk can meet a 2-cycle at a twin pair and never get there)
    ends = pt.backtrace_paths(Dp.prev, src, recs, 4 * (16 + 6),
                              device="cpu")[:, -1].numpy()
    done = ends == src
    assert done.sum() >= 2
    np.testing.assert_allclose((Gp.numpy() @ tiny_velocity)[done],
                               -np.asarray(Dp.dist)[recs][done], rtol=1e-9)


def _row_sums(nodes, g, n, dtype):
    """NumPy replay of the `paths` kernel's dense row: lam (the least p
    with nodes[K-p] == nodes[K]) and mu (the least i with nodes[i] ==
    nodes[i+lam]), then each first occurrence's column: its a-terms
    g[i'] (i' < K), then its b-terms g[i'-1] (i' >= 1), over its
    occurrences in order from +0.0, the source's tail of zero pairs as
    the one term g[mu-1]."""
    K = len(nodes) - 1
    lam = next((p for p in range(1, K + 1) if nodes[K - p] == nodes[K]), 0)
    mu = next(i for i in range(K + 1) if nodes[i] == nodes[i + lam]) \
        if lam else K + 1
    row = np.zeros(n, dtype)
    for i in range(min(mu + lam, K + 1)):
        occ = list(range(i, K + 1, lam)) if lam and i >= mu else [i]
        s = dtype(0.0)
        if lam == 1 and i >= mu and i < K and g[i] == 0:
            s = s + g[i - 1] if i >= 1 else s
        else:
            for j in occ:
                if j < K:
                    s = s + g[j]
            for j in occ:
                if j >= 1:
                    s = s + g[j - 1]
        row[nodes[i]] = s
    return row


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_row_sums_equal_the_twin_bit_for_bit(solved, tiny_velocity, dtype):
    gr, _, halo, src, D, recs = solved
    terms = ps._device_terms(gr, np.asarray(tiny_velocity, dtype), halo,
                             "cpu")
    n = gr.nnods
    # the Dijkstra tree, and the same tree with a 3-cycle that two walks
    # enter (ROADMAP C.9: its nodes' columns sum ~2 K/3 nonzero terms)
    cyc = np.asarray(D.prev).copy()
    a = rt.recontruct_path(D.prev, src, recs[2])[3]
    b, c = cyc[a], cyc[cyc[a]]
    cyc[c] = a
    looped = 0
    for prev in (np.asarray(D.prev), cyc):
        want = pt.ops.paths.paths_reference(
            torch.as_tensor(prev.astype(np.int32)), src,
            torch.as_tensor(np.asarray(recs, np.int32)), 88, terms,
            dense=True)
        for r in range(len(recs)):
            got = _row_sums(want.nodes[r].numpy(), want.vals[r].numpy(), n,
                            dtype)
            np.testing.assert_array_equal(got.view(np.uint8),
                                          want.dense[r].numpy()
                                          .view(np.uint8))
            hits = np.bincount(want.ids[r].numpy(),
                               weights=want.vals[r].numpy() != 0,
                               minlength=n)
            looped += int(hits.max() >= 3)
    assert looped >= 1 and {a, b, c} <= set(want.nodes[2].tolist())
