"""PyTorch port: the Bellman-Ford-Moore solver and its kernel's twin.

`ops/relax.bfm_step_reference` against the JAX package's `bfm_step`
iteration by iteration (dist, prev and frontier bit-equal) on the 16x6
annulus with its halo twins, with dual and S-wave velocities, on the
small Delaunay mesh and with three sources side by side (the vmapped
state), in float32 and float64; the halo's duplicate-destination rule
pinned against the JAX package in and out of its jitted loop; `bfm`,
`solve`, `solve_many`, `bfm3d`, `radius_stepping`, `weight_matrix`,
`dijkstra` and `PrevRecovery` equal to the JAX package's; a JAX-packed
DeviceGraph through `convert`; and a NumPy replay of csrc/ell_bfm.cu's
work partition (the row-prefix read, the first-slot rule of the warp
reduction, the per-destination halo walk, the frontier) bit-equal to the
twin; `DeviceGraph.symmetric` on the meshes and on graphs with directed
edges taken out; the push frontier (an improved row flags its
neighbours) equal to the twin's pull on symmetric graphs at every step
of whole solves, with and without a level mask, the states equal to the
JAX package's `bfm_step` (and its masked step); and a NumPy replay of the
push kernel's work partition bit-equal to the twin.  The kernel itself
runs only on the card (chip_smoke.py).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import SolverConfig as JC
from raytracer_tpu.models.annulus import node_adjacency as j_node_adjacency
from raytracer_tpu.models.delaunay import add_midpoints, triangle_annulus_2d
from raytracer_tpu.ops import relax as jrelax
from raytracer_tpu.ops.circulant import PrevRecovery as JPrevRecovery
from raytracer_tpu.solvers import bfm as jbfm
from raytracer_tpu.solvers import radius_stepping as jrs
import raytracer_tpu_torch as pt
from raytracer_tpu_torch import convert
from raytracer_tpu_torch.config import SolverConfig as PC
from raytracer_tpu_torch.ops import relax as prelax
from raytracer_tpu_torch.solvers import bfm as pbfm
from raytracer_tpu_torch.solvers import radius_stepping as prs

NO_HALO = np.empty((0, 2), np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _velocities(gr):
    prof = rt.velocity_profile("ak135")
    vp = rt.LinearInterpolation(prof.r, prof.Vp)
    return {"Vp": rt.interpolate_velocity(gr.r, vp),
            "Vs": rt.interpolate_velocity(
                gr.r, rt.LinearInterpolation(prof.r, prof.Vs)),
            "dual": rt.dual_velocity(gr.r, vp)}


@pytest.fixture(scope="module")
def graphs():
    gr, A, halo = rt.init_annulus(16, 6, spacing=200.0)
    dg = add_midpoints(triangle_annulus_2d(nr=12, spacing=500.0))
    dA = j_node_adjacency(dg, star=0)
    return {"16x6": (gr, A, halo, _velocities(gr)),
            "delaunay": (dg, dA, NO_HALO, _velocities(dg))}


def _src(gr, deg=0.0):
    return rt.closest_point(gr, np.deg2rad(deg), rt.R, system="polar")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what}: {int((a != b).sum())} differ"


CASES = [("16x6", "Vp", 1), ("16x6", "dual", 1), ("16x6", "Vs", 1),
         ("16x6", "Vp", 3), ("delaunay", "Vp", 1), ("delaunay", "Vp", 2)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-S{c[2]}")
def test_bfm_step_reference_matches_jax_step_by_step(graphs, case, dtype):
    name, vel, S = case
    gr, A, halo, U = graphs[name]
    jg = jbfm.prepare(A, halo, gr, U[vel], JC(dtype=dtype))
    pg = pbfm.prepare(A, halo, gr, U[vel], PC(dtype=dtype), device="cpu")
    _same(pg.w.numpy(), np.asarray(jg.w), "weights")
    srcs = [_src(gr, d) for d in (0.0, 100.0, 230.0)[:S]]
    if S == 1:
        js = jrelax.init_state(jg, jnp.asarray(srcs[0], jnp.int32),
                               jnp.dtype(dtype))
        jstep = jrelax.bfm_step
        ps = prelax.init_state(pg, srcs[0], dtype)
    else:
        js = jax.vmap(lambda s: jrelax.init_state(jg, s, jnp.dtype(dtype)))(
            jnp.asarray(srcs, jnp.int32))
        jstep = jax.vmap(jrelax.bfm_step, in_axes=(0, None))
        ps = prelax.init_state(pg, srcs, dtype)
    for k in range(1000):
        for f in ("dist", "prev", "front"):
            _same(getattr(ps, f).numpy(), getattr(js, f), f"{f} at step {k}")
        assert int(ps.it) == k
        if not bool(np.asarray(js.front).any()):
            break
        assert int(ps.live) == 1
        js = jstep(js, jg)
        ps = prelax.bfm_step(ps, pg)
    assert int(ps.live) == 0 and k > 10
    # a step after the frontier empties changes nothing
    again = prelax.bfm_step(ps, pg)
    assert again is ps or all(torch.equal(a, b) for a, b in zip(again, ps))


def _dup_graph():
    """Two equal-length paths 0-1-3 and 0-2-4, and halo rows (3, 5) and
    (4, 5): in the second iteration both rows win the same value for 5."""
    class G:
        x = np.array([0.0, 1.0, -1.0, 2.0, -2.0, 0.0])
        z = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 10.0])
        r = np.hypot(x, z)

    edges = [(0, 1), (0, 2), (1, 3), (2, 4)]
    rows = [a for a, b in edges] + [b for a, b in edges]
    cols = [b for a, b in edges] + [a for a, b in edges]
    A = sp.csr_matrix((np.ones(len(rows), bool), (rows, cols)), shape=(6, 6))
    A.sort_indices()
    return G, A, np.array([[3, 5], [4, 5]]), np.ones(6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_duplicate_destination_resolves_to_the_last_row(dtype):
    """Both halo rows of node 5 win with one value: the JAX package keeps
    the LAST row's predecessor (node 2's path), in its jitted loop, its
    vmapped loop and eagerly, and so does init_state's pre-pointing
    (prev[5] = 4); the port gives the same."""
    G, A, halo, U = _dup_graph()
    jg = jbfm.prepare(A, halo, G, U, JC(dtype=dtype))
    pg = pbfm.prepare(A, halo, G, U, PC(dtype=dtype), device="cpu")
    j_init = jrelax.init_state(jg, jnp.asarray(0, jnp.int32), jnp.dtype(dtype))
    p_init = prelax.init_state(pg, 0, dtype)
    assert int(np.asarray(j_init.prev)[5]) == int(p_init.prev[5]) == 4
    j_loop = jbfm._solve_jit(jg, jnp.asarray(0, jnp.int32), 100, dtype)
    j_many = jbfm._solve_many_jit(jg, jnp.asarray([0, 0], jnp.int32), 100,
                                  dtype)
    p_state = pbfm.solve_state(pg, 0, PC(dtype=dtype))
    p_many = pbfm.solve_state(pg, [0, 0], PC(dtype=dtype))
    assert int(np.asarray(j_loop.prev)[5]) == 2
    _same(p_state.prev.numpy(), j_loop.prev, "prev, jitted loop")
    _same(p_state.dist.numpy(), j_loop.dist, "dist, jitted loop")
    _same(p_many.prev.numpy(), j_many.prev, "prev, vmapped loop")
    j_eager = j_init
    p_eager = p_init
    for _ in range(3):
        j_eager = jrelax.bfm_step(j_eager, jg)
        p_eager = prelax.bfm_step(p_eager, pg)
        _same(p_eager.prev.numpy(), j_eager.prev, "prev, eager")
    assert int(p_state.it) == int(j_loop.it) == 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bfm_and_aliases_equal_jax(graphs, dtype):
    gr, A, halo, U = graphs["16x6"]
    src = _src(gr)
    want = rt.bfm(A, halo, src, gr, U["Vp"], JC(dtype=dtype))
    for fn in (pt.bfm, pt.bfm_gpu, pt.bfm_tpu):
        got = fn(A, halo, src, gr, U["Vp"], PC(dtype=dtype), device="cpu")
        _same(got.dist, want.dist, "dist")
        _same(got.prev, want.prev, "prev")
        assert got.dist.dtype == want.dist.dtype
        assert got.prev.dtype == want.prev.dtype


@pytest.mark.parametrize("name", ["16x6", "delaunay"])
def test_solve_and_solve_many_equal_jax(graphs, name):
    gr, A, halo, U = graphs[name]
    jg = jbfm.prepare(A, halo, gr, U["Vp"], JC())
    pg = pt.prepare(A, halo, gr, U["Vp"], PC(), device="cpu")
    srcs = [_src(gr, d) for d in (0.0, 45.0, 200.0)]
    for s in srcs[:1]:
        got, want = pt.solve(pg, s), rt.solve(jg, s)
        _same(got.dist, want.dist, "dist")
        _same(got.prev, want.prev, "prev")
    got, want = pt.solve_many(pg, srcs), rt.solve_many(jg, srcs)
    _same(got.dist, want.dist, "many dist")
    _same(got.prev, want.prev, "many prev")


@pytest.mark.parametrize("cap", [0, 1, 7])
def test_max_iters_cut_equals_jax(graphs, cap):
    gr, A, halo, U = graphs["16x6"]
    src = _src(gr)
    jg = jbfm.prepare(A, halo, gr, U["Vp"], JC())
    pg = pt.prepare(A, halo, gr, U["Vp"], PC(max_iters=cap), device="cpu")
    want = jbfm._solve_jit(jg, jnp.asarray(src, jnp.int32), cap, "float32")
    got = pbfm.solve_state(pg, src, PC(max_iters=cap))
    assert int(got.it) == int(want.it) == cap
    for f in ("dist", "prev", "front"):
        _same(getattr(got, f).numpy(), getattr(want, f), f)


def test_bfm3d_equals_jax():
    g = rt.grid3d((1.4, 1.4, rt.R - 600.0), (1.7, 1.7, rt.R), (6, 5, 4))
    A = rt.nodal_incidence3d(g)
    pg3 = pt.grid3d((1.4, 1.4, rt.R - 600.0), (1.7, 1.7, rt.R), (6, 5, 4))
    _same(pt.nodal_incidence3d(pg3).indices, A.indices, "3-D graph")
    prof = rt.velocity_profile("ak135")
    U = rt.LinearInterpolation(prof.r, prof.Vp)(g.r)
    src = len(g.r) - 3
    for dtype in ("float32", "float64"):
        want = rt.bfm3d(A, src, g, U, JC(dtype=dtype))
        got = pt.bfm3d(A, src, pg3, U, PC(dtype=dtype), device="cpu")
        _same(got.dist, want.dist, f"dist {dtype}")
        _same(got.prev, want.prev, f"prev {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_radius_stepping_equals_jax(graphs, dtype):
    gr, A, _, U = graphs["16x6"]
    src = _src(gr)
    jg = jbfm.prepare(A, NO_HALO, gr, U["Vp"], JC(dtype=dtype))
    pg = pt.prepare(A, NO_HALO, gr, U["Vp"], PC(dtype=dtype), device="cpu")
    j_st = jrs._solve_jit(jg, jnp.asarray(src, jnp.int32), 100_000, dtype)
    p_st = prs.solve_state(pg, src, PC(dtype=dtype))
    assert int(p_st.it) == int(j_st.it) > 100
    for f in ("dist", "prev", "unsettled", "front"):
        _same(getattr(p_st, f).numpy(), getattr(j_st, f), f)
    want = rt.radius_stepping(A, NO_HALO, src, gr, U["Vp"], JC(dtype=dtype))
    got = pt.radius_stepping(A, NO_HALO, src, gr, U["Vp"], PC(dtype=dtype),
                             device="cpu")
    _same(got.dist, want.dist, "dist")
    _same(got.prev, want.prev, "prev")


def test_radius_stepping_cut_equals_jax(graphs):
    gr, A, _, U = graphs["delaunay"]
    src = _src(gr)
    jg = jbfm.prepare(A, NO_HALO, gr, U["Vp"], JC())
    pg = pt.prepare(A, NO_HALO, gr, U["Vp"], PC(), device="cpu")
    j_st = jrs._solve_jit(jg, jnp.asarray(src, jnp.int32), 37, "float32")
    p_st = prs.solve_state(pg, src, PC(max_iters=37))
    assert int(p_st.it) == int(j_st.it) == 37
    _same(p_st.dist.numpy(), j_st.dist, "dist")


@pytest.mark.parametrize("vel", ["Vp", "dual"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_weight_matrix_and_dijkstra_equal_jax(graphs, vel, dtype):
    gr, A, halo, U = graphs["16x6"]
    W = pt.weight_matrix(A, halo, gr, U[vel], PC(dtype=dtype))
    Wj = rt.weight_matrix(A, halo, gr, U[vel], JC(dtype=dtype))
    assert pt.weights is pt.weight_matrix
    _same(W.indptr, Wj.indptr, "indptr")
    _same(W.indices, Wj.indices, "indices")
    _same(W.data, Wj.data, "data")
    src = _src(gr, 30.0)
    got = pt.dijkstra(A, halo, src, gr, U[vel], PC(dtype=dtype))
    want = rt.dijkstra(A, halo, src, gr, U[vel], JC(dtype=dtype))
    _same(got.dist, want.dist, "dist")
    _same(got.prev, want.prev, "prev")
    assert got.prev.dtype == want.prev.dtype


@pytest.mark.parametrize("name", ["16x6", "delaunay"])
def test_prev_recovery_equals_jax(graphs, name):
    gr, A, halo, U = graphs[name]
    D = rt.dijkstra(A, halo, _src(gr), gr, U["Vp"], JC(dtype="float64"))
    got = pt.PrevRecovery(gr, A, halo, U["Vp"])(D.dist)
    want = JPrevRecovery(gr, A, halo, U["Vp"])(D.dist)
    _same(got, want, "prev")
    assert got.dtype == want.dtype
    _same(pt.recover_prev(gr, A, halo, U["Vp"], D.dist), want, "prev")


def test_convert_device_graph_from_jax(graphs):
    """A DeviceGraph packed by the JAX package, carried over as NumPy,
    solves to the JAX package's floats."""
    gr, A, halo, U = graphs["16x6"]
    jg = jbfm.prepare(A, halo, gr, U["Vp"], JC(dtype="float64"))
    pg = convert.device_graph_from_numpy(
        np.asarray(jg.nbr), np.asarray(jg.w), np.asarray(jg.halo_src),
        np.asarray(jg.halo_dst), jg.n, "cpu")
    assert pg.w.dtype == torch.float64
    srcs = [_src(gr), 11]
    got = pt.solve_many(pg, srcs, PC(dtype="float64"))
    want = rt.solve_many(jg, srcs, JC(dtype="float64"))
    _same(got.dist, want.dist, "dist")
    _same(got.prev, want.prev, "prev")


def test_bfm_step_refuses_other_devices(graphs):
    gr, A, halo, U = graphs["16x6"]
    pg = pt.prepare(A, halo, gr, U["Vp"], PC(), device="cpu")
    st = prelax.init_state(pg, 3, "float32")
    with pytest.raises(ValueError, match="differ"):
        prelax.bfm_step(st._replace(dist=st.dist.double()), pg)
    meta = prelax.DeviceGraph(*[t.to("meta") if torch.is_tensor(t) else t
                                for t in pg])
    meta_st = prelax.BFMState(*[t.to("meta") for t in st])
    with pytest.raises(ValueError, match="cuda or cpu"):
        prelax.bfm_step(meta_st, meta)


# ----------------------------------------------------------------------
# a NumPy replay of csrc/ell_bfm.cu's work partition
# ----------------------------------------------------------------------

def _warp_argmin(d0, nbr_row, w_row, deg):
    """Lane l walks slots l, l+32, ... < deg keeping its first strict
    minimum; the xor-shuffle reduction takes the smaller value, the
    smaller slot on ties."""
    best = [(np.inf, 2 ** 31 - 1)] * 32
    for lane in range(32):
        v, kb = d0.dtype.type(np.inf), 2 ** 31 - 1
        for k in range(lane, deg, 32):
            c = d0[nbr_row[k]] + w_row[k]
            if c < v:
                v, kb = c, k
        best[lane] = (v, kb)
    for o in (16, 8, 4, 2, 1):
        nxt = []
        for lane in range(32):
            (v, k), (v2, k2) = best[lane], best[lane ^ o]
            nxt.append((v2, k2) if (v2 < v or (v2 == v and k2 < k))
                       else (v, k))
        best = nxt
    assert len(set(best)) == 1        # every lane holds the same pair
    return best[0]


def _kernel_replay(state, g):
    """One iteration as the two kernels compute it, row by row."""
    d0s = state.dist.numpy()
    p0s = state.prev.numpy()
    f0s = state.front.numpy()
    nbr, w = g.nbr.numpy(), g.w.numpy()
    deg, didx = g.deg.numpy(), g.didx.numpy()
    hoff, hsrc = g.hoff.numpy(), g.hsrc.numpy()
    S, n_pad = d0s.shape
    d1, p1 = d0s.copy(), p0s.copy()
    imp = np.zeros_like(f0s)

    def relaxed(r, d0, p0, f0):
        if not f0[r]:
            return d0[r], p0[r]
        best, kb = _warp_argmin(d0, nbr[r], w[r], deg[r])
        if best < d0[r]:
            return best, nbr[r, kb]
        return d0[r], p0[r]

    for b in range(S):
        d0, p0, f0 = d0s[b], p0s[b], f0s[b]
        for i in range(n_pad):
            v, p = relaxed(i, d0, p0, f0)
            if didx[i] >= 0:
                vd, m, pm = v, v, p
                for h in range(hoff[didx[i]], hoff[didx[i] + 1]):
                    s = hsrc[h]
                    vs, ps = relaxed(s, d0, p0, f0)
                    if vs < d0[s] and vd > vs:
                        if vs < m:
                            m, pm = vs, ps
                        elif vs == m:
                            pm = ps
                v, p = m, pm
            d1[b, i], p1[b, i], imp[b, i] = v, p, v < d0[i]
    f1 = np.zeros_like(f0s)
    for b in range(S):
        for i in range(n_pad):
            f1[b, i] = imp[b, i] or imp[b, nbr[i, : deg[i]]].any()
    return d1, p1, f1


def _random_tie_graph(rng, n, dtype):
    """A random graph whose weights are small integers, so that many
    candidates tie, with a halo of repeated destinations."""
    rows = np.repeat(np.arange(n), 6)
    cols = rng.integers(0, n, rows.size)
    keep = rows != cols
    A = sp.csr_matrix((np.ones(keep.sum(), bool), (rows[keep], cols[keep])),
                      shape=(n, n))
    A = ((A + A.T) > 0).tocsr()
    A.sort_indices()
    ell = pt.csr_to_ell(A, node_pad=64, degree_pad=8)
    w = np.where(ell.mask, rng.integers(1, 4, ell.nbr.shape), np.inf)
    hs = rng.integers(0, n, 12)
    hd = np.concatenate([rng.integers(0, n, 6), np.repeat(hs[:3], 2)])
    return prelax.device_graph(ell.nbr, w.astype(dtype), hs, hd, n, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_work_partition_replay_equals_twin(graphs, dtype):
    # the 16x6 halo graph: the frontier in the middle of a solve, S=2
    gr, A, halo, U = graphs["16x6"]
    pg = pt.prepare(A, halo, gr, U["Vp"], PC(dtype=dtype), device="cpu")
    st = prelax.init_state(pg, [_src(gr), _src(gr, 190.0)], dtype)
    for k in range(12):
        if k in (1, 6, 11):
            want = prelax.bfm_step_reference(st, pg)
            d1, p1, f1 = _kernel_replay(st, pg)
            _same(d1, want.dist.numpy(), "dist")
            _same(p1, want.prev.numpy(), "prev")
            _same(f1, want.front.numpy(), "front")
        st = prelax.bfm_step(st, pg)
    # ties everywhere and duplicate halo destinations
    rng = np.random.default_rng(7)
    g = _random_tie_graph(rng, 50, np.dtype(dtype))
    st = prelax.init_state(g, [0, 17], dtype)
    for _ in range(6):
        want = prelax.bfm_step_reference(st, g)
        d1, p1, f1 = _kernel_replay(st, g)
        _same(d1, want.dist.numpy(), "dist")
        _same(p1, want.prev.numpy(), "prev")
        _same(f1, want.front.numpy(), "front")
        st = want


# ----------------------------------------------------------------------
# the push frontier of csrc/ell_bfm.cu (push_step_kernel) on symmetric
# graphs
# ----------------------------------------------------------------------

def _cut_edges(g, n_cut, seed):
    """g with n_cut directed edges taken out (the slot pointed back at its
    row, weight +inf), rebuilt by device_graph."""
    nbr, w = g.nbr.numpy().copy(), g.w.numpy().copy()
    rng = np.random.default_rng(seed)
    rows = np.flatnonzero(g.deg.numpy()[:g.n] > 1)
    for i in rng.choice(rows, n_cut, replace=False):
        nbr[i, 0], w[i, 0] = i, np.inf
    return prelax.device_graph(nbr, w, g.halo_src.numpy(), g.halo_dst.numpy(),
                               g.n, "cpu")


def test_device_graph_symmetry_flag(graphs):
    """device_graph checks once whether the real slots are symmetric: true
    on init_annulus's graph (with its halo twins) and on the Delaunay
    mesh, false once a few directed edges are taken out (one is enough),
    and on a graph whose one edge runs one way."""
    for name in ("16x6", "delaunay"):
        gr, A, halo, U = graphs[name]
        g = pt.prepare(A, halo, gr, U["Vp"], PC(), device="cpu")
        assert g.symmetric is True
        assert _cut_edges(g, 5, 1).symmetric is False
        assert _cut_edges(g, 1, 2).symmetric is False
    nbr = np.array([[1, 0], [1, 1]], np.int32)
    deg = prelax.row_degrees(nbr)
    assert deg.tolist() == [1, 0]
    assert not prelax.real_slots_symmetric(nbr, deg)
    nbr = np.array([[1, 0, 0], [0, 1, 1], [2, 2, 2]], np.int32)
    assert prelax.real_slots_symmetric(nbr, prelax.row_degrees(nbr))


def _push_replay(state, g, mask=None, warps=7):
    """push_step_kernel in NumPy: the state copied through and the new
    frontier cleared; then the items (field, row) in each warp's order
    (warp gw takes gw, gw + W, ...), the ones in the frontier or at a halo
    destination relaxed and merged as the pull route's warp does; an
    improved row writes its value and predecessor and flags itself and
    its real slots' rows where the mask holds.  A state whose frontier
    is empty comes back as it is."""
    if not int(state.live):
        return state
    d0s, p0s, f0s = (state.dist.numpy(), state.prev.numpy(),
                     state.front.numpy())
    nbr, w, deg = g.nbr.numpy(), g.w.numpy(), g.deg.numpy()
    didx, hoff, hsrc = g.didx.numpy(), g.hoff.numpy(), g.hsrc.numpy()
    m = np.ones(nbr.shape[0], bool) if mask is None else mask.numpy()
    S, n_pad = d0s.shape
    d1, p1, f1 = d0s.copy(), p0s.copy(), np.zeros_like(f0s)

    def relaxed(r, d0, p0, f0):
        if not f0[r]:
            return d0[r], p0[r]
        best, kb = _warp_argmin(d0, nbr[r], w[r], deg[r])
        return (best, nbr[r, kb]) if best < d0[r] else (d0[r], p0[r])

    total = S * n_pad
    for gw in range(warps):
        for e in range(gw, total, warps):
            b, i = divmod(e, n_pad)
            d0, p0, f0 = d0s[b], p0s[b], f0s[b]
            if not (f0[i] or didx[i] >= 0):
                continue
            v, p = relaxed(i, d0, p0, f0)
            if didx[i] >= 0:
                vd, mn, pm = v, v, p
                for h in range(hoff[didx[i]], hoff[didx[i] + 1]):
                    s = hsrc[h]
                    vs, ps = relaxed(s, d0, p0, f0)
                    if vs < d0[s] and vd > vs:
                        if vs < mn:
                            mn, pm = vs, ps
                        elif vs == mn:
                            pm = ps
                v, p = mn, pm
            if not v < d0[i]:
                continue
            d1[b, i], p1[b, i] = v, p
            for j in [i] + nbr[i, : deg[i]].tolist():
                if m[j]:
                    f1[b, j] = True
    return prelax.BFMState(dist=torch.from_numpy(d1),
                           prev=torch.from_numpy(p1),
                           front=torch.from_numpy(f1), it=state.it + 1,
                           live=torch.tensor(int(f1.any()), dtype=torch.int32))


def _push_frontier(d0, d1, g, mask=None):
    """The push frontier alone, vectorised: every row that improved (d1 <
    d0) flags itself and the rows of its real slots, where the mask
    holds."""
    nbr, deg = g.nbr.numpy(), g.deg.numpy()
    f1 = np.zeros(d0.shape, bool)
    for b, i in zip(*np.nonzero(d1 < d0)):
        f1[b, i] = True
        f1[b, nbr[i, : deg[i]]] = True
    return f1 if mask is None else f1 & mask.numpy()


def _sym_tie_graph(rng, n, dtype):
    """_random_tie_graph with symmetric slots (its adjacency is A + A.T)."""
    g = _random_tie_graph(rng, n, dtype)
    assert g.symmetric
    return g


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["16x6", "delaunay", "ties"])
@pytest.mark.parametrize("masked", [False, True])
def test_push_replay_equals_the_pull_and_jax(graphs, case, dtype, masked):
    """On symmetric graphs the push equals the pull: the replay of the
    push route after every step of a whole solve (from init_state to an
    empty frontier) equals bfm_step_reference (dist, prev, front, it,
    live), and the JAX package's bfm_step (with the level mask: its
    _masked_step, bfm_step's frontier ANDed with the mask)."""
    rng = np.random.default_rng(3)
    if case == "ties":
        pg = _sym_tie_graph(rng, 50, np.dtype(dtype))
        srcs = [0, 17]
        jg = jrelax.DeviceGraph(nbr=jnp.asarray(pg.nbr.numpy()),
                                w=jnp.asarray(pg.w.numpy()),
                                halo_src=jnp.asarray(pg.halo_src.numpy()),
                                halo_dst=jnp.asarray(pg.halo_dst.numpy()),
                                n=pg.n)
    else:
        gr, A, halo, U = graphs[case]
        jg = jbfm.prepare(A, halo, gr, U["Vp"], JC(dtype=dtype))
        pg = pbfm.prepare(A, halo, gr, U["Vp"], PC(dtype=dtype),
                          device="cpu")
        srcs = [_src(gr), _src(gr, 190.0)]
    assert pg.symmetric
    n_pad = pg.nbr.shape[0]
    mask = torch.from_numpy(rng.random(n_pad) < 0.8) if masked else None
    mj = None if mask is None else jnp.asarray(mask.numpy())
    ps = prelax.init_state(pg, srcs, dtype, mask=mask)
    js = jax.vmap(lambda s: jrelax.init_state(jg, s, jnp.dtype(dtype)))(
        jnp.asarray(srcs, jnp.int32))
    if mj is not None:
        js = js._replace(front=js.front & mj)

    def jstep(s):
        s = jax.vmap(jrelax.bfm_step, in_axes=(0, None))(s, jg)
        return s if mj is None else s._replace(front=s.front & mj)

    for k in range(1000):
        for f in ("dist", "prev", "front"):
            _same(getattr(ps, f).numpy(), getattr(js, f), f"{f} at step {k}")
        assert int(ps.it) == k
        if not int(ps.live):
            break
        want = prelax.bfm_step_reference(ps, pg, mask=mask)
        _same(_push_frontier(ps.dist.numpy(), want.dist.numpy(), pg, mask),
              want.front.numpy(), f"push front at step {k}")
        assert int(want.live) == int(want.front.any())
        ps = want
        js = jstep(js)
    assert not bool(np.asarray(js.front).any()) and k > 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_push_kernel_replay_equals_twin(graphs, dtype):
    """push_step_kernel's work partition replayed (the items in its warps'
    order, the relaxation and merge of the pull route's warp, the writes
    of the improved rows only and their flags) equals bfm_step_reference
    on symmetric graphs: the 16x6 halo graph in the middle of a solve
    (S=2), and a tie-heavy graph with repeated halo destinations, with
    and without a level mask."""
    gr, A, halo, U = graphs["16x6"]
    pg = pt.prepare(A, halo, gr, U["Vp"], PC(dtype=dtype), device="cpu")
    st = prelax.init_state(pg, [_src(gr), _src(gr, 190.0)], dtype)
    for k in range(12):
        if k in (1, 6, 11):
            want = prelax.bfm_step_reference(st, pg)
            got = _push_replay(st, pg)
            for f in got._fields:
                _same(getattr(got, f).numpy(), getattr(want, f).numpy(), f)
        st = prelax.bfm_step(st, pg)
    rng = np.random.default_rng(7)
    g = _sym_tie_graph(rng, 50, np.dtype(dtype))
    for mask in (None, torch.from_numpy(rng.random(g.nbr.shape[0]) < 0.7)):
        st = prelax.init_state(g, [0, 17], dtype, mask=mask)
        for _ in range(6):
            want = prelax.bfm_step_reference(st, g, mask=mask)
            got = _push_replay(st, g, mask)
            for f in got._fields:
                _same(getattr(got, f).numpy(), getattr(want, f).numpy(), f)
            st = want
