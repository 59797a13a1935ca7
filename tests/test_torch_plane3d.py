"""PyTorch port: one directional plane pass of the 3-D sweep engine.

The port's `_plane_sweep3d` (on the CPU the plain twin
`ops.plane3d.plane_sweep3d_reference`) must equal the JAX package's
`_plane_sweep3d` bit for bit: per axis and direction, at star 1 and 2,
with and without `carry_init`, in float32 and float64, one source and a
batch (the JAX package vmaps).  The CUDA kernel `csrc/plane3d.cu` cannot
run here, so what it reads and where is replayed in NumPy on the same
tables (its skipped out-of-plane taps, its carry planes, the band split
over a cluster of blocks, the column exchange, its sum trees and
warp-owned scan levels) and held to the twin and to the JAX package;
the launch planner's routes, bytes and refusals are checked by hand; the premise that lets it
skip the taps that leave the plane (every such weight is +inf) is
asserted on the weights used; the scan levels alone
(`plane3d_scan_reference`) equal `_axis_scan` at odd and even line
lengths.  Inputs are made from seeded numpy; every comparison is exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raytracer_tpu as rt
from raytracer_tpu.config import R
from raytracer_tpu.config import SolverConfig as JConfig
from raytracer_tpu.models import grid3d as jg
from raytracer_tpu.solvers import solve3d as js
import raytracer_tpu_torch as pt
from raytracer_tpu_torch.config import SolverConfig as PConfig
from raytracer_tpu_torch.ops import plane3d as pp3
from raytracer_tpu_torch.solvers import solve3d as ps
from jax_mappings import below_the_map_limit  # noqa: F401,E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(dims, star, dtype):
    """The JAX package's and the port's prepared weights on the JAX
    kernel tests' wedge (theta, phi 80-100 deg, depth 600 km)."""
    c0 = (np.deg2rad(80.0), np.deg2rad(80.0), R - 600.0)
    c1 = (np.deg2rad(100.0), np.deg2rad(100.0), R)
    gj, gp = jg.grid3d(c0, c1, dims), pt.grid3d(c0, c1, dims)
    prof = rt.velocity_profile()
    U = rt.LinearInterpolation(prof.r, prof.Vp)(gj.r)
    jp = js.prepare3d(gj, U, JConfig(dtype=dtype), star=star)
    pk = ps.prepare3d(gp, U, PConfig(dtype=dtype), star=star, device="cpu")
    assert np.array_equal(jp.W_np, pk.W_np)
    return jp, pk


_CACHE = {}


def _both(star, dtype, dims=(9, 6, 5)):
    key = (star, dtype, dims)
    if key not in _CACHE:
        jp, pk = _weights(dims, star, dtype)
        Wt = torch.from_numpy(pk.W_np)
        Wj = jnp.asarray(jp.W_np)
        scj = tuple((jnp.asarray(a), jnp.asarray(b))
                    for a, b in js._scan_costs_of(jp.W_np, jp.shifts))
        sct = ps._scan_costs_of(Wt, pk.shifts)
        _CACHE[key] = (jp, pk, Wj, scj, Wt, sct)
    return _CACHE[key]


def _field(rng, shape, dtype, frac_inf=0.3):
    d = rng.uniform(0.0, 500.0, shape).astype(dtype)
    d[rng.random(shape) < frac_inf] = np.inf
    return d


def _carry(rng, kind, S, plane_shape, dtype):
    """carry_init of `kind`: None, one plane, or a tuple of planes."""
    if kind == "none":
        return None, None
    shp = plane_shape if S == 1 else (S,) + plane_shape
    planes = [_field(rng, shp, dtype, 0.2)
              for _ in range(1 if kind == "plane" else 2)]
    if kind == "plane":
        return jnp.asarray(planes[0]), torch.from_numpy(planes[0])
    return (tuple(jnp.asarray(p) for p in planes),
            tuple(torch.from_numpy(p) for p in planes))


def _plane_shape(shape, axis):
    return tuple(n for a, n in enumerate(shape) if a != axis)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("star", [1, 2])
@pytest.mark.parametrize("down", [True, False], ids=["down", "up"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_plane_sweep_equals_jax(axis, down, star, dtype):
    jp, pk, Wj, scj, Wt, sct = _both(star, dtype)
    rng = np.random.default_rng(100 * axis + 10 * star + int(down))
    d = _field(rng, pk.shape, dtype)
    lj = js._sweep_layout3d(Wj, scj, axis)
    lt = ps._sweep_layout3d(Wt, sct, axis)
    assert lt.trees is None          # the kernel's trees: on the card only
    want = np.asarray(js._plane_sweep3d(jnp.asarray(d), lj, axis, down,
                                        shifts=jp.shifts))
    got = ps._plane_sweep3d(torch.from_numpy(d), lt, axis, down,
                            shifts=pk.shifts)
    assert got.dtype == torch.from_numpy(d).dtype
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, d)


def _opened(pk, axis):
    """The weights with the box face across `axis` opened: a cross tap
    whose source leaves the box along `axis` only (its in-plane source
    inside) gets a finite weight, so the carry planes reach the field;
    a tap that leaves the plane keeps its +inf (the kernel's premise)."""
    W = pk.W_np.copy()
    n = pk.shape
    idx = np.meshgrid(*[np.arange(m) for m in n], indexing="ij")
    for s, sh in enumerate(pk.shifts):
        if sh[axis] == 0:
            continue
        inside = np.ones(n, bool)
        for a in (0, 1, 2):
            if a != axis:
                inside &= (idx[a] + sh[a] >= 0) & (idx[a] + sh[a] < n[a])
        leaves = (idx[axis] + sh[axis] < 0) | (idx[axis] + sh[axis] >= n[axis])
        W[s][inside & leaves] = 37.0
    return W


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("star,carry", [(1, "plane"), (2, "plane"),
                                        (2, "tuple")])
@pytest.mark.parametrize("down", [True, False], ids=["down", "up"])
def test_plane_sweep_carry_init_equals_jax(star, carry, down, dtype):
    """carry_init seeds the planes "before" the first one processed: one
    halo plane (the node-sharded solver's star-1 contract) or a tuple of
    them, padded with +inf to the stencil's reach.  The box face across
    the sweep axis is opened (`_opened`), so the carry reaches the
    field."""
    jp, pk, Wj, scj, Wt, sct = _both(star, dtype)
    axis = 0
    rng = np.random.default_rng(7 + star + int(down))
    d = _field(rng, pk.shape, dtype)
    W = _opened(pk, axis)
    Wt2 = torch.from_numpy(W)
    sc = ps._scan_costs_of(Wt2, pk.shifts)
    scj2 = tuple((jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
                 for a, b in sc)
    lj = js._sweep_layout3d(jnp.asarray(W), scj2, axis)
    lt = ps._sweep_layout3d(Wt2, sc, axis)
    cj, ct = _carry(rng, carry, 1, _plane_shape(pk.shape, axis), dtype)
    want = np.asarray(js._plane_sweep3d(jnp.asarray(d), lj, axis, down,
                                        carry_init=cj, shifts=jp.shifts))
    got = ps._plane_sweep3d(torch.from_numpy(d), lt, axis, down,
                            carry_init=ct, shifts=pk.shifts).numpy()
    assert np.array_equal(got, want)
    plain = np.asarray(js._plane_sweep3d(jnp.asarray(d), lj, axis, down,
                                         shifts=jp.shifts))
    assert not np.array_equal(plain, want)   # the carry took effect


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plane_sweep_batch_equals_jax_vmap(dtype):
    """S fields through the batch dimension equal the JAX package's
    vmapped pass source for source."""
    import jax

    jp, pk, Wj, scj, Wt, sct = _both(2, dtype)
    rng = np.random.default_rng(3)
    d = _field(rng, (3,) + pk.shape, dtype)
    for axis in (0, 2):
        lj = js._sweep_layout3d(Wj, scj, axis)
        lt = ps._sweep_layout3d(Wt, sct, axis)
        want = np.asarray(jax.vmap(lambda x: js._plane_sweep3d(
            x, lj, axis, True, shifts=jp.shifts))(jnp.asarray(d)))
        got = ps._plane_sweep3d(torch.from_numpy(d), lt, axis, True,
                                shifts=pk.shifts)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("star", [1, 2])
def test_taps_leaving_the_plane_meet_inf_weights(star):
    """The kernel skips a tap whose source leaves the box; the twin's
    roll wraps there instead.  They agree because every such weight is
    +inf: the premise, on the weights these tests use (the box faces
    masked by _shifted_weights, and the staged solves' region masks)."""
    _, pk, *_ = _both(star, "float32")
    n2, n1, n0 = pk.shape
    k, j, i = np.meshgrid(np.arange(n2), np.arange(n1), np.arange(n0),
                          indexing="ij")
    keep = k >= 2
    for W in (pk.W_np, ps.mask_region3d(pk.W_np, keep, pk.shifts)):
        # a tap that leaves the plane of some sweep axis: any component
        # out of the box
        for s, (dk, dj, di) in enumerate(pk.shifts):
            out = ((k + dk < 0) | (k + dk >= n2) | (j + dj < 0)
                   | (j + dj >= n1) | (i + di < 0) | (i + di >= n0))
            assert out.any() and np.isinf(W[s][out]).all(), (s, dk, dj, di)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 9, 35, 61, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scan_levels_equal_axis_scan(n, dtype):
    """The kernel's scans (the min component level by level in place, the
    sums read from the packed trees) give `_axis_scan`'s floats along
    both plane axes, at odd and even line lengths (the recursion's
    n % 2 case) and at one value (no level)."""
    rng = np.random.default_rng(n)
    for axis, shape in ((0, (n, 7)), (1, (5, n))):
        x = torch.from_numpy(_field(rng, shape, dtype))
        cf = torch.from_numpy(rng.uniform(1.0, 30.0, shape).astype(dtype))
        cb = torch.from_numpy(rng.uniform(1.0, 30.0, shape).astype(dtype))
        first = [slice(None)] * 2
        first[axis] = 0
        cf[tuple(first)] = float("inf")
        last = [slice(None)] * 2
        last[axis] = -1
        cb[tuple(last)] = float("inf")
        cb[rng.random(shape) < 0.1] = float("inf")
        want = pp3._axis_scan(x, cf, cb, axis)
        trees = pp3.scan_sum_trees(cf[None], cb[None], cf[None], cb[None])
        tf, tb = (trees[0][0], trees[1][0]) if axis == 0 else \
            (trees[2][0], trees[3][0])
        got = pp3.plane3d_scan_reference(x, tf, tb, axis)
        assert torch.equal(got, want), (n, axis)
        assert tf.shape[axis] == sum(m for _, m in pp3.tree_levels(n))


def _scan_line(F, G, tf, tb):
    """One warp's line scans of csrc/plane3d.cu, in place: the forward scan
    of F and the backward scan of G (the reversed line by index), level
    by level; all items of a level at once (they write disjoint values
    and read none of them)."""
    n = len(F)
    levels = pp3.tree_levels(n)
    for lev, (off, m) in enumerate(levels):
        i = np.arange(m // 2)
        p, h = ((2 * i + 2) << lev) - 1, 1 << lev
        F[p] = np.minimum(F[p - h] + tf[off + 2 * i + 1], F[p])
        G[n - 1 - p] = np.minimum(G[n - 1 - p + h] + tb[off + 2 * i + 1],
                                  G[n - 1 - p])
    for lev in range(len(levels) - 1, -1, -1):
        off, m = levels[lev]
        i = np.arange(1, (m - 1) // 2 + 1)
        q, h = ((2 * i + 1) << lev) - 1, 1 << lev
        F[q] = np.minimum(F[q - h] + tf[off + 2 * i], F[q])
        G[n - 1 - q] = np.minimum(G[n - 1 - q + h] + tb[off + 2 * i],
                                  G[n - 1 - q])


def _replay(d, W, trees, taps, down, carry, cluster=1, reach=1):
    """csrc/plane3d.cu replayed in NumPy, a cluster of `cluster` blocks a
    source: d (S, nA, p0, p1) with the sweep axis first, W (nA, ns, p0,
    p1), the four trees, the tap rows (shift, m, da, db), carry (S, nc,
    p0, p1) or None.  Block q holds rows [q R, q R + R) of the plane (R =
    ceil(p0 / cluster)) in its own band buffers, with 2 `reach` halo rows
    each side on a cluster, which the neighbour blocks write as they
    compute their edge rows, and reads only those: the in-plane taps two
    at a time, the first of a pair also over `reach` halo rows each side
    (the same floats as the neighbour's), the second from those; it
    scans the columns
    [q Cw, q Cw + Cw) along axis 0 (gathered from every band into its
    free buffers, written back as min(forward, backward)) and its rows
    along axis 1.  Output planes not yet written, and a block's buffers
    (halos too) at the start of each plane, are NaN, so reading one
    fails."""
    S, nA, p0, p1 = d.shape
    t0f, t0b, t1f, t1b = trees
    out = np.full_like(d, np.nan)
    R, Cw = -(-p0 // cluster), -(-p1 // cluster)
    hh = 2 * reach if cluster > 1 else 0
    hr = hh // 2
    assert R >= hh
    rows = [range(q * R, min(p0, q * R + R)) for q in range(cluster)]
    cols = [range(q * Cw, min(p1, q * Cw + Cw)) for q in range(cluster)]
    sgn = 1 if down else -1
    nc = 0 if carry is None else carry.shape[1]
    cross = [t for t in taps if t[1] >= 1]
    inpl = [t for t in taps if t[1] == 0]
    bb = np.arange(p1)

    for s in range(S):
        for j in range(nA):
            p = nA - 1 - j if down else j
            bufs = [np.full((3, R + 2 * hh, p1), np.nan, d.dtype)
                    for _ in range(cluster)]

            def store(q, bi, r, x):      # own row, and the neighbours' halos
                bufs[q][bi, r + hh] = x
                if r < hh and q > 0:
                    bufs[q - 1][bi, r + R + hh] = x
                if r >= len(rows[q]) - hh and (q + 1) * R < p0:
                    bufs[q + 1][bi, r - R + hh] = x

            def own(bi, a):              # row a in its owner's buffer bi
                return bufs[a // R][bi, a - (a // R) * R + hh]

            # 1. each block's rows: the input and the cross taps
            for q in range(cluster):
                for r, a in enumerate(rows[q]):
                    cur = d[s, p, a].copy()
                    for sft, m, da, db in cross:
                        na, nb = a + da, bb + db
                        ok = (0 <= na < p0) & (nb >= 0) & (nb < p1)
                        if j >= m:
                            prev = out[s, p + m * sgn]
                        elif m - 1 - j < nc:
                            prev = carry[s, m - 1 - j]
                        else:
                            continue
                        if not ok.any():
                            continue
                        src = prev[na][np.where(ok, nb, 0)]
                        assert not np.isnan(src[ok]).any()
                        cur = np.where(ok, np.minimum(cur, src + W[p, sft, a]),
                                       cur)
                    store(q, 0, r, cur)
            # 2. the in-plane taps, two at a time: the first of a pair
            # over each block's rows and hr halo rows each side (local, no
            # exchange), the second over its own rows, its edge rows hh
            # deep into the neighbours' halos; a lone last tap the same
            # way from A
            def one_tap(q, src_i, dst_i, sft, da, db, r, push):
                a = q * R + r
                na, nb = a + da, bb + db
                v = bufs[q][src_i, r + hh].copy()
                ok = (0 <= na < p0) & (nb >= 0) & (nb < p1)
                if ok.any():
                    src = bufs[q][src_i, na - q * R + hh]
                    assert not np.isnan(src[ok]).any()
                    cand = src[np.where(ok, nb, 0)] + W[p, sft, a]
                    v = np.where(ok, np.minimum(v, cand), v)
                if push:
                    store(q, dst_i, r, v)
                else:
                    bufs[q][dst_i, r + hh] = v

            ia, im, idn = 0, 1, 2
            t = 0
            while t < len(inpl):
                if t + 1 < len(inpl):
                    sft, _, da, db = inpl[t]
                    for q in range(cluster):
                        r0q = q * R
                        if not rows[q]:
                            continue
                        for r in range(max(-hr, -r0q),
                                       min(len(rows[q]) + hr, p0 - r0q)):
                            one_tap(q, ia, im, sft, da, db, r, False)
                    sft, _, da, db = inpl[t + 1]
                    for q in range(cluster):
                        for r in range(len(rows[q])):
                            one_tap(q, im, idn, sft, da, db, r, True)
                    ia, idn = idn, ia
                    t += 2
                else:
                    sft, _, da, db = inpl[t]
                    for q in range(cluster):
                        for r in range(len(rows[q])):
                            one_tap(q, ia, im, sft, da, db, r, True)
                    ia, im = im, ia
                    t += 1
            # 3. the axis-0 scans: block q's columns from every band
            for q in range(cluster):
                for b in cols[q]:
                    x = np.array([own(ia, a)[b] for a in range(p0)])
                    F, G = x.copy(), x.copy()
                    _scan_line(F, G, t0f[p][:, b], t0b[p][:, b])
                    for a in range(p0):
                        own(ia, a)[b] = min(F[a], G[a])
            # 4. the axis-1 scans of each block's rows: the output
            for q in range(cluster):
                for r, a in enumerate(rows[q]):
                    x = bufs[q][ia, r + hh]
                    F, G = x.copy(), x.copy()
                    _scan_line(F, G, t1f[p][a], t1b[p][a])
                    out[s, p, a] = np.minimum(F, G)
    return out


_JAX_PASSES: dict = {}


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("star,carry", [(1, "none"), (1, "plane"),
                                        (2, "none"), (2, "tuple")])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_replay_equals_twin(axis, star, carry, dtype, cluster):
    """What csrc/plane3d.cu reads and where, replayed on the host on the
    kernel's own tables (the tap rows, the sum trees) for S = 3 sources,
    both directions, on one block and on clusters of two and four (the
    test planes' rows split into bands of 5, 3 and 2, and an empty one,
    with two halo rows each side at star 1; star 2's four halo rows do
    not fit these bands, so it takes one block here and a taller plane
    in the next test),
    equals the plain twin, and (star 2 down, float64, without
    carry_init) the JAX package's `_plane_sweep3d` for each source."""
    import jax

    jp, pk, Wj, scj, Wt, sct = _both(star, dtype)
    if carry != "none":
        Wt = torch.from_numpy(_opened(pk, axis))
        sct = ps._scan_costs_of(Wt, pk.shifts)
    lt = ps._sweep_layout3d(Wt, sct, axis)
    trees = [t.numpy() for t in pp3.scan_sum_trees(*lt[1:5])]
    rng = np.random.default_rng(31 * axis + star)
    S = 3
    d = _field(rng, (S,) + pk.shape, dtype)
    pshape = _plane_shape(pk.shape, axis)
    _, ct = _carry(rng, carry, S, pshape, dtype)
    for down in (True, False):
        want = pp3.plane_sweep3d_reference(torch.from_numpy(d), lt, axis,
                                           down, ct, pk.shifts).numpy()
        taps = pp3._tap_table(pk.shifts, axis, down, "cpu").numpy().tolist()
        carry_np = None
        if ct is not None:
            planes = ct if isinstance(ct, tuple) else (ct,)
            carry_np = np.stack([p.numpy() for p in planes], axis=1)
        reach = pp3.plane3d_reach(pk.shifts, axis)
        p0 = _plane_shape(pk.shape, axis)[0]
        while cluster > 1 and -(-p0 // cluster) < 2 * reach:
            cluster //= 2      # the planner's bands hold 2 reach rows
        got = _replay(np.moveaxis(d, 1 + axis, 1), lt.W.numpy(), trees,
                      taps, down, carry_np, cluster, reach)
        got = np.moveaxis(got, 1, 1 + axis)
        assert np.array_equal(got, want), down
        if carry == "none" and dtype == "float64" and down and star == 2:
            key = (axis, star, dtype, down)
            if key not in _JAX_PASSES:
                lj = js._sweep_layout3d(Wj, scj, axis)
                _JAX_PASSES[key] = np.asarray(jax.vmap(
                    lambda x: js._plane_sweep3d(x, lj, axis, down,
                                                shifts=jp.shifts))(
                    jnp.asarray(d)))
            assert np.array_equal(got, _JAX_PASSES[key]), down


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_replay_star2_cluster_equals_twin(dtype):
    """Star 2 on clusters of two blocks: axis-0 planes of 8 rows in bands
    of 4 with four halo rows each side (twice the in-plane taps' reach of
    2), S = 2 sources, both directions, equal to the plain twin."""
    _, pk, _, _, Wt, sct = _both(2, dtype, dims=(9, 8, 5))
    lt = ps._sweep_layout3d(Wt, sct, 0)
    trees = [t.numpy() for t in pp3.scan_sum_trees(*lt[1:5])]
    d = _field(np.random.default_rng(5), (2,) + pk.shape, dtype)
    assert pp3.plane3d_reach(pk.shifts, 0) == 2 and pk.shape[1] == 8
    for down in (True, False):
        want = pp3.plane_sweep3d_reference(torch.from_numpy(d), lt, 0, down,
                                           None, pk.shifts).numpy()
        taps = pp3._tap_table(pk.shifts, 0, down, "cpu").numpy().tolist()
        got = _replay(np.moveaxis(d, 1, 1), lt.W.numpy(), trees, taps, down,
                      None, 2, 2)
        assert np.array_equal(got, want), down


def _global_replay(d, W, trees, taps, down, carry):
    """csrc/plane3d.cu's global route in NumPy: a plane at a time, the
    input plane with its cross taps into buffer A (the earlier planes read
    back from the output, NaN until written), each in-plane tap a Jacobi
    update from one buffer into the other, the axis-0 line scans (the
    forward copy in place, the backward copy in the other buffer, then
    min(forward, backward) in place) and the axis-1 line scans into the
    output plane."""
    S, nA, p0, p1 = d.shape
    t0f, t0b, t1f, t1b = trees
    out = np.full_like(d, np.nan)
    sgn = 1 if down else -1
    nc = 0 if carry is None else carry.shape[1]
    cross = [t for t in taps if t[1] >= 1]
    inpl = [t for t in taps if t[1] == 0]
    aa, bb = np.meshgrid(np.arange(p0), np.arange(p1), indexing="ij")

    def tap(src_plane, base, sft, da, db, p):
        na, nb = aa + da, bb + db
        ok = (na >= 0) & (na < p0) & (nb >= 0) & (nb < p1)
        src = src_plane[np.where(ok, na, 0), np.where(ok, nb, 0)]
        assert not np.isnan(src[ok]).any()
        return np.where(ok, np.minimum(base, src + W[p, sft]), base)

    for s in range(S):
        for j in range(nA):
            p = nA - 1 - j if down else j
            x = d[s, p].copy()
            for sft, m, da, db in cross:
                if j >= m:
                    prev = out[s, p + m * sgn]
                elif m - 1 - j < nc:
                    prev = carry[s, m - 1 - j]
                else:
                    continue
                x = tap(prev, x, sft, da, db, p)
            for sft, _, da, db in inpl:
                x = tap(x, x, sft, da, db, p)
            for b in range(p1):
                F, G = x[:, b].copy(), x[:, b].copy()
                _scan_line(F, G, t0f[p][:, b], t0b[p][:, b])
                x[:, b] = np.minimum(F, G)
            for a in range(p0):
                F, G = x[a].copy(), x[a].copy()
                _scan_line(F, G, t1f[p][a], t1b[p][a])
                out[s, p, a] = np.minimum(F, G)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("star,carry", [(1, "none"), (1, "plane"),
                                        (2, "tuple")])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_global_route_replay_equals_twin(axis, star, carry, dtype):
    """The global route's order (cross taps, Jacobi in-plane taps, the
    two scans, a plane at a time through global buffers), replayed on
    the kernel's tables for S = 2 sources, both directions, equals the
    plain twin."""
    jp, pk, Wj, scj, Wt, sct = _both(star, dtype)
    if carry != "none":
        Wt = torch.from_numpy(_opened(pk, axis))
        sct = ps._scan_costs_of(Wt, pk.shifts)
    lt = ps._sweep_layout3d(Wt, sct, axis)
    trees = [t.numpy() for t in pp3.scan_sum_trees(*lt[1:5])]
    rng = np.random.default_rng(17 * axis + star)
    d = _field(rng, (2,) + pk.shape, dtype)
    _, ct = _carry(rng, carry, 2, _plane_shape(pk.shape, axis), dtype)
    carry_np = None
    if ct is not None:
        planes = ct if isinstance(ct, tuple) else (ct,)
        carry_np = np.stack([p.numpy() for p in planes], axis=1)
    for down in (True, False):
        want = pp3.plane_sweep3d_reference(torch.from_numpy(d), lt, axis,
                                           down, ct, pk.shifts).numpy()
        taps = pp3._tap_table(pk.shifts, axis, down, "cpu").numpy().tolist()
        got = _global_replay(np.moveaxis(d, 1 + axis, 1), lt.W.numpy(),
                             trees, taps, down, carry_np)
        assert np.array_equal(np.moveaxis(got, 1, 1 + axis), want), down


def test_tap_table_lists_cross_then_in_plane_taps():
    """The kernel's tap rows: the cross taps of the pass's direction
    (m = the plane distance), then the in-plane taps in the stencil's
    order; the opposite direction's cross taps are the other pass's."""
    shifts = ps.shifts_star(2)
    for axis in (0, 1, 2):
        oaxes = [a for a in (0, 1, 2) if a != axis]
        for down, sgn in ((True, 1), (False, -1)):
            rows = pp3._tap_table(shifts, axis, down, "cpu").tolist()
            cross = [r for r in rows if r[1] > 0]
            inpl = [r for r in rows if r[1] == 0]
            assert rows == cross + inpl
            assert [r[0] for r in inpl] == [s for s, sh in enumerate(shifts)
                                            if sh[axis] == 0]
            assert sorted(r[0] for r in cross) == [
                s for s, sh in enumerate(shifts) if sh[axis] * sgn > 0]
            for s, m, da, db in rows:
                sh = shifts[s]
                assert sh[axis] == m * sgn
                assert (da, db) == (sh[oaxes[0]], sh[oaxes[1]])
    assert len(pp3._tap_table(ps.SHIFTS, 0, True, "cpu")) == 17


def test_plane_fits_shared_memory_or_is_refused():
    """A plane of 4,096 nodes or more runs on a cluster of 16 blocks a
    source (the non-portable size: faster than 8 on the card), a smaller
    one on one block; the cluster doubles (up to 16, and bands of at
    least twice the in-plane taps' reach) until a block's share fits:
    three band buffers of max((R + 2 halo) p1, Cw (p0 + 1)) values (R =
    ceil(p0 / cluster) rows with halo = 2 reach rows each side, Cw =
    ceil(p1 / cluster) columns), its columns' and rows' forward and
    backward sum trees (T = n + n/2 + ... over the levels of a line of
    n); a thread for 4 nodes of its rows and a warp for each of its
    lines.  Planes over 227 KB that one block refused now fit a cluster
    (171x171 float64, 256x256 float32); one that no cluster fits (256x256
    float64, 1024x1024), which used to be refused, takes the global route
    (ROADMAP C.15), a plan of zeros: no plane is refused for its size."""
    def plan(*a):
        return tuple(pp3.plane3d_plan(*a))

    T128, T64, T100, T170, T6, T5 = 254, 126, 196, 335, 9, 7
    assert [pp3._tree_len(n) for n in (128, 64, 100, 170, 6, 5)] == [
        T128, T64, T100, T170, T6, T5]
    # the 3-D path's 128x128 planes (axis 0): 8 rows and two halo rows
    # each side, 8 columns a block
    assert plan(128, 128, 4) == (16, 256, 4 * (3 * 12 * 128 + 4 * 8 * T128),
                                 8, 8, 2)
    assert plan(128, 128, 8) == (16, 256, 8 * (3 * 12 * 128 + 4 * 8 * T128),
                                 8, 8, 2)
    # its 64x128 planes (axes 1 and 2), at star 1 and star 2
    assert plan(64, 128, 8) == (16, 256, 8 * (3 * 8 * 128 + 2 * 8 * T64
                                              + 2 * 4 * T128), 4, 8, 2)
    assert plan(64, 128, 8, 2) == (16, 256, 8 * (3 * 12 * 128 + 2 * 8 * T64
                                                 + 2 * 4 * T128), 4, 8, 4)
    assert plan(100, 128, 8) == (16, 256, 8 * (3 * 11 * 128 + 2 * 8 * T100
                                              + 2 * 7 * T128), 7, 8, 2)
    assert plan(170, 170, 8) == (16, 480, 8 * (3 * 15 * 170
                                               + 4 * 11 * T170), 11, 11, 2)
    assert plan(6, 5, 4) == (1, 192, 4 * (3 * 5 * 7 + 2 * 5 * T6
                                          + 2 * 6 * T5), 6, 5, 0)
    assert plan(171, 171, 8)[:2] == (16, 480)
    assert plan(256, 256, 4)[:3] == (16, 1024, 192000)
    assert plan(256, 256, 8) == (0, 0, 0, 0, 0, 0)
    assert plan(1024, 1024, 4) == (0, 0, 0, 0, 0, 0)
    assert plan(1024, 1024, 8, 2) == (0, 0, 0, 0, 0, 0)
    assert plan(2, 100000, 4)[0] == 0 and plan(2, 1000, 4)[0] == 1
    # the route by size, and bands no thinner than twice the reach
    assert plan(63, 64, 4)[0] == 1 and plan(64, 64, 4)[0] == 16
    assert plan(24, 256, 4, 2)[0] == 4


def test_cpu_tensor_takes_the_twin_without_a_launch():
    _, pk, _, _, Wt, sct = _both(1, "float32")
    lt = ps._sweep_layout3d(Wt, sct, 1)
    d = torch.from_numpy(_field(np.random.default_rng(0), pk.shape,
                                np.float32))
    before = pp3.plane_sweep3d.launches
    got = pp3.plane_sweep3d(d, lt, 1, True, shifts=pk.shifts)
    want = pp3.plane_sweep3d_reference(d, lt, 1, True, shifts=pk.shifts)
    assert torch.equal(got, want) and pp3.plane_sweep3d.launches == before
    with pytest.raises(ValueError, match="differ"):
        pp3.plane_sweep3d(d.double(), lt, 1, True, shifts=pk.shifts)
