"""PyTorch port: one directional plane pass of the 3-D sweep engine.

The port's `_plane_sweep3d` (on the CPU the plain twin
`ops.plane3d.plane_sweep3d_reference`) must equal the JAX package's
`_plane_sweep3d` bit for bit: per axis and direction, at star 1 and 2,
with and without `carry_init`, in float32 and float64, one source and a
batch (the JAX package vmaps).  The CUDA kernel `csrc/plane3d.cu` cannot
run here, so what it reads and where is replayed in NumPy on the same
tables (its skipped out-of-plane taps, its carry planes, its sum trees
and in-place scan levels) and held to the twin; the premise that lets it
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


def _replay(d, W, trees, taps, down, carry):
    """csrc/plane3d.cu replayed in NumPy, one block a source: d (S, nA, p0,
    p1) with the sweep axis first, W (nA, ns, p0, p1), the four trees,
    the tap rows (shift, m, da, db), carry (S, nc, p0, p1) or None.
    Output planes not yet written are NaN, so reading one fails."""
    S, nA, p0, p1 = d.shape
    P = p0 * p1
    t0f, t0b, t1f, t1b = trees
    out = np.full_like(d, np.nan)
    a_of, b_of = np.divmod(np.arange(P), p1)
    sgn = 1 if down else -1
    nc = 0 if carry is None else carry.shape[1]
    cross = [t for t in taps if t[1] >= 1]
    inpl = [t for t in taps if t[1] == 0]

    def scan_dir(cur, tree, ax, rev):
        n, nl = (p0, p1) if ax == 0 else (p1, p0)
        levels = pp3.tree_levels(n)

        def at(t, line):
            u = n - 1 - t if rev else t
            return u * p1 + line if ax == 0 else line * p1 + u

        def tsum(k, line):
            return tree[k, line] if ax == 0 else tree[line, k]

        for lev, (off, m) in enumerate(levels):
            i, line = np.meshgrid(np.arange(m // 2), np.arange(nl),
                                  indexing="ij")
            p = ((2 * i + 2) << lev) - 1
            ip = at(p, line)
            cur[ip] = np.minimum(cur[at(p - (1 << lev), line)]
                                 + tsum(off + 2 * i + 1, line), cur[ip])
        for lev in range(len(levels) - 1, -1, -1):
            off, m = levels[lev]
            i, line = np.meshgrid(np.arange(1, (m - 1) // 2 + 1),
                                  np.arange(nl), indexing="ij")
            q = ((2 * i + 1) << lev) - 1
            iq = at(q, line)
            cur[iq] = np.minimum(cur[at(q - (1 << lev), line)]
                                 + tsum(off + 2 * i, line), cur[iq])

    def scan_axis(cur, tf, tb, ax):
        X = cur.copy()
        scan_dir(cur, tf, ax, False)
        X, cur[:] = np.minimum(X, cur), X
        scan_dir(cur, tb, ax, True)
        cur[:] = np.minimum(X, cur)

    for s in range(S):
        for j in range(nA):
            p = nA - 1 - j if down else j
            cur = d[s, p].reshape(-1).copy()
            for sft, m, da, db in cross:
                na, nb = a_of + da, b_of + db
                ok = (na >= 0) & (na < p0) & (nb >= 0) & (nb < p1)
                if j >= m:
                    prev = out[s, p + m * sgn].reshape(-1)
                elif m - 1 - j < nc:
                    prev = carry[s, m - 1 - j].reshape(-1)
                else:
                    continue
                src = prev[np.where(ok, na * p1 + nb, 0)]
                assert not np.isnan(src[ok]).any()
                cand = src + W[p, sft].reshape(-1)
                cur = np.where(ok, np.minimum(cur, cand), cur)
            for sft, _, da, db in inpl:
                na, nb = a_of + da, b_of + db
                ok = (na >= 0) & (na < p0) & (nb >= 0) & (nb < p1)
                cand = cur[np.where(ok, na * p1 + nb, 0)] + W[p, sft].reshape(-1)
                cur = np.where(ok, np.minimum(cur, cand), cur)
            scan_axis(cur, t0f[p], t0b[p], 0)
            scan_axis(cur, t1f[p], t1b[p], 1)
            out[s, p] = cur.reshape(p0, p1)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("star,carry", [(1, "none"), (1, "plane"),
                                        (2, "none"), (2, "tuple")])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernel_replay_equals_twin(axis, star, carry, dtype):
    """What csrc/plane3d.cu reads and where, replayed on the host on the
    kernel's own tables (the tap rows, the sum trees) for S = 3 sources,
    both directions, equals the plain twin."""
    _, pk, _, _, Wt, sct = _both(star, dtype)
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
        got = _replay(np.moveaxis(d, 1 + axis, 1), lt.W.numpy(), trees,
                      taps, down, carry_np)
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
    """One plane always sits in shared memory, up to three where they fit
    (a second for the in-plane ping-pong, a third for the scans of both
    directions together); a plane larger than an H100 block's 227 KB is
    refused by name before any launch."""
    assert pp3.plane3d_smem_bytes(128, 128, 4) == (196608, 3)
    assert pp3.plane3d_smem_bytes(128, 128, 8) == (131072, 1)
    assert pp3.plane3d_smem_bytes(64, 128, 8) == (196608, 3)
    assert pp3.plane3d_smem_bytes(100, 128, 8) == (204800, 2)
    assert pp3.plane3d_smem_bytes(170, 170, 8) == (231200, 1)
    assert pp3.plane3d_smem_bytes(6, 5, 4) == (360, 3)
    with pytest.raises(ValueError, match="232448 bytes"):
        pp3.plane3d_smem_bytes(171, 171, 8)
    with pytest.raises(ValueError, match="shared memory"):
        pp3.plane3d_smem_bytes(256, 256, 4)


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
