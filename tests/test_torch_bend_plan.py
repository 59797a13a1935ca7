"""PyTorch port: the `bend` kernel's planner, bias corrections and order.

The kernel (`csrc/bend.cu`) cannot run here, so what surrounds it is
held on the CPU:
  * `bias_table` gives the twin's own Adam bias corrections (1 - B1 **
    count, 1 - B2 ** count, Python's float power in double) for any
    count0, in float64 and cast to float32, and a launch's slice of a
    longer table (a chunked bend) is the same values;
  * `bend_plan` picks a block of 128-1,024 threads, a power-of-2 number
    of lanes a segment up to the quadrature's, the shared-memory bytes of
    the kernel's layout, and no more blocks an SM than its threads and
    shared memory hold; the --refine fan and the table's sub-batch get
    the shapes PERF.md reports, and a path no block holds is refused by
    name;
  * a replay of the kernel's arithmetic in its own order (a lane's
    quadrature points, xor-shuffle sums over a segment's lanes, over a
    warp's groups and over the warps' partial times, the Adam update
    with the host's bias corrections; its divisions and square roots are
    IEEE, the kernel's within one ulp of them) follows `bend_reference`
    within the float64 lockstep gate of chip_smoke.py (1e-6 s and 1e-3 km
    after 10 and 50 steps) in 2-D and 3-D at three plans, and the JAX
    package's bend within tests/test_torch_refine.py's 10-step gate.
"""
import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.config import R, SolverConfig
from raytracer_tpu.solvers import refine as jr
from raytracer_tpu_torch.ops import bend as ob
from raytracer_tpu_torch.solvers import refine as pr
from jax_mappings import below_the_map_limit  # noqa: F401,E402

LOCKSTEP = {10: (1e-6, 1e-3), 50: (1e-6, 1e-3)}      # chip_smoke.py 3i
PLANS = [(512, 4), (128, 8), (96, 1)]                 # (threads, lanes)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fan(tiny_annulus, tiny_velocity):
    """Five SPM paths of the tiny annulus at m 64 (tests/test_torch_refine.py's)
    and the AK135 slowness table, float64."""
    gr, A, halo = tiny_annulus
    src = rt.closest_point(gr, 0.0, R, system="polar")
    D = rt.dijkstra(A, halo, src, gr, tiny_velocity,
                    SolverConfig(dtype="float64"))
    prof = rt.velocity_profile("ak135")
    pts = []
    for deg in (10.0, 40.0, 80.0, 110.0, 140.0):
        rec = rt.closest_point(gr, np.deg2rad(deg), R, system="polar")
        path = rt.recontruct_path(D.prev, src, rec)
        pts.append(np.stack([gr.x[path], gr.z[path]], axis=1))
    tab = ob.uniform_table(*pr._uniform_slowness(prof.r, prof.Vp),
                           torch.float64, "cpu")
    return prof, pts, tab


@pytest.mark.parametrize("count0", [0, 1, 35, 799])
def test_bias_table_is_the_twins(count0):
    iters = 70
    t64 = ob.bias_table(count0, iters, torch.float64, "cpu")
    t32 = ob.bias_table(count0, iters, torch.float32, "cpu")
    assert t64.shape == t32.shape == (2, iters)
    for s in range(iters):
        c = count0 + s + 1
        for row, b in ((0, ob.B1), (1, ob.B2)):
            assert t64[row, s].item() == 1 - b ** c
            assert t32[row, s] == torch.tensor(1 - b ** c,
                                               dtype=torch.float32)
    # a chunk's table is the slice of the whole bend's
    whole = ob.bias_table(0, count0 + iters, torch.float64, "cpu")
    assert torch.equal(whole[:, count0:], t64)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("m", [2, 64, 128, 384])
def test_plan_fits_the_card(m, d, itemsize):
    for quad in (1, 8, 16):
        smem = itemsize * (6 * m * d - 2 * d + quad + 32 + 128)
        assert ob.smem_bytes(m, d, quad, itemsize) == smem
        for Bn in (1, 150, 1024, 5000):
            plan = ob.bend_plan(Bn, m, d, quad, itemsize)
            assert plan.threads in (128, 256, 512, 1024)
            assert plan.lanes in (1, 2, 4, 8, 16, 32)
            assert plan.lanes <= max(1, 1 << (quad - 1).bit_length())
            assert plan.smem == smem <= ob.BLOCK_SMEM
            assert plan.per_sm >= 1
            assert plan.per_sm * plan.threads <= ob.SM_THREADS
            assert plan.per_sm * (smem + 1024) <= ob.SM_SMEM


def test_plans_of_the_named_paths():
    # the --refine fan: 150 paths on 132 SMs in one wave; in float32 a
    # thread a segment, in float64 (whose points cost twice as much) a
    # segment's 8 points over 2 lanes
    fan = ob.bend_plan(150, 128, 2, 8, 4)
    assert (fan.threads, fan.lanes, fan.per_sm) == (128, 1, 8)
    assert ob.bend_plan(150, 128, 2, 8, 8)[:2] == (256, 2)
    # refined_travel_time_table's sub-batches in float64: 1,024 paths
    # take two waves of four 256-thread blocks an SM; 633 one wave of
    # five 128-thread blocks, a thread a segment
    assert ob.bend_plan(1024, 384, 2, 16, 8)[:3] == (256, 2, 38240)
    assert ob.bend_plan(633, 384, 2, 16, 8)[:2] == (128, 1)
    # a lone two-point path: the smallest block
    assert ob.bend_plan(1, 2, 3, 8, 8)[:2] == (128, 4)
    # a few long paths: one wide block each
    assert ob.bend_plan(8, 384, 2, 16, 8)[:2] == (1024, 2)
    # fewer SMs, more waves: the plan follows the card
    assert ob.bend_plan(150, 128, 2, 8, 8, sms=66)[:2] == (256, 2)
    assert ob.bend_plan(150, 128, 2, 8, 8, sms=16)[:2] == (128, 1)


def test_plan_refuses_by_name():
    with pytest.raises(ValueError, match="bend: a path of 5000 vertices"):
        ob.bend_plan(1, 5000, 3, 16, 8)
    with pytest.raises(ValueError, match="bend: a path of 2500 vertices"):
        ob.bend_plan(1, 2500, 3, 8, 8)
    assert ob.bend_plan(1, 1600, 3, 8, 8).smem <= ob.BLOCK_SMEM


def _xor_sum(v, width, axis):
    """The kernel's xor-shuffle sum over `width` (a power of 2) entries of
    `axis`: distances 1, 2, 4, ..., every entry ends with the same bits."""
    o = 1
    while o < width:
        v = v + v.index_select(axis, torch.arange(width) ^ o)
        o *= 2
    return v


def _replay_time(P, tab, quad, threads, lanes, grad):
    """t (B,) of csrc/bend.cu's path_time in its order, and with `grad`
    the segments' (B, m-1, d) gradient terms gA, gB."""
    Bn, m, d = P.shape
    dt = P.dtype
    n = tab.tab.shape[0]
    one, zero = torch.ones((), dtype=dt), torch.zeros((), dtype=dt)
    r0 = torch.tensor(tab.r0, dtype=dt)
    inv_dr = torch.tensor(tab.inv_dr, dtype=dt)
    top = torch.tensor(n - 1.0, dtype=dt)
    ts = ob.quad_points(quad, dt, "cpu")
    qd = torch.tensor(float(quad), dtype=dt)
    A = P[:, :-1]
    E = P[:, 1:] - A
    L2 = E[..., 0] * E[..., 0]
    for c in range(1, d):
        L2 = L2 + E[..., c] * E[..., c]
    ssum = torch.zeros(Bn, m - 1, lanes, dtype=dt)
    qa = torch.zeros(Bn, m - 1, lanes, d, dtype=dt)
    qb = torch.zeros_like(qa)
    for lane in range(lanes):
        for k in range(lane, quad, lanes):
            tk = ts[k]
            p = A + E * tk
            rr = p[..., 0] * p[..., 0]
            for c in range(1, d):
                rr = rr + p[..., c] * p[..., c]
            r = torch.sqrt(rr + ob.EPS)
            y = (r - r0) * inv_dr
            x = torch.clamp(y, zero, top)
            i = torch.clamp(x.to(torch.int64), 0, n - 2)
            f = x - i.to(dt)
            t0, t1 = tab.tab[i], tab.tab[i + 1]
            ssum[..., lane] = ssum[..., lane] + (t0 * (one - f) + t1 * f)
            if grad:
                inside = (y >= 0) & (y <= top)
                ck = torch.where(inside, ((t1 - t0) * inv_dr) / r, zero)
                wa, wb = ck * (one - tk), ck * tk
                qa[..., lane, :] = qa[..., lane, :] + wa[..., None] * p
                qb[..., lane, :] = qb[..., lane, :] + wb[..., None] * p
    ssum = _xor_sum(ssum, lanes, 2)[..., 0]
    L = torch.sqrt(L2 + ob.EPS)
    mean = ssum / qd
    seg = L * mean
    # each group's segments j = pass * groups + group, in pass order
    groups = threads // lanes
    passes = -(-(m - 1) // groups)
    segs = torch.zeros(Bn, passes * groups, dtype=dt)
    segs[:, :m - 1] = seg
    segs = segs.view(Bn, passes, groups)
    tpart = torch.zeros(Bn, groups, dtype=dt)
    for p in range(passes):
        tpart = tpart + segs[:, p]
    # the warp's groups by xor shuffles, then the warps' partials, padded
    # with zeros to a power of 2, the same way
    per_warp, warps = 32 // lanes, threads // 32
    red = _xor_sum(tpart.view(Bn, warps, per_warp), per_warp, 2)[..., 0]
    p2 = 1 << (warps - 1).bit_length()
    red = torch.cat([red, torch.zeros(Bn, p2 - warps, dtype=dt)], dim=1)
    t = _xor_sum(red, p2, 1)[:, 0]
    if not grad:
        return t, None, None
    qa = _xor_sum(qa, lanes, 2)[..., 0, :]
    qb = _xor_sum(qb, lanes, 2)[..., 0, :]
    coef = (mean / L)[..., None]
    h = (L / qd)[..., None]
    le = E * coef
    return t, -le + h * qa, le + h * qb


def _replay_bend(P, tab, lr, r_max, iters, quad, threads, lanes):
    """csrc/bend.cu's bend in its order: (best points, best times)."""
    Bn, m, d = P.shape
    dt = P.dtype
    bias = ob.bias_table(0, iters, dt, "cpu")
    fr = torch.ones(m, 1, dtype=dt)
    fr[0] = fr[-1] = 0.0
    c1, c2 = torch.tensor(1 - ob.B1, dtype=dt), torch.tensor(1 - ob.B2,
                                                              dtype=dt)
    b1, b2 = torch.tensor(ob.B1, dtype=dt), torch.tensor(ob.B2, dtype=dt)
    aeps = torch.tensor(ob.ADAM_EPS, dtype=dt)
    neg_lr = torch.tensor(-lr, dtype=dt)
    rmax = torch.tensor(r_max, dtype=dt)
    P = P.clone()
    mu, nu = torch.zeros_like(P), torch.zeros_like(P)
    best = _replay_time(P, tab, quad, threads, lanes, False)[0]
    bestP = P.clone()
    for s in range(iters):
        t, gA, gB = _replay_time(P, tab, quad, threads, lanes, True)
        better = t < best
        best = torch.where(better, t, best)
        bestP = torch.where(better[:, None, None], P, bestP)
        g = torch.zeros_like(P)
        g[:, :-1] = gA
        g[:, 1:] = g[:, 1:] + gB
        g = g * fr
        mu = c1 * g + b1 * mu
        nu = c2 * (g * g) + b2 * nu
        mh, nh = mu / bias[0, s], nu / bias[1, s]
        u = neg_lr * (mh / (torch.sqrt(nh) + aeps))
        q = P + u * fr
        rr = q[..., 0] * q[..., 0]
        for c in range(1, d):
            rr = rr + q[..., c] * q[..., c]
        r = torch.sqrt(rr)[..., None]
        P = torch.where(r > rmax, q * (rmax / r), q)
    tF = _replay_time(P, tab, quad, threads, lanes, False)[0]
    better = tF < best
    return (torch.where(better[:, None, None], P, bestP),
            torch.where(better, tF, best))


def _lift(p, ang=0.3):
    return np.stack([p[:, 0] * np.cos(ang), p[:, 0] * np.sin(ang), p[:, 1]],
                    axis=1)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("iters", sorted(LOCKSTEP))
def test_kernel_order_follows_the_twin(fan, d, iters):
    _, pts, tab = fan
    paths = pts if d == 2 else [_lift(p) for p in pts]
    P = torch.as_tensor(np.stack([pr.resample_path(p, 64) for p in paths]))
    Pt, tt = ob.bend_reference(P, tab, 3.0, R, iters, 8)
    t_tol, p_tol = LOCKSTEP[iters]
    for threads, lanes in PLANS:
        Pk, tk = _replay_bend(P, tab, 3.0, R, iters, 8, threads, lanes)
        assert float((tk - tt).abs().max()) <= t_tol, (threads, lanes)
        assert float((Pk - Pt).abs().max()) <= p_tol, (threads, lanes)
        assert bool((tk <= ob.ttime(P, tab, 8)).all())


def test_kernel_order_follows_jax(fan):
    prof, pts, tab = fan
    Pj, tj = jr.refine_paths_batch(pts, prof.r, prof.Vp, iters=10, m=64,
                                   quad=8)
    P = torch.as_tensor(np.stack([pr.resample_path(p, 64) for p in pts]))
    Pk, tk = _replay_bend(P, tab, 3.0, R, 10, 8, *PLANS[0])
    assert float(np.abs(tk.numpy() - np.asarray(tj)).max()) <= 1e-8
    assert float(np.abs(Pk.numpy() - np.asarray(Pj)).max()) <= 1e-6
