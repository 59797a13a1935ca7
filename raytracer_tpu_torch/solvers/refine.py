"""Bending refinement of SPM first-arrival paths (Fermat by Adam).

Counterpart of `raytracer_tpu/solvers/refine.py`.  The shortest-path
method's first arrivals carry a positive discretisation bias: graph paths
are polylines through mesh nodes, so they overshoot the true ray time.
The cure is ray bending applied to the recovered SPM path (Moser, van Eck
& Nolet, 1992): the polyline's vertices are free variables of the
continuous travel-time functional

    t(P) = sum_segments |P_{i+1} - P_i| * mean_quad(1 / v(r)),

minimised by Adam with the two endpoints pinned and an r <= r_max
projection (rays must not leave the Earth).  The bent time is an upper
bound on the Fermat minimum that starts below SPM's own estimate.

The host parts (`resample_path`, `_uniform_slowness`, `_polyline_time`,
`refraction_inits`) are copies of the JAX package's NumPy code.  The
bend itself is `ops/bend.bend`: one launch of the CUDA kernel
`csrc/bend.cu` a (sub-)batch on the card, the plain twin
`ops/bend.bend_reference` (the functional, autograd and optax's Adam
written out) on the CPU.  The JAX package cuts the steps into dispatches
of 200 for its TPU; the port runs them in one launch, which gives the
same result (`bend(..., chunk=)` shows it).  `dtype` defaults to float64,
what the JAX package computes under its tests (x64); float32 on request.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import R
from ..ops.bend import bend, uniform_table
from ..ops.circulant import resolve_device


def resample_path(points: np.ndarray, m: int) -> np.ndarray:
    """Uniform arc-length resampling of a polyline (m output vertices,
    endpoints preserved).  SPM paths have wildly uneven hops (secondary
    nodes, twin jumps); even spacing conditions the bending problem."""
    points = np.asarray(points, np.float64)
    seg = np.linalg.norm(np.diff(points, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    if s[-1] <= 0:
        return np.repeat(points[:1], m, axis=0)
    si = np.linspace(0.0, s[-1], m)
    return np.stack([np.interp(si, s, points[:, d])
                     for d in range(points.shape[1])], axis=1)


_UNIFORM_DR = 1.0  # km: the vendored tables' native sampling (ROADMAP C.6)


def _uniform_slowness(profile_r, profile_v, dr: float = _UNIFORM_DR):
    """(r0, inv_dr, table) uniform-radius slowness table (host NumPy).

    The functional evaluates the slowness at every quadrature point of
    every segment on every step; on a uniform radius grid the lookup is
    one fractional index and two reads.  Resampling the piecewise-linear
    profile onto it first is exact up to the profile's variation within
    `dr` (< 0.01 km/s for the 1-km Earth tables, whose sampling this
    matches)."""
    r = np.asarray(profile_r, np.float64)
    v = np.maximum(np.asarray(profile_v, np.float64), 1e-12)
    r0, r1 = float(r.min()), float(r.max())
    n = max(int(np.ceil((r1 - r0) / dr)) + 1, 2)
    ru = np.linspace(r0, r1, n)
    tab = np.interp(ru, r, 1.0 / v)
    return r0, float((n - 1) / (r1 - r0)), tab


def _polyline_time(pts, profile_r, profile_v, quad: int = 8) -> float:
    """Continuous-quadrature travel time of a fixed polyline."""
    pts = np.asarray(pts, np.float64)
    if pts.shape[0] < 2:
        return 0.0
    A, B = pts[:-1], pts[1:]
    ts = np.linspace(0.5 / quad, 1.0 - 0.5 / quad, quad)
    q = A[:, None, :] + (B - A)[:, None, :] * ts[None, :, None]
    r = np.sqrt(np.sum(q * q, axis=-1))
    slo = np.interp(r, profile_r, 1.0 / np.maximum(profile_v, 1e-12))
    L = np.linalg.norm(B - A, axis=-1)
    return float(np.sum(L * slo.mean(axis=1)))


def _torch_dtype(dtype) -> torch.dtype:
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"the bend runs in float32 or float64, not {name}")
    return getattr(torch, name)


def _bend_stack(stacked: np.ndarray, profile_r, profile_v, lr: float,
                r_max: float, iters: int, quad: int, dtype, device):
    """Bend the (B, m, d) stack on `device` in `dtype`: (points, times)
    as host arrays."""
    tdt = _torch_dtype(dtype)
    prof = uniform_table(*_uniform_slowness(profile_r, profile_v), tdt,
                         device)
    P = torch.as_tensor(stacked, dtype=tdt, device=device)
    Pb, tb = bend(P, prof, float(lr), float(r_max), int(iters), int(quad))
    return Pb.cpu().numpy(), tb.cpu().numpy()


def refine_path(points, profile_r, profile_v, iters: int = 800,
                lr: float = 3.0, quad: int = 8, m: int = 0,
                r_max: float = R, dtype="float64", device="cuda"):
    """Bend one SPM path to the continuous Fermat minimum.

    points: (k, d) cartesian polyline (d = 2 annulus / 3 wedge),
    receiver..source order as `recontruct_path` gives it.
    profile_r/profile_v: the radial velocity table (ascending radii).
    m > 0 resamples to m uniform-arc-length vertices first (default
    keeps ~2x the input vertex count, capped at 256).

    Returns (refined_points, refined_time) - the time in seconds under
    the same slowness model SPM used, so refined_time <= the SPM edge sum
    up to quadrature error."""
    pts = np.asarray(points, np.float64)
    if pts.shape[0] < 3:
        t = _polyline_time(pts, profile_r, profile_v, quad)
        return pts, float(t)
    if m <= 0:
        m = int(min(256, max(32, 2 * pts.shape[0])))
    P, t = _bend_stack(resample_path(pts, m)[None], profile_r, profile_v,
                       lr, r_max, iters, quad, dtype,
                       resolve_device(device))
    return P[0], float(t[0])


def refraction_inits(p0, p1, profile_r, profile_v,
                     depths=(35.0, 410.0, 660.0), n_leg: int = 12,
                     n_flat: int = 24):
    """Candidate refraction-branch (headwave-style) initial polylines
    between two 2-D cartesian points.

    Bending is a LOCAL optimiser: from the SPM first-arrival polyline it
    converges to that branch's Fermat minimum, which near branch
    crossovers is not the global first arrival.  The cure is multi-start:
    also bend a critical-angle refraction geometry per candidate
    interface - straight legs at sin(i_c) = v_above/v_below down to just
    below the interface, a flat segment along it - and keep the minimum.

    Returns a (possibly empty) list of (k, 2) polylines, one per
    geometrically feasible interface."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    pr = np.asarray(profile_r, np.float64)
    pv = np.asarray(profile_v, np.float64)
    R_top = float(pr.max())
    r0 = float(np.hypot(*p0))
    r1 = float(np.hypot(*p1))
    th0 = float(np.arctan2(p0[0], p0[1]))
    th1 = float(np.arctan2(p1[0], p1[1]))
    delta = (th1 - th0 + np.pi) % (2 * np.pi) - np.pi
    s = 1.0 if delta >= 0 else -1.0
    adelta = abs(delta)
    out = []
    for depth in depths:
        r_if = R_top - float(depth)
        if min(r0, r1) < r_if + 5.0:      # an endpoint at/below the interface
            continue
        v_above = float(np.interp(r_if + 1.5, pr, pv))
        v_below = float(np.interp(r_if - 1.5, pr, pv))
        if v_below <= v_above:            # no fast side: no head wave
            continue
        ic = np.arcsin(v_above / v_below)
        off0 = (r0 - r_if) * np.tan(ic) / r_if
        off1 = (r1 - r_if) * np.tan(ic) / r_if
        # exact critical-angle legs when they fit; otherwise (deep
        # interfaces at triplication ranges, where tan(i_c) is large)
        # clip each leg to 35% of the separation - the bend polishes
        # the leg shape, the init only has to be on the right branch
        if off0 + off1 >= adelta:
            off0 = min(off0, 0.35 * adelta)
            off1 = min(off1, 0.35 * adelta)
        r_flat = r_if - 1.5               # inside the fast side
        a1 = th0 + s * np.linspace(0.0, off0, n_leg)
        a2 = th0 + s * np.linspace(off0, adelta - off1, n_flat)
        a3 = th0 + s * np.linspace(adelta - off1, adelta, n_leg)
        rr1 = np.linspace(r0, r_flat, n_leg)
        rr3 = np.linspace(r_flat, r1, n_leg)
        ang = np.concatenate([a1, a2[1:], a3[1:]])
        rad = np.concatenate([rr1, np.full(n_flat - 1, r_flat), rr3[1:]])
        out.append(np.stack([rad * np.sin(ang), rad * np.cos(ang)], axis=1))
    return out


def refine_fan(pts_list, profile_r, profile_v, m: int = 128,
               iters: int = 800, lr: float = 3.0, quad: int = 8,
               multistart: bool = True,
               multistart_max_deg: float = 32.0, dtype="float64",
               device="cuda") -> np.ndarray:
    """(n,) refined times for a list of SPM polylines: bend the whole fan
    batched; with `multistart` also bend critical-angle refraction-branch
    candidates (refraction_inits) at lr=1.0 for pairs separated by less
    than `multistart_max_deg` and keep the per-path minimum.  Every
    candidate is an upper bound on the true Fermat minimum, so min()
    only tightens."""
    cand, cand_ix = [], []
    if multistart:
        max_sep = np.deg2rad(multistart_max_deg)
        for i, pts in enumerate(pts_list):
            p0, p1 = np.asarray(pts[0]), np.asarray(pts[-1])
            if p0.shape[0] != 2:
                continue                   # 2-D annulus geometry only
            th0 = np.arctan2(p0[0], p0[1])
            th1 = np.arctan2(p1[0], p1[1])
            sep = abs((th1 - th0 + np.pi) % (2 * np.pi) - np.pi)
            if 1e-9 < sep <= max_sep:
                for q in refraction_inits(p0, p1, profile_r, profile_v):
                    cand.append(q)
                    cand_ix.append(i)
    _, t = refine_paths_batch(pts_list, profile_r, profile_v, m=m,
                              iters=iters, lr=lr, quad=quad, dtype=dtype,
                              device=device)
    t = np.asarray(t).copy()
    if cand:
        _, tc = refine_paths_batch(cand, profile_r, profile_v, m=m,
                                   iters=iters, lr=1.0, quad=quad,
                                   dtype=dtype, device=device)
        np.minimum.at(t, np.asarray(cand_ix), np.asarray(tc))
    return t


# Max paths per bend launch: the JAX package's sub-batch, the last block
# padded to it as there (on its TPU one compiled program then serves
# every block; here the padding keeps the launches alike)
_BEND_MAX_BATCH = 1024


def refine_paths_batch(paths: Sequence, profile_r, profile_v, m: int = 128,
                       iters: int = 800, lr: float = 3.0, quad: int = 8,
                       r_max: float = R,
                       sub_batch: int = _BEND_MAX_BATCH, dtype="float64",
                       device="cuda"):
    """Refine a batch of paths over the resampled (n_paths, m, d) stack,
    `sub_batch` paths a launch.  Returns (points, times) as host
    arrays."""
    dev = resolve_device(device)
    stacked = np.stack([resample_path(np.asarray(p, np.float64), m)
                        for p in paths])

    def run(blk):
        return _bend_stack(blk, profile_r, profile_v, lr, r_max, iters,
                           quad, dtype, dev)

    B = stacked.shape[0]
    if B <= sub_batch:
        return run(stacked)
    outP, outT = [], []
    for i in range(0, B, sub_batch):
        blk = stacked[i:i + sub_batch]
        pad = sub_batch - blk.shape[0]
        if pad:
            blk = np.concatenate([blk, np.repeat(blk[-1:], pad, axis=0)])
        P, t = run(blk)
        n = sub_batch - pad
        outP.append(P[:n])
        outT.append(t[:n])
    return np.concatenate(outP), np.concatenate(outT)

