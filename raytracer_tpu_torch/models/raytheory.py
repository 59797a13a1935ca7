"""Classical 1-D ray-theory travel times (independent accuracy anchor).

Host-side NumPy, a copy of `raytracer_tpu/models/raytheory.py` (the port
imports nothing of the JAX package); `tests/test_torch_amplitude.py`
holds it equal to the original.

The reference validated its travel times against TauP (error.png,
main_annulus.jl:74-76 exports into a TauP comparison tree), which is not
available offline.  This module computes first-arrival times for a radial
velocity model by classical seismic ray theory, giving an independent,
physics-based check of the SPM solver:

  * per 1-km constant-velocity shell the ray integrals are analytic:
      dDelta = arccos(a/r2) - arccos(a/r1),  a = p*v
      dT     = (sqrt(r2^2-a^2) - sqrt(r1^2-a^2)) / v
  * the first arrival is the lower tau-p envelope
      t(Delta) = min_p [ tau(p) + p*Delta ],  tau = T - p*Delta
    which is exact for all refracted branches (not for diffracted phases
    like Pdiff, so comparisons should stay within the direct-P range,
    roughly Delta <= 95 deg for AK135 P).

SPM travel times are upper bounds on ray-theory times (paths restricted
to graph edges), converging from above as the grid refines.
"""
from __future__ import annotations

import numpy as np

from ..config import R


def _branch(p: np.ndarray, r: np.ndarray, v: np.ndarray):
    """Delta(p), T(p) for surface-to-surface rays with parameter p.

    r: shell boundary radii ascending (n+1,), v: shell velocities (n,).
    Shells are traversed from the surface DOWN; the ray stops at its first
    turning point (a >= inner radius of a shell).  The stop matters in
    non-monotone-eta models: the CMB velocity drop makes core shells look
    passable (eta jumps up) even though a mantle-turning ray never reaches
    them - integrating those would fabricate paths.
    """
    p = np.atleast_1d(np.asarray(p, dtype=np.float64))
    # descending order: shell k spans [r1d, r2d], r2d outer
    r1d = r[:-1][::-1][None, :]
    r2d = r[1:][::-1][None, :]
    vd = v[::-1][None, :]
    a = p[:, None] * vd

    passes = a < r1d                       # fully traverses the shell
    # alive_k: all shells above were fully traversed
    alive = np.ones_like(passes)
    alive[:, 1:] = np.cumprod(passes[:, :-1], axis=1)
    alive = alive.astype(bool)

    lo = np.maximum(r1d, a)
    valid = alive & (r2d > lo)
    with np.errstate(invalid="ignore", divide="ignore"):
        s2 = np.sqrt(np.maximum(r2d * r2d - a * a, 0.0))
        s1 = np.sqrt(np.maximum(lo * lo - a * a, 0.0))
        dT = np.where(valid, (s2 - s1) / vd, 0.0)
        c2 = np.clip(a / np.maximum(r2d, 1e-12), -1.0, 1.0)
        c1 = np.clip(a / np.maximum(lo, 1e-12), -1.0, 1.0)
        dD = np.where(valid, np.arccos(c2) - np.arccos(c1), 0.0)

    delta = 2.0 * dD.sum(axis=1)
    T = 2.0 * dT.sum(axis=1)
    return delta, T


def first_arrival(delta_deg, profile_r: np.ndarray, profile_v: np.ndarray,
                  n_p: int = 20000, return_p: bool = False):
    """First-arrival time(s) at epicentral distance(s) delta_deg.

    tau-p lower envelope over a dense ray-parameter sweep; exact for
    refracted branches.  profile_r ascending radii (km), profile_v the
    velocity at those radii (km/s).  return_p=True also returns the
    minimising ray parameter p = dt/dDelta (s/rad) of the first arrival
    — the Snell invariant the path-geometry tests anchor against.
    """
    r = np.asarray(profile_r, dtype=np.float64)
    vr = np.asarray(profile_v, dtype=np.float64)
    # shell velocities at midpoints; drop zero-velocity shells (liquid
    # core for S) by treating them as impassable (a ray hitting one turns)
    v = 0.5 * (vr[:-1] + vr[1:])
    v = np.maximum(v, 1e-9)

    p_max = r[-1] / vr[-1]
    p = np.linspace(1e-6, p_max * 0.9999, n_p)
    delta, T = _branch(p, r, v)
    tau = T - p * delta

    out, pout = [], []
    for dd in np.atleast_1d(np.asarray(delta_deg, dtype=np.float64)):
        d = np.deg2rad(dd)
        k = int(np.argmin(tau + p * d))
        out.append(tau[k] + p[k] * d)
        pout.append(p[k])
    if return_p:
        return np.asarray(out), np.asarray(pout)
    return np.asarray(out)


def reflected_arrival(delta_deg, profile_r: np.ndarray,
                      profile_v: np.ndarray, r_reflect: float,
                      n_p: int = 20000) -> np.ndarray:
    """Travel time(s) of the branch reflected at radius `r_reflect`
    (e.g. PcP for the core-mantle boundary): rays traverse every shell
    from the surface down to the reflector WITHOUT turning, bounce, and
    retrace.  For ray parameter p (valid while a = p*v stays below each
    shell's inner radius),

        Delta(p) = 2 * sum arccos(a/r2) - arccos(a/r1)
        T(p)     = 2 * sum (sqrt(r2^2-a^2) - sqrt(r1^2-a^2)) / v

    over the shells above the reflector; Delta(p) is monotone in p for
    the reflected branch, so T(Delta) follows by interpolation.

    Independent anchor for the multi-leg phase solver (solvers/phases.py)
    - the role TauP's PcP curve played for the reference.
    """
    r_all = np.asarray(profile_r, dtype=np.float64)
    v_all = np.asarray(profile_v, dtype=np.float64)
    keep = r_all >= float(r_reflect) - 1e-9
    r, vr = r_all[keep], v_all[keep]
    if r[0] > r_reflect + 1e-9:   # extend the deepest kept shell down
        r = np.concatenate([[float(r_reflect)], r])
        vr = np.concatenate([[vr[0]], vr])
    v = np.maximum(0.5 * (vr[:-1] + vr[1:]), 1e-9)

    # no turning above the reflector: p*v_k < r1_k for every shell
    p_max = np.min(r[:-1] / v) * 0.999999
    p = np.linspace(0.0, p_max, n_p)

    r1 = r[:-1][None, :]
    r2 = r[1:][None, :]
    vd = v[None, :]
    a = p[:, None] * vd
    with np.errstate(invalid="ignore"):
        s2 = np.sqrt(np.maximum(r2 * r2 - a * a, 0.0))
        s1 = np.sqrt(np.maximum(r1 * r1 - a * a, 0.0))
        dT = (s2 - s1) / vd
        dD = (np.arccos(np.clip(a / r2, -1.0, 1.0))
              - np.arccos(np.clip(a / r1, -1.0, 1.0)))
    delta = 2.0 * dD.sum(axis=1)
    T = 2.0 * dT.sum(axis=1)

    out = np.interp(np.deg2rad(np.atleast_1d(
        np.asarray(delta_deg, dtype=np.float64))), delta, T,
        right=np.nan)
    return out


def ak135_reflected(delta_deg, r_reflect: float, model: str = "ak135",
                    wave: str = "Vp", shell_km: int = None,
                    n_p: int = 8000) -> np.ndarray:
    """Reflected-branch times for the vendored AK135/IASP91 tables
    (e.g. r_reflect = R - 2891.5 for PcP / ScS).

    Default engine (shell_km=None) is the piecewise-linear flattened
    model (models/flatearth.py, self-error < 0.02 s); pass an integer
    shell_km to fall back to the legacy constant-shell integrals on a
    `shell_km`-decimated table (~0.5-1 s self-error).
    """
    if shell_km is None:
        from .flatearth import table_model

        return table_model(model, wave).reflected(delta_deg, r_reflect,
                                                  n_p=n_p)
    from .velocity import velocity_profile

    prof = velocity_profile(model)
    v = getattr(prof, wave if wave in ("Vp", "Vs") else "Vp")
    step = max(int(shell_km), 1)
    return reflected_arrival(delta_deg, prof.r[::step], v[::step],
                             r_reflect, n_p=n_p)


def ak135_first_arrivals(delta_deg, model: str = "ak135", wave: str = "Vp",
                         shell_km: int = None, n_p: int = 6000,
                         return_p: bool = False):
    """Convenience: first arrivals for the vendored AK135/IASP91 tables.

    Default engine (shell_km=None) is the piecewise-linear flattened
    model (models/flatearth.py): exact analytic layer integrals on the
    full 1-km table, CMB-diffraction extension included, self-error
    < 0.02 s (tests/test_flatearth.py knot-halving).  Pass an integer
    shell_km for the legacy constant-shell engine on a decimated table.
    """
    if shell_km is None:
        from .flatearth import cmb_radius, table_model

        m = table_model(model, wave)
        return m.first_arrival(delta_deg, n_p=n_p,
                               diff_radii=(cmb_radius(model),),
                               return_p=return_p)
    from .velocity import velocity_profile

    prof = velocity_profile(model)
    v = getattr(prof, wave if wave in ("Vp", "Vs") else "Vp")
    step = max(int(shell_km), 1)
    return first_arrival(delta_deg, prof.r[::step], v[::step], n_p=n_p,
                         return_p=return_p)
