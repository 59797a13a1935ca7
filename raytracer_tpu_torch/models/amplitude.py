r"""Amplitude observables: t* attenuation and geometrical spreading.

Host-side NumPy, a copy of `raytracer_tpu/models/amplitude.py` (the port
imports nothing of the JAX package); `tests/test_torch_amplitude.py`
holds it equal to the original.

Beyond-reference layer: RayTracer.jl stops at travel times and ray paths
(src/SSSP/ssspm.jl); amplitude modelling — what those rays are usually
*for* downstream (magnitude calibration, attenuation tomography, synthetic
waveform scaling) — is delivered here on top of the path machinery
(solvers/path.py, solvers/refine.py) and the tau-p branch integrals
(models/raytheory.py).

Two independent pieces, combined by `amplitude_factor`:

* **t\*** (`tstar`) — the attenuation operator t* = integral dt / Q along a
  ray path, evaluated with the same segment-midpoint rule as
  `ray_parameters`: t* = sum_i L_i / (v(r_i) Q(r_i)) at segment midpoints.
  Works on any polyline (SPM backtrace, bent path, 2-D or 3-D).  The
  spectral amplitude decay is A(f) = exp(-pi f t*).

* **Geometrical spreading** (`geometrical_spreading`) — R(Delta) in km for
  surface-to-surface first arrivals in a radial model; point-source
  amplitude scales as 1/R.  Derived from ray-tube flux conservation: a
  takeoff-angle bundle di at azimuth width dphi carries solid angle
  sin(i_s) di dphi and lands on surface area r0^2 sin(Delta) dDelta dphi
  seen at incidence cos(i_r), so

      1/R^2 = p v0^2 |dp/dDelta| / (r0^4 sin(Delta) cos(i_s) cos(i_r))

  with p = r0 sin(i_s)/v0 the ray parameter and v0 the surface velocity
  (Aki & Richards eq. 4.91 form).  |dDelta/dp| comes from the same dense
  tau-p branch sweep `first_arrival` uses.  Analytic anchor (tested): in a
  constant-velocity sphere rays are straight chords and R(Delta) reduces
  exactly to the chord length 2 r0 sin(Delta/2).
"""
from __future__ import annotations

import numpy as np

from .raytheory import _branch


def tstar(points, profile_r, profile_v, profile_q,
          profile_q_r=None) -> float:
    """Attenuation operator t* (seconds) along a path polyline.

    points: (k, 2) or (k, 3) cartesian path vertices (km).
    profile_r / profile_v: radial velocity model (ascending radii, km/s),
    as everywhere else in the package.  profile_q: quality factor — either
    a scalar (constant Q), or a table sampled at `profile_q_r` (defaults
    to `profile_r`).  Segment-midpoint rule, matching `ray_parameters`:
    t* = sum_i L_i / (v(r_mid_i) * Q(r_mid_i)).
    """
    pts = np.asarray(points, np.float64)
    if pts.shape[0] < 2:
        return 0.0
    seg = pts[1:] - pts[:-1]
    mid = 0.5 * (pts[1:] + pts[:-1])
    L = np.linalg.norm(seg, axis=1)
    r_mid = np.linalg.norm(mid, axis=1)
    v = np.interp(r_mid, np.asarray(profile_r, np.float64),
                  np.asarray(profile_v, np.float64))
    q = np.asarray(profile_q, np.float64)
    if q.ndim == 0:
        qmid = np.full_like(r_mid, float(q))
    else:
        qr = np.asarray(profile_q_r if profile_q_r is not None else profile_r,
                        np.float64)
        qmid = np.interp(r_mid, qr, q)
    return float(np.sum(L / np.maximum(v * qmid, 1e-12)))


def attenuation_factor(tstar_s, freq_hz):
    """Spectral amplitude decay exp(-pi f t*) for t* in seconds."""
    return np.exp(-np.pi * np.asarray(freq_hz, np.float64)
                  * np.asarray(tstar_s, np.float64))


def geometrical_spreading(delta_deg, profile_r, profile_v,
                          n_p: int = 20000) -> np.ndarray:
    """Geometrical-spreading distance R(Delta) in km for the first arrival.

    Surface source and receiver (the `first_arrival` geometry); point-source
    amplitude is proportional to 1/R.  At a caustic (dDelta/dp -> 0) R -> 0:
    ray-theory amplitude diverges there, which is the correct geometrical
    answer.  Validated analytically: constant velocity => R equals the
    chord 2 r0 sin(Delta/2) (tests/test_amplitude.py).

    dp/dDelta is a central difference of the envelope minimiser p(Delta)
    (half-step 0.5 deg): p(Delta) from the tau envelope is smooth, whereas
    delta(p) of a constant-velocity-shell model is staircase-jagged near
    the turning point (vertical tangents at every shell boundary), so
    differentiating delta(p) directly is meaningless.
    """
    r = np.asarray(profile_r, np.float64)
    vr = np.asarray(profile_v, np.float64)
    v = np.maximum(0.5 * (vr[:-1] + vr[1:]), 1e-9)
    r0, v0 = r[-1], vr[-1]

    p = np.linspace(1e-6, (r0 / v0) * 0.9999, n_p)
    delta, T = _branch(p, r, v)
    tau = T - p * delta

    def p_of(d_rad: float) -> float:
        return float(p[int(np.argmin(tau + p * d_rad))])

    h = np.deg2rad(0.5)
    out = []
    for dd in np.atleast_1d(np.asarray(delta_deg, dtype=np.float64)):
        d = np.deg2rad(dd)
        pk = p_of(d)
        dpdD = (p_of(d + h) - p_of(d - h)) / (2.0 * h)
        if abs(dpdD) < 1e-12:
            out.append(np.inf)        # perfectly flat branch: no focusing
            continue
        sin_i = min(pk * v0 / r0, 1.0)
        cos_i2 = max(1.0 - sin_i * sin_i, 0.0)      # cos(i_s) * cos(i_r)
        R2 = (r0 ** 4 * np.sin(d) * cos_i2
              / (max(pk, 1e-12) * v0 * v0 * abs(dpdD)))
        out.append(np.sqrt(max(R2, 0.0)))
    return np.asarray(out)


def ak135_spreading(delta_deg, model: str = "ak135", wave: str = "Vp",
                    shell_km: int = None, n_p: int = 8000) -> np.ndarray:
    """Convenience: R(Delta) for the vendored AK135/IASP91 tables.

    Default engine (shell_km=None) differentiates the ANALYTIC
    piecewise-linear branch delta(p) (models/flatearth.py) -- smooth in
    p, no argmin quantisation -- and returns inf
    where the first arrival is CMB-diffracted (core shadow).  Pass an
    integer shell_km for the legacy constant-shell estimate.
    """
    if shell_km is None:
        from .flatearth import cmb_radius, table_model

        return table_model(model, wave).spreading(
            delta_deg, n_p=n_p, diff_radii=(cmb_radius(model),))
    from .velocity import velocity_profile

    prof = velocity_profile(model)
    v = getattr(prof, wave if wave in ("Vp", "Vs") else "Vp")
    step = max(int(shell_km), 1)
    return geometrical_spreading(delta_deg, prof.r[::step], v[::step],
                                 n_p=n_p)


def amplitude_factor(delta_deg, points, profile_r, profile_v, profile_q,
                     freq_hz=1.0, profile_q_r=None, n_p: int = 20000):
    """Combined relative amplitude: exp(-pi f t*) / R(Delta).

    `points` is the ray path used for the attenuation integral (SPM
    backtrace or bent polyline); spreading comes from ray theory at the
    same epicentral distance.  Units 1/km; meaningful as a RELATIVE factor
    across receivers of one event (source strength / radiation pattern /
    site terms are out of scope).
    """
    ts = tstar(points, profile_r, profile_v, profile_q,
               profile_q_r=profile_q_r)
    Rg = geometrical_spreading(delta_deg, profile_r, profile_v, n_p=n_p)
    return attenuation_factor(ts, freq_hz) / np.maximum(Rg, 1e-12)
