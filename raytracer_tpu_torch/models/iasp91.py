r"""Genuine IASP91 radial Earth model from the published parametrisation.

Host-side NumPy, a copy of `raytracer_tpu/models/iasp91.py` (the port
imports nothing of the JAX package); `tests/test_torch_amplitude.py`
holds it equal to the original.

IASP91 (Kennett & Engdahl 1991, "Traveltimes for global earthquake
location and phase identification", Geophys. J. Int. 105, 429-465)
defines velocities as piecewise polynomials in the normalised radius
x = r / 6371.  This module implements those polynomials and regenerates
the vendored 1-km `depth Vp Vs` table from them.

**Finding (tests/test_iasp91.py::test_vendored_tables_are_iasp91):
BOTH of the reference's vendored tables are IASP91.**  The reference
ships `VelocityProfiles/R_Vp_Vs_IASP91.txt` byte-identical to its AK135
file; evaluating the polynomials below
at every one of the 6372 table radii reproduces the vendored "AK135"
table to <2e-3 km/s at ALL rows except the five integer-depth
discontinuity rows (20, 35, 410, 660, 2889 km), where the vendored file
takes the shallow side.  The vendored centre Vp is 11.2409 = IASP91's
11.24094 (true AK135: 11.2622).  So the "AK135" label in the reference
(and the repo's `velocity_profile("ak135")`) is a misnomer inherited for
parity: every travel time either code computes is an IASP91 travel time.
A genuine AK135 table (a 136-row published TABLE, not polynomials)
cannot be sourced in this offline environment and is NOT fabricated.

Provenance and verification of the coefficients (tests/test_iasp91.py):

* Every published polynomial below reproduces the standard tabulated
  IASP91 boundary velocities to 1e-3 km/s or better: Pn 8.04 / Sn 4.47
  below the Moho, 8.30/4.52 at 210 km, 9.03/4.87 -> 9.36/5.07 across the
  410, 10.20/5.60 -> 10.79/5.95 across the 660, 13.6908/7.3015 at the
  CMB (depth 2889), 8.0088 at the top of the outer core, 10.2578 at the
  ICB (depth 5153.9), 11.0914/3.4385 at the top of the inner core and
  11.24094/3.56454 at the centre.  Polynomials of adjacent segments are
  also mutually continuous at the non-discontinuity knots (120, 210, 760,
  2740 km) to ~1e-4 km/s, a strong internal consistency check.

* The lower-mantle (760-2740 km) S-velocity cubic could not be sourced
  verbatim offline; `_lower_mantle_vs_coeffs` recovers it from the
  vendored table itself (least squares on the interior rows -- exact to
  the table's own rounding since the table is polynomial-generated, see
  above) and pins the endpoints to the adjacent published segments.  The
  recovered leading coefficients (12.915, -21.194, 27.807, -14.065)
  agree with the published cubic's remembered leading digits
  (12.9303, -21.2590, 27.8988, ...) to ~0.1%.  P kinematics -- everything
  the travel-time tests exercise -- use only the published Vp polynomials.
"""
from __future__ import annotations

import functools
import os

import numpy as np

from ..config import R

# Published IASP91 discontinuity depths (km).  NOTE these differ from the
# AK135-oriented set in config.DISCONTINUITY_DEPTHS (CMB 2889 vs 2891.5,
# ICB 5153.9 vs 5153.5); grid building keeps the reference's radii for
# parity, this module describes the genuine IASP91 layering.
DISCONTINUITY_DEPTHS = (20.0, 35.0, 410.0, 660.0, 2889.0, 5153.9)

# Segments as (depth_lo, depth_hi, vp_coeffs, vs_coeffs); coefficients are
# ascending powers of x = r/6371.  From Kennett & Engdahl (1991).
# vs_coeffs None marks the reconstructed lower-mantle segment (see module
# docstring).
_SEGMENTS = (
    (0.0, 20.0, (5.80,), (3.36,)),
    (20.0, 35.0, (6.50,), (3.75,)),
    (35.0, 120.0, (8.78541, -0.74953), (6.706231, -2.248585)),
    (120.0, 210.0, (25.41389, -17.69722), (5.75020, -1.27420)),
    (210.0, 410.0, (30.78765, -23.25415), (15.24213, -11.08552)),
    (410.0, 660.0, (29.38896, -21.40656), (17.70732, -13.50652)),
    (660.0, 760.0, (25.96984, -16.93412), (20.76890, -16.53147)),
    (760.0, 2740.0,
     (25.1486, -41.1538, 51.9932, -26.6083), None),
    (2740.0, 2889.0, (14.49470, -1.47089), (8.16616, -1.58206)),
    (2889.0, 5153.9,
     (10.03904, 3.75665, -13.67046), (0.0,)),
    (5153.9, 6371.0,
     (11.24094, 0.0, -4.09689), (3.56454, 0.0, -3.45241)),
)


def _poly(coeffs, x):
    out = np.zeros_like(x)
    for c in reversed(coeffs):
        out = out * x + c
    return out


@functools.lru_cache(maxsize=1)
def _lower_mantle_vs_coeffs():
    """Reconstructed 760-2740 km Vs cubic (ascending powers of x).

    Unique up to the interior shape: endpoint values are pinned exactly to
    the adjacent published linear segments; the two remaining degrees of
    freedom are least-squares fitted to the vendored AK135 lower-mantle
    Vs plus the linear ramp that reconciles the (small) endpoint offsets
    between the models.  See module docstring.
    """
    x0 = (R - 2740.0) / R
    x1 = (R - 760.0) / R
    y0 = _poly((8.16616, -1.58206), np.array(x0))[()]
    y1 = _poly((20.76890, -16.53147), np.array(x1))[()]

    from .velocity import velocity_profile

    prof = velocity_profile("ak135")
    sel = (prof.r >= R - 2740.0) & (prof.r <= R - 760.0)
    xs = prof.r[sel] / R
    ak = prof.Vs[sel]
    # endpoint-matching ramp: target = ak135 shape shifted so the ends hit
    # the published IASP91 values exactly
    ak0 = np.interp(x0, xs, ak)
    ak1 = np.interp(x1, xs, ak)
    ramp = ak0 + (ak1 - ak0) * (xs - x0) / (x1 - x0)
    target = ak - ramp  # residual shape to reproduce
    # c(x) = line(x) + (x-x0)(x-x1) (a + b x); fit a, b to the shape
    w = (xs - x0) * (xs - x1)
    A = np.stack([w, w * xs], axis=1)
    ab, *_ = np.linalg.lstsq(A, target, rcond=None)
    a, b = float(ab[0]), float(ab[1])
    # expand line(x) + (x-x0)(x-x1)(a+bx) into ascending power coeffs
    m = (y1 - y0) / (x1 - x0)
    c_line = np.array([y0 - m * x0, m, 0.0, 0.0])
    # (x-x0)(x-x1) = x^2 - (x0+x1)x + x0 x1
    q = np.array([x0 * x1, -(x0 + x1), 1.0])
    prod = np.zeros(4)
    prod[:3] += a * q
    prod[1:4] += b * q
    return tuple(c_line + prod)


def iasp91_velocity(r, wave: str = "Vp") -> np.ndarray:
    """Evaluate the IASP91 polynomial model at radii `r` (km).

    At exact discontinuity radii the SHALLOW side is returned, matching
    `interpolate_velocity`'s just-above sampling convention.
    """
    r = np.asarray(r, np.float64)
    x = np.clip(r / R, 0.0, 1.0)
    depth = R - np.clip(r, 0.0, R)
    out = np.zeros_like(x)
    for (d_lo, d_hi, vp, vs) in _SEGMENTS:
        if wave == "Vs":
            coeffs = vs if vs is not None else _lower_mantle_vs_coeffs()
        else:
            coeffs = vp
        # shallow-side convention: depth in (d_lo, d_hi]; a row exactly on
        # a discontinuity takes the layer above it, matching the vendored
        # tables (verified row-by-row in test_vendored_tables_are_iasp91)
        m = (depth > d_lo) & (depth <= d_hi)
        if d_lo == 0.0:
            m |= depth == 0.0
        if m.any():
            out = np.where(m, _poly(coeffs, x), out)
    return out


def generate_iasp91_table(path: str | None = None) -> np.ndarray:
    """Regenerate the 1-km `depth Vp Vs` table from the polynomials.

    Same format as the vendored AK135 table (6372 rows, depth 0..6371 km,
    tab-separated); rows at integer-depth discontinuities carry the
    shallow-side value, so the jump is smeared over the 1 km to the next
    row -- the same convention the reference's 1-km tables use.
    """
    depth = np.arange(0.0, R + 1.0)
    r = R - depth
    vp = iasp91_velocity(r, "Vp")
    vs = iasp91_velocity(r, "Vs")
    table = np.stack([depth, vp, vs], axis=1)
    if path is not None:
        with open(path, "w") as f:
            for d, p_, s_ in table:
                f.write(f"{d:.0f}\t{p_:.6f}\t{s_:.6f}\n")
    return table


def regenerate_vendored_table() -> str:
    """Overwrite the port's data/R_Vp_Vs_IASP91.txt with the genuine
    IASP91 table (fixing the AK135-duplicate defect inherited from the
    reference's VelocityProfiles/)."""
    data_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data")
    path = os.path.join(data_dir, "R_Vp_Vs_IASP91.txt")
    generate_iasp91_table(path)
    return path
