r"""Plane-wave interface coefficients (Zoeppritz) + PREM density.

Host-side NumPy, a copy of `raytracer_tpu/models/zoeppritz.py` (the port
imports nothing of the JAX package); `tests/test_torch_amplitude.py`
holds it equal to the original.

Completes the amplitude layer: t* attenuation and
geometrical spreading (models/amplitude.py) composed with the
reflection/transmission coefficients at the discontinuities a named
phase touches, plus the free-surface receiver factor.  Beyond-reference:
RayTracer.jl has no amplitude modelling at all.

**Density**: the vendored velocity tables carry no rho, so interfaces
use the PREM density polynomials (Dziewonski & Anderson 1981, Table 1;
x = r/6371).  The implementation self-checks against the textbook PREM
discontinuity densities (13.0885 centre, 12.166/12.764 at the ICB,
9.903/5.566 at the CMB, 4.380/3.992 at 660, 3.724/3.543 at 400; tested
to 1e-3 in tests/test_zoeppritz.py).

**Coefficients**: displacement-amplitude P-SV system assembled directly
from the welded-interface boundary conditions (continuity of u_x, u_z,
sigma_zz, sigma_xz; Aki & Richards ch. 5) for each wave's
displacement-stress vector, solved per horizontal slowness.  Fluid
sides (beta = 0, the outer core) reduce the system (u_z and sigma_zz
continuous, sigma_xz = 0 on the solid face, u_x free to slip); the free
surface zeroes both tractions.  Verification is physics, not literature
tables: pre-critical ENERGY-FLUX coefficients sum to 1 at every
interface and incidence (machine precision), normal-incidence values
reduce to the impedance closed forms +-(Z2-Z1)/(Z2+Z1), and the
free-surface factor is exactly 2 at vertical incidence.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import R

# PREM density polynomials (ascending powers of x = r/6371), by radius.
_PREM_RHO = (
    (0.0, 1221.5, (13.0885, 0.0, -8.8381)),
    (1221.5, 3480.0, (12.5815, -1.2638, -3.6426, -5.5281)),
    (3480.0, 5701.0, (7.9565, -6.4761, 5.5283, -3.0807)),
    (5701.0, 5771.0, (5.3197, -1.4836)),
    (5771.0, 5971.0, (11.2494, -8.0298)),
    (5971.0, 6151.0, (7.1089, -3.8045)),
    (6151.0, 6346.6, (2.6910, 0.6924)),
    (6346.6, 6356.0, (2.900,)),
    (6356.0, 6368.0, (2.600,)),
    (6368.0, 6371.0, (1.020,)),
)


def prem_density(r) -> np.ndarray:
    """PREM density (g/cm^3) at radius r (km); shallow side at knots."""
    r = np.asarray(r, np.float64)
    x = np.clip(r / R, 0.0, 1.0)
    out = np.zeros_like(x)
    for (r_lo, r_hi, coeffs) in _PREM_RHO:
        m = (r >= r_lo) & (r < r_hi) if r_hi < R else (r >= r_lo)
        if m.any():
            val = np.zeros_like(x)
            for c in reversed(coeffs):
                val = val * x + c
            out = np.where(m, val, out)
    return out


@dataclasses.dataclass(frozen=True)
class Medium:
    """Isotropic elastic half-space: Vp, Vs (km/s), rho (g/cm^3)."""

    alpha: float
    beta: float
    rho: float

    @property
    def mu(self) -> float:
        return self.rho * self.beta ** 2

    @property
    def lam(self) -> float:
        return self.rho * (self.alpha ** 2 - 2.0 * self.beta ** 2)

    @property
    def fluid(self) -> bool:
        return self.beta < 1e-9


def interface_media(r_interface: float, model: str = "ak135",
                    offset: float = 2.5):
    """(above, below) Medium at a vendored-table interface radius; the
    1-km-smeared tables are sampled `offset` km clear of the transition
    row (pass the TABLE's interface radius, e.g. `cmb_radius(model)`,
    not the reference's 3479.5 constant -- the vendored tables place the
    CMB at depth 2889), densities from PREM."""
    from .velocity import velocity_profile

    prof = velocity_profile(model)
    va = float(np.interp(r_interface + offset, prof.r, prof.Vp))
    vb = float(np.interp(r_interface - offset, prof.r, prof.Vp))
    sa = float(np.interp(r_interface + offset, prof.r, prof.Vs))
    sb = float(np.interp(r_interface - offset, prof.r, prof.Vs))
    ra = float(prem_density(r_interface + offset))
    rb = float(prem_density(r_interface - offset))
    return Medium(va, sa, ra), Medium(vb, sb, rb)


def _wavevec(med: Medium, p: float, kind: str, s: int):
    """Displacement-stress vector (ux, uz, szz, sxz) of a unit-amplitude
    plane wave at the interface plane.

    kind 'P' or 'S'; s = +1 downgoing (+z into medium 2), -1 upgoing.
    Vertical slownesses turn imaginary past critical (evanescent decay
    chosen on the physical branch).
    """
    if kind == "P":
        v = med.alpha
    else:
        v = med.beta
    q = np.sqrt(complex(1.0 / v ** 2 - p * p))
    if q.imag < 0:
        q = -q
    if kind == "P":
        d = np.array([p * v, s * q * v], dtype=complex)
    else:
        # SV polarisation: perpendicular to propagation (p, s q)
        d = np.array([s * q * v, -p * v], dtype=complex)
    ux, uz = d
    szz = med.lam * p * ux + (med.lam + 2.0 * med.mu) * s * q * uz
    sxz = med.mu * (p * uz + s * q * ux)
    return np.array([ux, uz, szz, sxz], dtype=complex), q


def scattering(med1: Medium, med2: Medium, p: float, incident: str = "P"):
    """Displacement reflection/transmission coefficients at a welded (or
    fluid-contact) interface, incident wave DOWNGOING in med1.

    Returns dict with keys among {"PP_r","PS_r","PP_t","PS_t"} (absent
    where the medium cannot carry the wave) plus "q" vertical slownesses
    per scattered wave for energy bookkeeping.
    """
    inc_vec, q_inc = _wavevec(med1, p, incident, +1)

    cols, names, qs = [], [], []
    for kind in ("P", "S"):
        if kind == "S" and med1.fluid:
            continue
        vec, q = _wavevec(med1, p, kind, -1)
        cols.append(vec)
        names.append(f"P{kind}_r" if incident == "P" else f"S{kind}_r")
        qs.append((med1, kind, q))
    for kind in ("P", "S"):
        if kind == "S" and med2.fluid:
            continue
        vec, q = _wavevec(med2, p, kind, +1)
        cols.append(-vec)
        names.append(f"P{kind}_t" if incident == "P" else f"S{kind}_t")
        qs.append((med2, kind, q))

    # Columns are stored so that continuity rows read
    #   sum_r x_r f(refl) - sum_t x_t f(trans) = -f(inc)
    # (transmitted columns negated above).  Welded contact: all four
    # components continuous.  Fluid contact: only u_z and sigma_zz are
    # continuous; sigma_xz must vanish on each SOLID face separately
    # (single-sided rows below, built from the un-negated vectors); u_x
    # is free to slip.
    if med1.fluid or med2.fluid:
        A_rows = [np.array([c[i] for c in cols]) for i in (1, 2)]
        b_rows = [-inc_vec[1], -inc_vec[2]]
        if not med1.fluid:
            A_rows.append(np.array(
                [c[3] if nm.endswith("_r") else 0.0
                 for c, nm in zip(cols, names)]))
            b_rows.append(-inc_vec[3])
        if not med2.fluid:
            # med2 columns were negated; re-negate for the one-sided row
            A_rows.append(np.array(
                [-c[3] if nm.endswith("_t") else 0.0
                 for c, nm in zip(cols, names)]))
            b_rows.append(0.0)
        A = np.stack(A_rows)
        b = np.array(b_rows, dtype=complex)
    else:
        A = np.stack([np.array([c[i] for c in cols]) for i in range(4)])
        b = -inc_vec

    sol = np.linalg.solve(A, b)
    out = {nm: sol[i] for i, nm in enumerate(names)}
    out["_q"] = {nm: qs[i] for i, nm in enumerate(names)}
    out["_q_inc"] = (med1, incident, q_inc)
    return out


def energy_coefficients(med1: Medium, med2: Medium, p: float,
                        incident: str = "P"):
    """Energy-flux coefficients of each scattered wave (pre-critical
    waves only); they sum to 1 -- the physics check the tests pin."""
    sc = scattering(med1, med2, p, incident)
    m_i, k_i, q_i = sc["_q_inc"]
    v_i = m_i.alpha if k_i == "P" else m_i.beta
    F_inc = m_i.rho * v_i ** 2 * q_i.real
    out = {}
    for nm, amp in sc.items():
        if nm.startswith("_"):
            continue
        med, kind, q = sc["_q"][nm]
        v = med.alpha if kind == "P" else med.beta
        if q.real <= 1e-12:
            out[nm] = 0.0          # evanescent: no mean vertical flux
            continue
        out[nm] = float(med.rho * v ** 2 * q.real * abs(amp) ** 2 / F_inc)
    return out


def free_surface_receiver(p: float, med: Medium) -> float:
    """|total surface displacement| per unit incident-P displacement for
    an UPGOING P wave under a free surface (incident + PP + PS evaluated
    at z = 0).  Exactly 2 at vertical incidence."""
    inc_vec, _ = _wavevec(med, p, "P", -1)
    cols, names = [], []
    for kind in ("P", "S"):
        if kind == "S" and med.fluid:
            continue
        vec, _ = _wavevec(med, p, kind, +1)
        cols.append(vec)
        names.append(kind)
    rows = [2, 3] if not med.fluid else [2]
    A = np.stack([np.array([c[i] for c in cols]) for i in rows])
    b = -inc_vec[rows]
    sol = np.linalg.solve(A, b)
    u = inc_vec[:2] + sum(s * c[:2] for s, c in zip(sol, cols))
    return float(np.linalg.norm(u))


def pcp_p_amplitude_ratio(delta_deg, model: str = "ak135",
                          q_factor: float = None, freq_hz: float = 1.0,
                          n_p: int = 6000) -> np.ndarray:
    """|A_PcP / A_P| vs epicentral distance: geometrical spreading ratio
    x CMB reflection coefficient (x optional t* attenuation ratio with a
    constant Q).  Free-surface and near-source factors cancel in the
    ratio (same surface slownesses to first order).  NaN outside the
    direct-P range."""
    from .flatearth import cmb_radius, table_model

    m = table_model(model)
    cmb = cmb_radius(model)
    dd = np.atleast_1d(np.asarray(delta_deg, np.float64))

    t_p, p_p = m.first_arrival(dd, n_p=n_p, return_p=True)
    R_p = m.spreading(dd, n_p=n_p, diff_radii=(cmb,))

    # PcP branch: reflected spreading from the analytic branch derivative
    p_g = m.slowness_above(cmb)
    pgrid = np.linspace(0.0, p_g * (1.0 - 1e-9), n_p)
    X, T, reached = m.down_leg(pgrid, r_stop=cmb)
    ok = reached
    d_br, t_br, p_br = 2.0 * X[ok], 2.0 * T[ok], pgrid[ok]
    t_pcp = np.interp(np.deg2rad(dd), d_br, t_br, right=np.nan)
    p_pcp = np.interp(np.deg2rad(dd), d_br, p_br, right=np.nan)
    h = (p_br[-1] - p_br[0]) / 500.0
    med1, med2 = interface_media(cmb, model)

    out = np.empty(dd.shape)
    r0, v0 = m.R0, m.v_surf
    for i, d in enumerate(np.deg2rad(dd)):
        if not np.isfinite(p_pcp[i]) or not np.isfinite(R_p[i]):
            out[i] = np.nan
            continue
        lo = float(np.interp(p_pcp[i] - h, p_br, d_br))
        hi = float(np.interp(p_pcp[i] + h, p_br, d_br))
        slope = (hi - lo) / (2.0 * h)
        pk = p_pcp[i]
        sin_i = min(pk * v0 / r0, 1.0)
        cos2 = max(1.0 - sin_i ** 2, 0.0)
        R2 = (r0 ** 4 * max(np.sin(d), 1e-9) * cos2 * abs(slope)
              / (max(pk, 1e-12) * v0 ** 2))
        R_pcp = np.sqrt(max(R2, 0.0))
        # CMB incidence: horizontal slowness at the interface (s/km)
        p_flat = pk / r0 * (r0 / cmb)   # p_sph/r = sin(i)/v at radius cmb
        refl = abs(scattering(med1, med2, p_flat, "P")["PP_r"])
        ratio = (R_p[i] / max(R_pcp, 1e-9)) * refl
        if q_factor:
            ratio *= np.exp(-np.pi * freq_hz
                            * (t_pcp[i] - t_p[i]) / q_factor)
        out[i] = ratio
    return out
