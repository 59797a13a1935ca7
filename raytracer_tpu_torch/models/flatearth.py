r"""High-precision 1-D ray kinematics: piecewise-linear flattened model.

Host-side NumPy, a copy of `raytracer_tpu/models/flatearth.py` (the port
imports nothing of the JAX package); `tests/test_torch_amplitude.py`
holds it equal to the original.

This supersedes the piecewise-CONSTANT shell integrals of
`models/raytheory.py` as the repo's independent accuracy anchor (the role
TauP played for the reference, /root/reference/main_annulus.jl:74-76).
The constant-shell anchor carries an intrinsic ~0.5-1 s discretisation
error; this engine is exact for a model that is piecewise linear in the
flattened depth coordinate, which at the vendored tables' 1-km sampling
puts the anchor's self-error below ~0.01 s (measured by knot-halving in
tests/test_flatearth.py) -- far below anything the SPM grid resolves.

Method: the classical Earth-flattening transformation

    z = R ln(R/r),        v_flat(z) = v(r) * R / r

is *kinematically exact*: travel time T is invariant and flat horizontal
distance X maps to epicentral angle Delta = X/R.  Within a flat layer
whose velocity is linear in z (v(z) = v1 + b (z - z1)) the ray integrals
have the textbook closed forms (Aki & Richards ch. 9; with q = p v,
c = sqrt(1 - q^2) the cosine of incidence):

    X = (c1 - c2) / (p b)            [stable form: p (v2^2-v1^2)/(b (c1+c2))]
    T = ln( v2 (1 + c1) / (v1 (1 + c2)) ) / b

with (v2, c2) replaced by (1/p, 0) when the ray turns inside the layer,
and the constant-gradient-free limits X = h p v / c, T = h / (v c) for
b = 0.  First arrivals come from the tau-p lower envelope over turning
rays (exact for refracted branches, including PKP/PKIKP through the
core stack) plus explicit interface-diffraction extensions (Pdiff).

The transform diverges at r = 0; the stack is closed with log-spaced
sub-kilometre knots so only the exactly-antipodal vertical ray feels the
truncation (< 0.01 s, measured).
"""
from __future__ import annotations

import numpy as np

from ..config import R


class RadialModel:
    """Radial velocity model with analytic piecewise-linear ray integrals.

    Parameters
    ----------
    r, v : ascending radii (km) and velocities (km/s) at those radii; the
        model is linear in between (matching `LinearInterpolation` /
        `interpolate_velocity`, so the anchor integrates the *same* model
        the SPM solver discretises).  Non-positive radii are dropped; the
        centre is closed with log-spaced knots down to ~15 m.
    """

    def __init__(self, r, v):
        r = np.asarray(r, np.float64)
        v = np.asarray(v, np.float64)
        order = np.argsort(r)
        r, v = r[order], v[order]
        keep = r > 0.0
        r, v = r[keep], v[keep]
        self.R0 = float(r[-1])
        self.v_surf = float(v[-1])

        # close the centre: log-spaced knots from the innermost sample down
        # to ~0.015 km (v extended as constant -- it is, to 5 digits, in
        # both vendored tables' inner core)
        r0 = float(r[0])
        if r0 > 0.02:
            sub = r0 * 0.5 ** np.arange(1, 11)
            sub = sub[sub > 0.015]
            r = np.concatenate([sub[::-1], r])
            v = np.concatenate([np.full(sub.size, v[0]), v])

        # subdivide layers that are thick in FLATTENED depth (deep layers:
        # dz = R dr / r blows up near the centre): the model is linear in
        # r between knots, but the integrals treat v_flat linear in z, so
        # thick flat layers discretise the exponential flattening poorly.
        # Sampling the r-linear model at extra knots converges the
        # integrals to the true model (~(dz/R)^2 per layer).
        z_knots = self.R0 * np.log(self.R0 / np.maximum(r, 1e-12))
        dz = np.abs(np.diff(z_knots))
        z_max = 10.0
        if np.any(dz > z_max):
            pieces_r = [r[:1]]
            pieces_v = [v[:1]]
            for i in range(len(r) - 1):
                n_sub = int(dz[i] // z_max)
                if n_sub > 0:
                    # geometric radii interpolate z uniformly
                    rr = np.geomspace(r[i], r[i + 1], n_sub + 2)[1:-1]
                    pieces_r.append(rr)
                    pieces_v.append(np.interp(rr, r, v))
                pieces_r.append(r[i + 1:i + 2])
                pieces_v.append(v[i + 1:i + 2])
            r = np.concatenate(pieces_r)
            v = np.concatenate(pieces_v)

        rd = r[::-1].copy()          # surface -> centre
        vd = v[::-1].copy()
        z = self.R0 * np.log(self.R0 / rd)
        u = vd * self.R0 / rd        # flattened velocities

        h = np.diff(z)
        pos = h > 0                  # drop zero-thickness (duplicate radius)
        self.v1 = u[:-1][pos]
        self.v2 = u[1:][pos]
        self.h = h[pos]
        self.b = (self.v2 - self.v1) / self.h
        self.r_top = rd[:-1][pos]
        self.r_bot = rd[1:][pos]
        self.v_of_r_r = r            # for slowness lookups
        self.v_of_r_v = v

    # -- core integrals ---------------------------------------------------

    def _stack_above(self, r_stop: float):
        """Layer arrays (v1, v2, b, h) truncated at radius `r_stop`; the
        layer containing r_stop is clipped to it (partial layer), so
        r_stop need not be a model knot."""
        if r_stop <= self.r_bot[-1]:
            return self.v1, self.v2, self.b, self.h
        k = int(np.searchsorted(-self.r_bot, -(r_stop - 1e-9)))
        v1, v2, b, h = (self.v1[:k], self.v2[:k], self.b[:k], self.h[:k])
        r_above = self.r_bot[k - 1] if k > 0 else self.R0
        if k < len(self.v1) and r_above > r_stop + 1e-9:
            # append the partial top piece of layer k, down to r_stop
            z_top = self.R0 * np.log(self.R0 / r_above)
            z_stop = self.R0 * np.log(self.R0 / r_stop)
            h_new = z_stop - z_top
            v1 = np.append(v1, self.v1[k])
            v2 = np.append(v2, self.v1[k] + self.b[k] * h_new)
            b = np.append(b, self.b[k])
            h = np.append(h, h_new)
        return v1, v2, b, h

    def down_leg(self, p_sph, r_stop: float = 0.0):
        """One-way ray integrals from the surface down.

        p_sph : spherical ray parameter(s), s/rad.
        r_stop: stop radius (a model knot, e.g. the CMB for PcP legs).

        Returns (delta, T, reached): epicentral angle (rad) and time (s)
        accumulated from the surface to the turning point or to `r_stop`,
        whichever comes first, and whether the ray reached `r_stop`
        without turning.  Vectorised over p, chunked AND depth-truncated:
        a ray of spherical parameter p is dead past the first layer whose
        flattened velocity reaches R0/p, so each descending-sorted p
        chunk only touches the stack prefix its shallowest-turning member
        can reach (the flattened 1-km table is ~13k layers; large-p
        chunks touch a few hundred).
        """
        p_all = np.atleast_1d(np.asarray(p_sph, np.float64))
        v1f, v2f, bf, hf = self._stack_above(r_stop)
        L = v1f.size
        vmax_acc = np.maximum.accumulate(np.maximum(v1f, v2f))
        if p_all.size > 1024:
            order = np.argsort(-p_all, kind="stable")
            ps = p_all[order]
            X = np.empty(p_all.size)
            T = np.empty(p_all.size)
            reach = np.empty(p_all.size, dtype=bool)
            for i in range(0, ps.size, 1024):
                o = self.down_leg(ps[i:i + 1024], r_stop)
                X[i:i + 1024], T[i:i + 1024], reach[i:i + 1024] = o
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            return X[inv], T[inv], reach[inv]
        p = p_all / self.R0
        p_min = float(p_all.min(initial=np.inf))
        if p_min > 0.0 and np.isfinite(p_min):
            k_cut = min(int(np.searchsorted(vmax_acc, self.R0 / p_min)) + 1, L)
        else:
            k_cut = L
        v1, v2, b, h = (v1f[:k_cut], v2f[:k_cut], bf[:k_cut], hf[:k_cut])
        v1, v2, b, h = v1[None, :], v2[None, :], b[None, :], h[None, :]
        pc = p[:, None]

        q1 = pc * v1
        q2 = pc * v2
        c1 = np.sqrt(np.maximum(1.0 - q1 * q1, 0.0))
        c2 = np.sqrt(np.maximum(1.0 - q2 * q2, 0.0))

        enters = q1 < 1.0
        traverses = enters & (q2 < 1.0)
        alive = np.ones(enters.shape, dtype=bool)
        alive[:, 1:] = np.cumprod(traverses[:, :-1], axis=1).astype(bool)
        act = alive & enters
        turn = act & ~traverses

        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            v2e = np.where(turn, 1.0 / np.maximum(pc, 1e-300), v2)
            c2e = np.where(turn, 0.0, c2)
            lin = b != 0.0
            den = np.where(lin, b, 1.0) * np.maximum(c1 + c2e, 1e-300)
            X_lin = pc * (v2e * v2e - v1 * v1) / den
            T_lin = np.log(v2e * (1.0 + c1)
                           / (v1 * (1.0 + c2e))) / np.where(lin, b, 1.0)
            c1s = np.maximum(c1, 1e-300)
            X_con = h * pc * v1 / c1s
            T_con = h / (v1 * c1s)
            X = np.where(act, np.where(lin, X_lin, X_con), 0.0)
            T = np.where(act, np.where(lin, T_lin, T_con), 0.0)

        reached = traverses.all(axis=1)
        return X.sum(axis=1) / self.R0, T.sum(axis=1), reached

    def turning_radius(self, p_sph) -> np.ndarray:
        """Turning radius (km) of a surface-launched ray, NaN if the ray
        reaches the bottom of the stack.  The turning point is where the
        flattened velocity first reaches 1/p going down; within the
        (linear) turning layer z_t = z1 + (1/p - v1)/b."""
        p_all = np.atleast_1d(np.asarray(p_sph, np.float64))
        if p_all.size > 1024:
            # chunk + depth-truncate exactly like down_leg (the stops
            # logic only needs the stack prefix any chunk member reaches)
            order = np.argsort(-p_all, kind="stable")
            ps = p_all[order]
            out = np.concatenate([self.turning_radius(ps[i:i + 1024])
                                  for i in range(0, ps.size, 1024)])
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            return out[inv]
        p = p_all / self.R0
        L = self.v1.size
        p_min = float(p_all.min(initial=np.inf))
        if p_min > 0.0 and np.isfinite(p_min):
            vmax_acc = np.maximum.accumulate(np.maximum(self.v1, self.v2))
            k_cut = min(int(np.searchsorted(vmax_acc, self.R0 / p_min)) + 1, L)
        else:
            k_cut = L
        v1 = self.v1[None, :k_cut]
        v2 = self.v2[None, :k_cut]
        q1 = p[:, None] * v1
        q2 = p[:, None] * v2
        enters = q1 < 1.0
        traverses = enters & (q2 < 1.0)
        alive = np.ones(enters.shape, dtype=bool)
        alive[:, 1:] = np.cumprod(traverses[:, :-1], axis=1).astype(bool)
        stops = alive & ~traverses
        any_stop = stops.any(axis=1)
        k = np.argmax(stops, axis=1)
        z1 = self.R0 * np.log(self.R0 / self.r_top[k])
        b = self.b[k]
        with np.errstate(divide="ignore", invalid="ignore"):
            v_t = 1.0 / np.maximum(p, 1e-300)
            dz = np.where(b != 0.0, (v_t - self.v1[k]) / np.where(
                b != 0.0, b, 1.0), 0.0)
            dz = np.clip(dz, 0.0, self.h[k])
            # total reflection at the layer top (did not enter): turn at top
            entered_k = p * self.v1[k] < 1.0
            z_t = np.where(entered_k, z1 + dz, z1)
        r_t = self.R0 * np.exp(-z_t / self.R0)
        return np.where(any_stop, r_t, np.nan)

    def slowness_above(self, r_at: float) -> float:
        """Spherical slowness r/v approaching `r_at` from above (s/rad)."""
        ri = self.v_of_r_r
        vi = self.v_of_r_v
        i = int(np.searchsorted(ri, r_at + 1e-9))
        i = min(max(i, 1), len(ri) - 1)
        return float(r_at) / float(vi[i])

    # -- phase kinematics ---------------------------------------------------

    def direct_branch(self, n_p: int = 6000):
        """Turning-ray curves: (p, delta, T, tau) over a dense p grid,
        invalid (non-turning / degenerate) rays masked to NaN.  Cached
        per n_p (the anchor functions are called repeatedly in tests)."""
        cache = getattr(self, "_branch_cache", None)
        if cache is None:
            cache = self._branch_cache = {}
        if n_p in cache:
            return cache[n_p]
        p_max = self.R0 / self.v_surf
        # uniform grid plus a geometric small-p head: near-antipodal
        # arrivals ride near-vertical rays whose delta(p) varies fast in
        # log p, which a pure linspace undersamples
        head = np.geomspace(p_max * 1e-9, p_max / n_p, max(n_p // 16, 64))
        p = np.unique(np.concatenate([
            head, np.linspace(p_max * 1e-7, p_max * (1.0 - 1e-9), n_p)]))
        X, T, reached = self.down_leg(p)
        delta = 2.0 * X
        T = 2.0 * T
        bad = reached | (delta <= 0)
        delta[bad] = np.nan
        T[bad] = np.nan
        tau = T - p * delta
        cache[n_p] = (p, delta, T, tau)
        return cache[n_p]

    def buried_branch(self, r_src: float, n_p: int = 6000):
        """(p, delta, T, tau, is_up) direct-branch curves from a source
        at radius `r_src`: the DOWNGOING family is the surface-to-
        surface turning branch minus the surface->r_src leg (valid
        where the ray reaches r_src, i.e. turns below the source), the
        UPGOING family is that leg itself reversed (source straight up
        to the surface).  Earth-flattening makes both exact leg-
        integral sums/differences; r_src at the surface degenerates to
        `direct_branch`.  Cached per (r_src, n_p)."""
        cache = getattr(self, "_buried_cache", None)
        if cache is None:
            cache = self._buried_cache = {}
        key = (float(r_src), n_p)
        if key in cache:
            return cache[key]
        p, delta, T, tau = self.direct_branch(n_p)
        ok = ~np.isnan(delta)
        pg = p[ok]
        Xl, Tl, reach = self.down_leg(pg, r_stop=r_src)
        d_dn = delta[ok] - Xl
        T_dn = T[ok] - Tl
        good = reach & (d_dn > 0)
        p_all = np.concatenate([pg[good], pg[reach]])
        d_all = np.concatenate([d_dn[good], Xl[reach]])
        T_all = np.concatenate([T_dn[good], Tl[reach]])
        is_up = np.concatenate([np.zeros(int(good.sum()), bool),
                                np.ones(int(reach.sum()), bool)])
        cache[key] = (p_all, d_all, T_all, T_all - p_all * d_all, is_up)
        return cache[key]

    def first_arrival(self, delta_deg, n_p: int = 6000,
                      diff_radii=(), return_p: bool = False,
                      turn_below: float = None,
                      source_radius: float = None):
        """First-arrival times by the tau-p lower envelope over all
        turning rays, extended by interface diffraction at each radius in
        `diff_radii` (e.g. the CMB for Pdiff).  Exact for refracted
        branches; the diffracted extension is the standard grazing-ray +
        interface-slide kinematic.

        turn_below: restrict the envelope to rays turning below this
        radius -- the way to query a specific deep branch on the 1-km
        tables, whose smeared discontinuities otherwise let near-grazing
        rays turn INSIDE the transition and kinematically shadow it
        (e.g. PKIKP = turn_below just above the ICB; without it the
        envelope at 180 deg returns the CMB-smear turning limit, which
        IS the first arrival of the smeared model).

        source_radius: source at depth (km radius) -- the envelope runs
        over `buried_branch` (downgoing family one source leg short,
        plus the upgoing family) and the interface-diffraction legs are
        shortened by the source leg on the source side."""
        buried = (source_radius is not None
                  and source_radius < self.R0 - 1e-9)
        up_d = up_T = up_p = None
        if buried:
            p_b, d_b, T_b, tau_b, is_up = self.buried_branch(
                source_radius, n_p)
            # the DOWNGOING family keeps the surface branch's convex
            # tau(p) (one leg subtracted), so the lower envelope stays
            # exact; the UPGOING leg has delta INCREASING with p (tau
            # concave), where the envelope operator is invalid -- its
            # delta(p) is monotone, so first arrivals come from direct
            # T(delta) interpolation instead
            ok = ~is_up
            if turn_below is not None:
                r_t = self.turning_radius(p_b)
                ok &= ~np.isnan(r_t) & (r_t <= turn_below)
            elif is_up.any():
                order = np.argsort(d_b[is_up], kind="stable")
                up_d = d_b[is_up][order]
                up_T = T_b[is_up][order]
                up_p = p_b[is_up][order]
            p_ok, tau_ok = p_b[ok], tau_b[ok]
            # a buried downgoing family does NOT reach delta -> 0 (its
            # steep limit passes the core; its grazing limit turns at
            # the source depth): below its coverage the envelope would
            # extrapolate under the true upgoing arrival, so gate it
            env_d_lo = (float(np.min(d_b[ok])) if ok.any() else np.inf)
        else:
            p, delta, T, tau = self.direct_branch(n_p)
            ok = ~np.isnan(tau)
            if turn_below is not None:
                r_t = self.turning_radius(p)
                ok &= ~np.isnan(r_t) & (r_t <= turn_below)
            p_ok, tau_ok = p[ok], tau[ok]
            env_d_lo = -np.inf

        diffs = []
        for r_if in diff_radii:
            p_d = self.slowness_above(r_if) * (1.0 - 1e-12)
            Xg, Tg, reached = self.down_leg(np.array([p_d]), r_stop=r_if)
            if reached[0]:
                dg, tg = 2.0 * Xg[0], 2.0 * Tg[0]
                if buried:
                    Xs, Ts, rs = self.down_leg(np.array([p_d]),
                                               r_stop=source_radius)
                    if not rs[0]:
                        continue     # grazing ray turns above the source
                    dg, tg = dg - Xs[0], tg - Ts[0]
                diffs.append((dg, tg, p_d))

        dd = np.atleast_1d(np.asarray(delta_deg, np.float64))
        out = np.empty(dd.shape)
        pout = np.empty(dd.shape)
        for i, d in enumerate(np.deg2rad(dd)):
            if d >= env_d_lo - 1e-9 and p_ok.size:
                t_env = tau_ok + p_ok * d
                k = int(np.argmin(t_env))
                t_best, p_best = t_env[k], p_ok[k]
            else:
                t_best, p_best = np.inf, np.nan
            if up_d is not None and up_d.size and d <= up_d[-1]:
                t_u = float(np.interp(d, up_d, up_T))
                if t_u < t_best:
                    t_best = t_u
                    p_best = float(np.interp(d, up_d, up_p))
            for (dg, tg, p_d) in diffs:
                if d >= dg and tg + p_d * (d - dg) < t_best:
                    t_best = tg + p_d * (d - dg)
                    p_best = p_d
            out[i] = t_best
            pout[i] = p_best
        if return_p:
            return out, pout
        return out

    def reflected(self, delta_deg, r_reflect: float, n_p: int = 6000,
                  source_radius: float = None):
        """Times of the topside-reflection branch at `r_reflect` (PcP for
        the CMB, PKiKP for the ICB): down to the reflector without
        turning, bounce, retrace.  Delta(p) is monotone on this branch, so
        T(Delta) follows by interpolation; NaN outside the branch.
        source_radius: buried source -- the source-side leg is the full
        surface leg minus the surface->source piece."""
        p_g = self.slowness_above(r_reflect)
        p = np.linspace(0.0, p_g * (1.0 - 1e-9), n_p)
        X, T, reached = self.down_leg(p, r_stop=r_reflect)
        ok = reached
        delta = 2.0 * X[ok]
        times = 2.0 * T[ok]
        if source_radius is not None and source_radius < self.R0 - 1e-9:
            Xs, Ts, rs = self.down_leg(p[ok], r_stop=source_radius)
            keep = rs
            delta = delta[keep] - Xs[keep]
            times = times[keep] - Ts[keep]
            order = np.argsort(delta)
            delta, times = delta[order], times[order]
        dd = np.deg2rad(np.atleast_1d(np.asarray(delta_deg, np.float64)))
        return np.interp(dd, delta, times, right=np.nan)

    def spreading(self, delta_deg, n_p: int = 6000, diff_radii=()):
        """Geometrical-spreading distance R(Delta) (km) of the first
        arrival, from the ANALYTIC branch derivative dDelta/dp (the
        curves here are smooth in p, unlike the constant-shell engine
        whose delta(p) is staircase-jagged).
        Returns inf where the first arrival is an interface-diffracted
        ray (ray-theory spreading is undefined there: the branch is a
        straight line in (Delta, T), |dp/dDelta| = 0)."""
        p, delta, T, tau = self.direct_branch(n_p)
        ok = ~np.isnan(tau)
        p_ok, d_okk, tau_ok = p[ok], delta[ok], tau[ok]
        dd = np.atleast_1d(np.asarray(delta_deg, np.float64))
        t_refr, p_refr = self.first_arrival(dd, n_p=n_p, return_p=True)
        if diff_radii:
            t_all, p_all = self.first_arrival(dd, n_p=n_p,
                                              diff_radii=diff_radii,
                                              return_p=True)
        else:
            t_all, p_all = t_refr, p_refr
        r_turn = self.turning_radius(p_refr)

        r0, v0 = self.R0, self.v_surf
        # delta(p) is piecewise-analytic with tiny derivative kinks where
        # the turning point crosses a model knot; a wide symmetric secant
        # averages over several crossings (pointwise gradients wobble
        # 1-10% at coarse knot spacings)
        h_sec = (p_ok[-1] - p_ok[0]) / 500.0
        out = np.empty(dd.shape)
        for i, d in enumerate(np.deg2rad(dd)):
            if t_all[i] < t_refr[i] - 1e-9:
                out[i] = np.inf          # diffracted first arrival
                continue
            # rays turning INSIDE a smeared interface (the 1-km tables
            # have no true discontinuities) are the diffracted limit in
            # disguise: ray-theory spreading is meaningless there too
            if any(abs(r_turn[i] - r_if) < 2.5 for r_if in diff_radii):
                out[i] = np.inf
                continue
            pk = p_refr[i]
            lo = float(np.interp(pk - h_sec, p_ok, d_okk))
            hi = float(np.interp(pk + h_sec, p_ok, d_okk))
            slope = (hi - lo) / (2.0 * h_sec)
            if not np.isfinite(slope) or abs(slope) < 1e-12:
                out[i] = np.inf
                continue
            sin_i = min(pk * v0 / r0, 1.0)
            cos_i2 = max(1.0 - sin_i * sin_i, 0.0)
            R2 = (r0 ** 4 * np.sin(d) * cos_i2 * abs(slope)
                  / (max(pk, 1e-12) * v0 * v0))
            out[i] = np.sqrt(max(R2, 0.0))
        return out


# -- module-level conveniences (vendored-table wrappers) --------------------

_MODEL_CACHE: dict = {}


def table_model(model: str = "ak135", wave: str = "Vp") -> RadialModel:
    """RadialModel for a vendored velocity table (cached)."""
    key = (model, wave)
    if key not in _MODEL_CACHE:
        from .velocity import velocity_profile

        prof = velocity_profile(model)
        v = getattr(prof, wave if wave in ("Vp", "Vs") else "Vp")
        _MODEL_CACHE[key] = RadialModel(prof.r, v)
    return _MODEL_CACHE[key]


def cmb_radius(model: str = "ak135") -> float:
    """Radius of the core-mantle boundary knot in a vendored table: the
    largest radius where Vs crosses to zero (top of the fluid outer core)."""
    from .velocity import velocity_profile

    prof = velocity_profile(model)
    zero = prof.r[np.asarray(prof.Vs) <= 1e-9]
    return float(zero.max())


_CONVERTED_CACHE: dict = {}


def converted_branch(model: str = "ak135",
                     legs=("Vs", "Vp", "Vs"),
                     r_boundary: float = None, n_p: int = 6000):
    """(p, delta, T, tau) curves of the boundary-converted core class.

    legs = (down wave, core wave, up wave): 'Vs','Vp','Vs' is SKS,
    'Vp','Vp','Vp' is PKP (including PKIKP -- the core stack covers the
    inner core), 'Vs','Vp','Vp' is SKP, etc.  The spherical ray
    parameter p (s/rad) is conserved across the conversion, so the
    class branch is the p-wise sum of three leg integrals: the mantle
    down/up legs on the full-table model truncated at the boundary
    (must REACH it without turning) and a full turning path inside a
    core-only RadialModel whose surface is the boundary (the
    Earth-flattening invariants p_f v_f = p_sph v / r make the leg
    integrals independent of each sub-model's reference radius).
    r_boundary defaults to the table's own fluid-core top
    (`cmb_radius`).  Cached per argument tuple.
    """
    r_b = cmb_radius(model) if r_boundary is None else float(r_boundary)
    key = (model, tuple(legs), r_b, n_p)
    if key in _CONVERTED_CACHE:
        return _CONVERTED_CACHE[key]
    from .velocity import velocity_profile

    prof = velocity_profile(model)
    sel = prof.r <= r_b + 1e-9
    v_core = getattr(prof, legs[1] if legs[1] in ("Vp", "Vs") else "Vp")
    m_core = RadialModel(prof.r[sel], np.asarray(v_core)[sel])
    m_dn = table_model(model, legs[0])
    m_up = table_model(model, legs[2])

    # an S mantle leg cannot integrate down to the zero-Vs knot (the
    # flattened T integral log-diverges as v -> 0): stop it at the last
    # positive-Vs row instead.  The skipped ~1 table step is the
    # table's own smear of the conversion depth (<= ~0.15 s vertical),
    # the same ambiguity the SPM grid's buffered dual velocities carry.
    vs = np.asarray(prof.Vs)

    def _leg_stop(wave):
        if wave != "Vs":
            return r_b
        above = (prof.r > r_b) & (vs > 1e-9)
        return float(prof.r[above].min()) if above.any() else r_b

    p, d_core, T_core, _ = m_core.direct_branch(n_p)
    ok = ~np.isnan(d_core)
    X1, T1, reach1 = m_dn.down_leg(p[ok], r_stop=_leg_stop(legs[0]))
    if legs[2] == legs[0]:
        X2, T2, reach2 = X1, T1, reach1
    else:
        X2, T2, reach2 = m_up.down_leg(p[ok], r_stop=_leg_stop(legs[2]))
    good = reach1 & reach2
    pg = p[ok][good]
    delta = X1[good] + X2[good] + d_core[ok][good]
    T = T1[good] + T2[good] + T_core[ok][good]
    tau = T - pg * delta
    _CONVERTED_CACHE[key] = (pg, delta, T, tau)
    return _CONVERTED_CACHE[key]


def converted_first_arrival(delta_deg, model: str = "ak135",
                            legs=("Vs", "Vp", "Vs"),
                            r_boundary: float = None, n_p: int = 6000):
    """First arrivals of the boundary-converted core class by the tau-p
    lower envelope over `converted_branch` (exact for the refracted
    branches; NaN where the class has no ray, i.e. below the branch's
    minimum distance the envelope would extrapolate, so distances
    outside [min, max] branch delta return NaN)."""
    pg, delta, T, tau = converted_branch(model, legs, r_boundary, n_p)
    dd = np.atleast_1d(np.asarray(delta_deg, np.float64))
    out = np.full(dd.shape, np.nan)
    if pg.size == 0:
        return out
    d_lo, d_hi = float(np.min(delta)), float(np.max(delta))
    for i, d in enumerate(np.deg2rad(dd)):
        if d < d_lo - 1e-12 or d > d_hi + 1e-12:
            continue
        out[i] = float(np.min(tau + pg * d))
    return out


_DEPTH_PHASE_CACHE: dict = {}

_DEPTH_PHASES = {"pP": ("Vp", "Vp"), "sP": ("Vs", "Vp"),
                 "sS": ("Vs", "Vs"), "pS": ("Vp", "Vs")}


def depth_phase_branch(source_radius: float, phase: str = "pP",
                       model: str = "ak135", n_p: int = 6000):
    """(p, delta, T, tau) curves of a free-surface depth phase.

    A depth phase (pP, sP, sS, pS -- lowercase letter = the short
    UP-going leg from the buried source to the free surface, uppercase
    = the full surface-to-surface main branch after the bounce) is the
    p-wise sum of two leg integrals joined at equal spherical ray
    parameter (Snell at the free-surface reflection): the up leg is
    `down_leg(p, r_stop=source_radius)` of the up-leg wave's model,
    valid where the ray reaches the source radius without turning, and
    the main leg is that wave's full `direct_branch`.  The reference
    has no depth-phase capability (its phase library
    src/multiphase/library.jl:9-31 is dead code); this anchor exists to
    pin the SPM bounce composition (solvers/phases.py::
    depth_phase_travel_times) and to invert pP-P delays for depth.
    Cached per argument tuple."""
    if phase not in _DEPTH_PHASES:
        raise ValueError(f"unknown depth phase {phase!r}; one of "
                         f"{sorted(_DEPTH_PHASES)}")
    key = (float(source_radius), phase, model, n_p)
    if key in _DEPTH_PHASE_CACHE:
        return _DEPTH_PHASE_CACHE[key]
    up_w, main_w = _DEPTH_PHASES[phase]
    m_main = table_model(model, main_w)
    m_up = m_main if up_w == main_w else table_model(model, up_w)
    p, delta, T, _ = m_main.direct_branch(n_p)
    ok = ~np.isnan(delta)
    p_ok, d_ok, T_ok = p[ok], delta[ok], T[ok]
    Xu, Tu, reach = m_up.down_leg(p_ok, r_stop=source_radius)
    pg = p_ok[reach]
    dg = d_ok[reach] + Xu[reach]
    Tg = T_ok[reach] + Tu[reach]
    _DEPTH_PHASE_CACHE[key] = (pg, dg, Tg, Tg - pg * dg)
    return _DEPTH_PHASE_CACHE[key]


def depth_phase_first_arrival(delta_deg, source_depth_km: float,
                              phase: str = "pP", model: str = "ak135",
                              n_p: int = 6000, return_p: bool = False):
    """First arrivals of a depth-phase family by the tau-p lower
    envelope over `depth_phase_branch` (exact on the prograde branch,
    the family first arrival across triplications); NaN outside the
    branch's delta coverage, where the envelope would extrapolate."""
    if phase not in _DEPTH_PHASES:
        raise ValueError(f"unknown depth phase {phase!r}; one of "
                         f"{sorted(_DEPTH_PHASES)}")
    r_src = (table_model(model, _DEPTH_PHASES[phase][1]).R0
             - float(source_depth_km))
    pg, delta, T, tau = depth_phase_branch(r_src, phase, model, n_p)
    dd = np.atleast_1d(np.asarray(delta_deg, np.float64))
    out = np.full(dd.shape, np.nan)
    pout = np.full(dd.shape, np.nan)
    if pg.size:
        # gate per-point against actual branch coverage, not just the
        # global [min,max] window: if the composed branch's delta
        # samples ever have an interior gap, the tau-p envelope must
        # return NaN there instead of silently extrapolating across it
        d_sorted = np.sort(delta)
        gaps = np.diff(d_sorted)
        cov_tol = max(3.0 * float(np.median(gaps)) if gaps.size else 0.0,
                      1e-9)
        for i, d in enumerate(np.deg2rad(dd)):
            k_near = int(np.searchsorted(d_sorted, d))
            near = min(abs(d - d_sorted[j])
                       for j in (max(k_near - 1, 0),
                                 min(k_near, d_sorted.size - 1)))
            if near <= cov_tol:
                t_env = tau + pg * d
                k = int(np.argmin(t_env))
                out[i], pout[i] = t_env[k], pg[k]
    return (out, pout) if return_p else out


def depth_from_depth_phase(delay_s: float, delta_deg: float,
                           phase: str = "pP", model: str = "ak135",
                           depth_bracket=(2.0, 750.0), n_p: int = 3000,
                           tol_km: float = 0.05) -> float:
    """Invert a picked depth-phase delay (t_phase - t_main, seconds, at
    epicentral distance `delta_deg`) for source depth (km) -- the
    classical use of depth phases, and the practical way to wire them
    into location workflows: locate the epicentre from first arrivals,
    then fix the depth from the pP-P (or sP-P / sS-S) delay, which is
    monotone increasing in depth.  Bisection on the anchor's own delay
    curve; raises if the delay is outside the bracket's range."""
    if phase not in _DEPTH_PHASES:
        raise ValueError(f"unknown depth phase {phase!r}; one of "
                         f"{sorted(_DEPTH_PHASES)}")
    main_w = _DEPTH_PHASES[phase][1]
    m_main = table_model(model, main_w)

    def f(h):
        r_src = m_main.R0 - h
        t_dp = depth_phase_first_arrival([delta_deg], h, phase, model,
                                         n_p)[0]
        t_main = m_main.first_arrival([delta_deg], n_p=n_p,
                                      source_radius=r_src)[0]
        return t_dp - t_main - delay_s

    lo, hi = map(float, depth_bracket)
    f_lo, f_hi = f(lo), f(hi)
    # the branch's depth coverage at this distance can end inside the
    # bracket (e.g. pP at 40 deg exists only to ~700 km in ak135: deeper
    # sources push the bounce past the direct branch end into the core
    # shadow) -- shrink each uncovered end to the coverage edge (depth
    # coverage is contiguous: the branch's delta window moves
    # monotonically with source depth)
    if not (np.isfinite(f_lo) or np.isfinite(f_hi)):
        raise ValueError("depth-phase branch does not cover "
                         f"delta={delta_deg} over the depth bracket")

    def _edge(a, fa, b):
        """Largest step from covered `a` toward uncovered `b`."""
        for _ in range(24):
            m = 0.5 * (a + b)
            fm = f(m)
            if np.isfinite(fm):
                a, fa = m, fm
            else:
                b = m
        return a, fa

    if not np.isfinite(f_hi):
        hi, f_hi = _edge(lo, f_lo, hi)
    elif not np.isfinite(f_lo):
        lo, f_lo = _edge(hi, f_hi, lo)
    if f_lo > 0 or f_hi < 0:
        raise ValueError(f"delay {delay_s:.2f}s outside the bracket's "
                         f"delay range [{f_lo + delay_s:.2f}, "
                         f"{f_hi + delay_s:.2f}]s")
    while hi - lo > tol_km:
        mid = 0.5 * (lo + hi)
        if f(mid) <= 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
