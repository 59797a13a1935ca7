"""Earthquake hypocenter location from first-arrival picks.

Counterpart of `raytracer_tpu/solvers/locate.py`, in three steps:

  1. **Station fields by reciprocity.**  The edge weight
     t = 2L/(U_i+U_j) is symmetric in (i, j) (for the dual (below, above)
     convention the head/tail pick flips with the direction, so the sum
     U_head+U_tail is unchanged), hence one solve per *station* gives
     t(x -> station_k) for every candidate node x: K solves in all.
  2. **Grid search with the origin time eliminated.**  For picks
     t_k = t0 + T_k(x) the weighted least-squares origin time at a node
     is the weighted mean residual, so the node misfit is the demeaned
     residual variance, evaluated for ALL nodes at once: on the card one
     call of the `gridsearch` kernel (`ops/gridsearch.py`) for one event
     or a whole catalogue, on the CPU its plain twins.
  3. **Sub-grid Gauss-Newton refinement.**  By the eikonal equation
     grad_x T_k = s * u_k with u_k the unit ray direction at x; u_k is
     read off the best node's incoming graph edge in field k (the
     fixpoint predecessor) and s is that segment's harmonic slowness
     w/L.  One linear least-squares solve on the host then yields
     (dx, dz, dt0), clamped to the local node spacing.

`bend=True` replaces the best node's graph times with bent ones (the
`bend` kernel, `solvers/refine.py`).  The searches run in the fields'
dtype (float64 from `station_fields`), on the solver's device (2-D) or
on `device` (3-D), which is the card unless the caller passes "cpu".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import R
from ..ops.gridsearch import grid_search


@dataclass
class Location:
    """Result of `locate`: grid-search node plus the refined solution."""
    node: int                 # best grid node
    x: float                  # refined cartesian position (km)
    z: float
    theta: float              # refined polar coordinates
    r: float
    t0: float                 # origin time (s)
    rms: float                # weighted rms residual at the solution (s)
    node_rms: float           # rms at the best node (before refinement)
    delta: np.ndarray         # applied sub-grid shift (2,) km


def station_fields(solver, stations: Sequence[int]) -> np.ndarray:
    """(K, n) travel-time fields solved FROM each station; by weight
    symmetry these are x->station times for every node x.  Amortise
    across events by computing once and passing to `locate(fields=...)`."""
    n = int(solver.gr.nnods)
    return np.asarray(
        solver.travel_time_table([int(s) for s in stations], np.arange(n)),
        dtype=np.float64,
    )


def _run_search(T: np.ndarray, T_obs: np.ndarray, w2: np.ndarray,
                device, mode: str):
    """[(j, t0, m)] per event row of T_obs, by `grid_search` on `device`
    in T's dtype (float64)."""
    dev = torch.device(device)
    j, t0, m = grid_search(
        torch.as_tensor(np.asarray(T, np.float64), device=dev),
        torch.as_tensor(np.atleast_2d(T_obs), device=dev),
        torch.as_tensor(w2, device=dev), mode)
    return list(zip(j.cpu().tolist(), t0.cpu().tolist(), m.cpu().tolist()))


def _twin_partners_of(halo, node: int) -> list:
    if halo is None:
        return []
    halo = np.asarray(halo)
    if halo.size == 0:
        return []
    out = set(halo[halo[:, 0] == node, 1].tolist())
    out |= set(halo[halo[:, 1] == node, 0].tolist())
    return sorted(out)


def _edge_weight_in(gr, U: np.ndarray, tails: np.ndarray,
                    heads: np.ndarray, L: np.ndarray) -> np.ndarray:
    """Weights of edges tails <- heads, matching ops/weights.py exactly
    (scalar harmonic mean, or the dual head/tail radius pick)."""
    U = np.asarray(U, np.float64)
    if U.ndim == 1:
        usum = U[tails] + U[heads]
    else:
        r = np.asarray(gr.r)
        head_above = r[tails] > r[heads]
        U_head = np.where(head_above, U[heads, 1], U[heads, 0])
        U_tail = np.where(head_above, U[tails, 0], U[tails, 1])
        usum = U_head + U_tail
    return np.where(usum > 0, 2.0 * L / np.where(usum > 0, usum, 1.0),
                    np.inf)


def _ray_gradients(gr, A, halo, U, T: np.ndarray, node: int):
    """(K, 2) gradients grad_x T_k at `node` and the local spacing.

    The fixpoint predecessor of `node` in field k - the neighbour i
    minimising T_k[i] + w(node <- i) - fixes the incoming ray; the
    gradient is the segment slowness (w/L) times the unit vector away
    from it.  Zero-length twin hops carry no direction, so the
    candidate set is the node's neighbours PLUS its twins' neighbours;
    an edge reached via a twin is priced with the TWIN as its tail (the
    twin carries the other layer's velocity state).  Needs the graph A:
    a solver built from `circulant=` alone has none."""
    if A is None:
        raise ValueError("locate needs the graph A for the Gauss-Newton "
                         "ray gradients; this solver was built from a "
                         "circulant stencil alone (A=None): pass A and "
                         "halo to AnnulusSolver, or refine=False")
    A = A.tocsr()
    twins = _twin_partners_of(halo, node)
    cand_via: dict = {}
    for j in (node, *twins):
        for i in A.indices[A.indptr[j]:A.indptr[j + 1]].tolist():
            cand_via.setdefault(i, j)    # node's own edges take priority
    for j in (node, *twins):
        cand_via.pop(j, None)
    cand = np.asarray(sorted(cand_via), dtype=np.int64)
    via = np.asarray([cand_via[i] for i in cand], dtype=np.int64)
    xs = np.stack([np.asarray(gr.x), np.asarray(gr.z)], axis=1)
    p = xs[node]
    L = np.linalg.norm(xs[cand] - p, axis=1)
    keep = L > 1e-6
    cand, via, L = cand[keep], via[keep], L[keep]
    if cand.size == 0:
        raise ValueError(f"node {node} has no finite-length neighbours")
    w = _edge_weight_in(gr, U, via, cand, L)
    cost = T[:, cand] + w[None, :]                   # (K, C)
    kbest = np.argmin(cost, axis=1)
    u = (p[None, :] - xs[cand[kbest]]) / L[kbest][:, None]
    slo = w[kbest] / L[kbest]                        # harmonic slowness
    return u * slo[:, None], float(np.median(L))


def _radial_profile(profile, r, U):
    """(radii, velocities) for the continuous bending functional: the
    explicit table when given, else the grid's own sampled velocities
    (dual columns averaged) - the convention of
    `AnnulusSolver.refined_travel_times`."""
    if profile is not None:
        return tuple(np.asarray(a, np.float64) for a in profile)
    order = np.argsort(np.asarray(r), kind="stable")
    rs = np.asarray(r)[order]
    vs = np.asarray(U, np.float64)[order]
    if vs.ndim == 2:
        vs = vs.mean(axis=1)
    return rs, vs


def _station_prev(solver, field: np.ndarray, station: int) -> np.ndarray:
    """Predecessor tree of one station field (rooted at the station),
    via `AnnulusSolver.recover_prev` - the machinery `solve` uses."""
    prev = solver.recover_prev(field)
    prev[station] = station
    return prev


def _accept_bent(t: np.ndarray, bent: np.ndarray, T: np.ndarray, node: int,
                 radius: float, rs, vs):
    """The bent times where they land at or below the graph time + 0.5 s
    (core-grazing diffracted paths do not: their resampled chords dip
    into the slow core), the others the graph time less the accepted
    ones' median bias; and the arrival directions at the node times the
    local slowness.  Returns (t, g, ok)."""
    t_spm = T[:, node]
    ok = t <= t_spm + 0.5
    if ok.any() and not ok.all():
        bias = float(np.median(t_spm[ok] - t[ok]))
        t = np.where(ok, t, t_spm - bias)
    elif not ok.any():
        t = t_spm
    # the bent path leaves the node toward the station, so grad T points
    # the other way
    u = bent[:, 0, :] - bent[:, 1, :]
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
    slo = 1.0 / np.maximum(np.interp(radius, rs, vs), 1e-12)
    return t, u * slo, ok


def _bent_times_and_dirs(solver, stations, T: np.ndarray, node: int,
                         profile, _prev_cache: Optional[dict] = None):
    """Bend the node->station graph paths to the continuous Fermat
    minimum (solvers/refine.py, one bend for the whole station set on the
    solver's device).  Returns the K bias-free model times, the K
    gradients at the node read from the bent polylines (their last
    segment, sharper than the graph edge), and which bends were kept."""
    from .path import recontruct_path
    from .refine import refine_paths_batch

    gr = solver.gr
    rs, vs = _radial_profile(profile, gr.r, solver.U)
    x, z = np.asarray(gr.x), np.asarray(gr.z)
    pts = []
    for k, s in enumerate(stations):
        # station prev trees are event-independent: cache across a
        # catalogue (locate_many passes one dict for all events)
        if _prev_cache is not None and k in _prev_cache:
            prev = _prev_cache[k]
        else:
            prev = _station_prev(solver, T[k], int(s))
            if _prev_cache is not None:
                _prev_cache[k] = prev
        p = recontruct_path(prev, int(s), node)   # node .. station order
        pts.append(np.stack([x[p], z[p]], axis=1))
    bent, t = refine_paths_batch(pts, rs, vs, device=solver.device)
    return _accept_bent(np.asarray(t, np.float64), bent, T, node,
                        float(np.hypot(x[node], z[node])), rs, vs)


def _weights(sigma, K: int) -> np.ndarray:
    return np.ones(K) if sigma is None else 1.0 / np.asarray(sigma,
                                                              np.float64)


def _check_bend(bend: bool, refine: bool) -> None:
    if bend and not refine:
        raise ValueError("bend=True requires refine=True (the bent model "
                         "times feed the Gauss-Newton step)")


def _clamp_to(pos: np.ndarray, r_max: float) -> np.ndarray:
    """Refined hypocentres stay inside the model's outer radius."""
    rr = float(np.hypot(pos[0], pos[1]) if pos.size == 2
               else np.linalg.norm(pos))
    return pos * (r_max / rr) if rr > r_max else pos


def _location2d(gr, j: int, t0: float, m: float, w2sum: float, refine_fn
                ) -> Location:
    node_rms = float(np.sqrt(max(float(m), 0.0) / w2sum))
    pos = np.array([float(np.asarray(gr.x)[j]), float(np.asarray(gr.z)[j])])
    delta = np.zeros(2)
    rms = node_rms
    if refine_fn is not None:
        delta, t0, rms = refine_fn(j)
        pos = _clamp_to(pos + delta, R)
    x, z = float(pos[0]), float(pos[1])
    return Location(node=j, x=x, z=z,
                    theta=float(np.arctan2(x, z) % (2 * np.pi)),
                    r=float(np.hypot(x, z)), t0=float(t0), rms=rms,
                    node_rms=node_rms, delta=np.asarray(delta))


def locate(solver, stations: Sequence[int], t_obs: Sequence[float],
           sigma: Optional[Sequence[float]] = None, refine: bool = True,
           fields: Optional[np.ndarray] = None, bend: bool = False,
           profile=None, _search=None,
           _prev_cache: Optional[dict] = None) -> Location:
    """Locate one event from arrival picks `t_obs` at `stations`
    (node ids).  sigma: per-pick uncertainties (s) for weighting.
    fields: precomputed `station_fields(solver, stations)` to amortise
    the K station solves across events.  _search: a precomputed
    (node, t0, misfit) of the grid search (`locate_many` passes its
    catalogue search's row).

    bend=True replaces the best node's graph model times with
    bending-refined ones (solvers/refine.py) before the Gauss-Newton
    step: the graph discretisation bias (+seconds on coarse grids, with
    station-dependent directional scatter) drops out of the residuals,
    at the cost of K predecessor recoveries + one bend.  profile:
    (radii, velocities) table for the continuous functional (default:
    the solver's sampled velocities)."""
    gr = solver.gr
    t_obs = np.asarray(t_obs, np.float64)
    K = len(stations)
    if t_obs.shape != (K,):
        raise ValueError(f"t_obs must have shape ({K},), got {t_obs.shape}")
    _check_bend(bend, refine)
    w = _weights(sigma, K)
    if fields is None:
        fields = station_fields(solver, stations)
    T = np.asarray(fields, np.float64)
    if _search is not None:
        j, t0, m = _search
    else:
        (j, t0, m), = _run_search(T, t_obs, w * w, solver.device,
                                           "direct")

    def gauss_newton(j):
        g, spacing = _ray_gradients(gr, solver.A, solver.halo, solver.U,
                                    T, j)
        t_model = T[:, j]
        if bend:
            t_bent, g_bent, ok = _bent_times_and_dirs(
                solver, stations, T, j, profile, _prev_cache=_prev_cache)
            t_model = t_bent
            g = np.where(ok[:, None], g_bent, g)
        return _gn_solve(g, t_model, t_obs, w, spacing)

    return _location2d(gr, int(j), float(t0), float(m),
                       float(np.sum(w * w)), gauss_newton if refine else None)


def locate_phases(solvers, stations, t_obs, sigma=None,
                  refine: bool = True, fields=None, bend: bool = False,
                  profiles=None,
                  _prev_caches: Optional[Sequence[dict]] = None
                  ) -> Location:
    """Joint multi-phase location: one entry per phase in each argument
    (e.g. `solvers=[solver_p, solver_s]` over the same grid with Vp/Vs
    tables, `stations=[ids_p, ids_s]`, `t_obs=[picks_p, picks_s]`).

    S picks break the depth/origin-time trade-off a one-sided P network
    leaves open (an S-P time fixes the source distance independently of
    t0).  Per-phase station fields stack into one (sum K_k, n) grid
    search, while the Gauss-Newton gradients and optional bending run
    per phase with that phase's velocities.

    sigma / fields / profiles / _prev_caches: per-phase lists matching
    `solvers` (each as in `locate`); any may be None.  The search runs on
    the first solver's device."""
    P_ = len(solvers)
    if not (len(stations) == len(t_obs) == P_):
        raise ValueError("solvers, stations, t_obs must have one entry "
                         f"per phase; got {P_}, {len(stations)}, "
                         f"{len(t_obs)}")
    gr = solvers[0].gr
    for s in solvers[1:]:
        if s.gr is not gr and int(s.gr.nnods) != int(gr.nnods):
            raise ValueError("all phase solvers must share one grid")
    sigma = sigma if sigma is not None else [None] * P_
    fields = fields if fields is not None else [None] * P_
    profiles = profiles if profiles is not None else [None] * P_
    caches = (_prev_caches if _prev_caches is not None
              else [None] * P_)
    _check_bend(bend, refine)

    T_k, w_k, obs_k = [], [], []
    for k in range(P_):
        t_k = np.asarray(t_obs[k], np.float64)
        K = len(stations[k])
        if t_k.shape != (K,):
            raise ValueError(f"phase {k}: t_obs shape {t_k.shape} != "
                             f"({K},)")
        w_k.append(_weights(sigma[k], K))
        T_k.append(np.asarray(
            fields[k] if fields[k] is not None
            else station_fields(solvers[k], stations[k]), np.float64))
        obs_k.append(t_k)
    T = np.concatenate(T_k, axis=0)
    w = np.concatenate(w_k)
    t_all = np.concatenate(obs_k)
    (j, t0, m), = _run_search(T, t_all, w * w, solvers[0].device, "direct")

    def gauss_newton(j):
        g_rows, t_rows, spacings = [], [], []
        for k in range(P_):
            sol = solvers[k]
            g_, sp_ = _ray_gradients(gr, sol.A, sol.halo, sol.U, T_k[k], j)
            t_m = T_k[k][:, j]
            if bend:
                t_b, g_b, ok = _bent_times_and_dirs(
                    sol, stations[k], T_k[k], j, profiles[k],
                    _prev_cache=caches[k])
                t_m = t_b
                g_ = np.where(ok[:, None], g_b, g_)
            g_rows.append(g_)
            t_rows.append(t_m)
            spacings.append(sp_)
        return _gn_solve(np.concatenate(g_rows, axis=0),
                         np.concatenate(t_rows), t_all, w,
                         float(np.min(spacings)))

    return _location2d(gr, int(j), float(t0), float(m),
                       float(np.sum(w * w)), gauss_newton if refine else None)


def _gn_solve(g: np.ndarray, t_model: np.ndarray, t_obs: np.ndarray,
              w: np.ndarray, max_step: float):
    """Weighted least squares for (delta, dt0) under the linear model
    t_obs ~= t_model + g . delta + t0; the step is clamped to max_step
    (the linearisation holds within a cell).  Returns
    (delta, t0, weighted rms)."""
    K, d = g.shape
    design = np.concatenate([g, np.ones((K, 1))], axis=1) * w[:, None]
    rhs = (t_obs - t_model) * w
    sol, *_ = np.linalg.lstsq(design, rhs, rcond=None)
    delta, t0 = sol[:d], float(sol[d])
    nrm = float(np.linalg.norm(delta))
    w2sum = float(np.sum(w * w))
    if nrm > max_step:
        delta = delta * (max_step / nrm)
        # the joint t0 was optimal for the FULL step; re-solve it for
        # the clamped one (weighted mean of the remaining residual)
        t0 = float(np.sum(w * w * (t_obs - t_model - g @ delta)) / w2sum)
    res = rhs - design @ np.concatenate([delta, [t0]])
    rms = float(np.sqrt(np.sum(res * res) / w2sum))
    return delta, t0, rms


def locate_many(solver, stations: Sequence[int], T_obs: np.ndarray,
                sigma: Optional[Sequence[float]] = None,
                refine: bool = True,
                fields: Optional[np.ndarray] = None, bend: bool = False,
                profile=None) -> list:
    """Locate a catalogue: T_obs is (n_events, K) picks.  The K station
    solves run once, the grid searches for all events run as ONE call
    of the expanded search (on the card one kernel launch for the whole
    catalogue, on the CPU the twin in 64-event blocks), then each event
    costs a 3-unknown host least squares (plus, with bend=True, one
    bend; the station prev trees are shared across events)."""
    if fields is None:
        fields = station_fields(solver, stations)
    T_obs = np.asarray(T_obs, np.float64)
    w = _weights(sigma, len(stations))
    searches = _run_search(fields, T_obs, w * w, solver.device, "expanded")
    prev_cache: dict = {}
    return [locate(solver, stations, row, sigma=sigma, refine=refine,
                   fields=fields, bend=bend, profile=profile,
                   _search=jtm, _prev_cache=prev_cache)
            for row, jtm in zip(T_obs, searches)]


def locate_dd(solver, stations: Sequence[int], T_obs: np.ndarray,
              sigma: Optional[Sequence[float]] = None,
              fields: Optional[np.ndarray] = None,
              pairs: Optional[Sequence] = None,
              anchor_weight: float = 0.2) -> list:
    """Double-difference relocation of a catalogue (HypoDD-style).

    For two nearby events the paths to a common station share almost all
    of their length, so station-systematic model errors (unmodelled
    heterogeneity, pick biases) cancel in the differenced residual
      (t_a,k - t_b,k) - (T_k(x_a) - T_k(x_b)).
    One joint weighted least squares over all events solves for every
    (delta_e, t0_e) from the dd rows of `pairs` (default: all pairs)
    plus absolute rows downweighted by `anchor_weight`: the anchors fix
    the translation/origin-time gauge that differences alone leave free,
    while systematic errors enter only at anchor_weight^2.

    Returns Locations whose RELATIVE geometry is what improves; absolute
    positions stay anchored to the plain grid search."""
    gr = solver.gr
    T_obs = np.asarray(T_obs, np.float64)
    E, K = T_obs.shape
    if K != len(stations):
        raise ValueError(f"T_obs must be (n_events, {len(stations)})")
    w = _weights(sigma, K)
    if fields is None:
        fields = station_fields(solver, stations)
    T = np.asarray(fields, np.float64)

    if pairs is None and E > 64:
        raise ValueError(
            f"{E} events give {E * (E - 1) // 2} dense dd pairs; pass an "
            "explicit `pairs` list (e.g. nearest neighbours) above 64 "
            "events")
    base = locate_many(solver, stations, T_obs, sigma=sigma, refine=False,
                       fields=fields)
    nodes = [loc.node for loc in base]
    grads, spacings = zip(*[_ray_gradients(gr, solver.A, solver.halo,
                                           solver.U, T, j)
                            for j in nodes])
    if pairs is None:
        pairs = [(a, b) for a in range(E) for b in range(a + 1, E)]

    # unknowns per event: (dx, dz, t0)
    nu = 3 * E
    rows, rhs = [], []
    for a, b in pairs:
        for k in range(K):
            row = np.zeros(nu)
            row[3 * a:3 * a + 2] = grads[a][k]
            row[3 * a + 2] = 1.0
            row[3 * b:3 * b + 2] = -grads[b][k]
            row[3 * b + 2] = -1.0
            rows.append(row * w[k])
            rhs.append(((T_obs[a, k] - T_obs[b, k])
                        - (T[k, nodes[a]] - T[k, nodes[b]])) * w[k])
    for e in range(E):
        for k in range(K):
            row = np.zeros(nu)
            row[3 * e:3 * e + 2] = grads[e][k]
            row[3 * e + 2] = 1.0
            rows.append(row * (anchor_weight * w[k]))
            rhs.append((T_obs[e, k] - T[k, nodes[e]])
                       * (anchor_weight * w[k]))
    design = np.stack(rows)
    rhs = np.asarray(rhs)
    sol, *_ = np.linalg.lstsq(design, rhs, rcond=None)

    out = []
    x_all, z_all = np.asarray(gr.x), np.asarray(gr.z)
    w2sum = float(np.sum(w * w))
    for e, loc in enumerate(base):
        delta, t0 = sol[3 * e:3 * e + 2].copy(), float(sol[3 * e + 2])
        nrm = float(np.linalg.norm(delta))
        if nrm > spacings[e]:
            delta = delta * (spacings[e] / nrm)
            t0 = float(np.sum(w * w * (T_obs[e] - T[:, nodes[e]]
                                       - grads[e] @ delta)) / w2sum)
        pos = _clamp_to(np.array([x_all[nodes[e]] + delta[0],
                                  z_all[nodes[e]] + delta[1]]), R)
        x, z = float(pos[0]), float(pos[1])
        # per-event rms of the ABSOLUTE residuals at this solution
        # (comparable to locate's; the dd rows are a joint objective)
        res = (T_obs[e] - T[:, nodes[e]] - grads[e] @ delta - t0) * w
        rms = float(np.sqrt(np.sum(res * res) / w2sum))
        out.append(Location(node=nodes[e], x=x, z=z,
                            theta=float(np.arctan2(x, z) % (2 * np.pi)),
                            r=float(np.hypot(x, z)), t0=t0, rms=rms,
                            node_rms=loc.node_rms,
                            delta=np.asarray(delta)))
    return out


# ----------------------------------------------------------------------
# the 3-D spherical-wedge grid
# ----------------------------------------------------------------------

@dataclass
class Location3D:
    """Result of `locate3d` on the spherical-wedge grid."""
    node: int
    x: float
    y: float
    z: float
    r: float
    t0: float
    rms: float
    node_rms: float
    delta: np.ndarray         # (3,) km


def station_fields3d(gr3, U: np.ndarray, stations: Sequence[int],
                     config=None, device="cuda", **solve_kwargs
                     ) -> np.ndarray:
    """(K, n) solve3d fields FROM each station - x->station times by
    reciprocity, exactly like the 2-D `station_fields`; `device` and
    `solve_kwargs` go to `solve3d`."""
    from ..config import DEFAULT_SOLVER_CONFIG
    from .solve3d import solve3d

    dist, _ = solve3d(gr3, U, [int(s) for s in stations],
                      config or DEFAULT_SOLVER_CONFIG, device=device,
                      **solve_kwargs)
    return np.asarray(dist, np.float64)


def _ray_gradients3d(gr3, U: np.ndarray, T: np.ndarray, node: int):
    """(K, 3) eikonal gradients at `node` from the 26-point stencil's
    fixpoint predecessors (the structured-grid analogue of
    `_ray_gradients`; solve3d's SHIFTS neighbourhood)."""
    from .solve3d import SHIFTS

    n0, n1, n2 = gr3.nnods
    i, j, k = node % n0, (node // n0) % n1, node // (n0 * n1)
    flat = []
    for dk, dj, di in SHIFTS:
        ii, jj, kk = i + di, j + dj, k + dk
        if 0 <= ii < n0 and 0 <= jj < n1 and 0 <= kk < n2:
            flat.append(ii + jj * n0 + kk * n0 * n1)
    cand = np.asarray(flat, dtype=np.int64)
    xs = np.stack([np.asarray(gr3.x), np.asarray(gr3.y),
                   np.asarray(gr3.z)], axis=1)
    p = xs[node]
    L = np.linalg.norm(xs[cand] - p, axis=1)
    U = np.asarray(U, np.float64)
    usum = U[node] + U[cand]
    w = np.where(usum > 0, 2.0 * L / np.where(usum > 0, usum, 1.0),
                 np.inf)
    cost = T[:, cand] + w[None, :]
    kbest = np.argmin(cost, axis=1)
    u = (p[None, :] - xs[cand[kbest]]) / L[kbest][:, None]
    slo = w[kbest] / L[kbest]
    return u * slo[:, None], float(np.median(L))


def _bent_times_and_dirs3d(gr3, U, stations, T: np.ndarray, node: int,
                           profile, config=None,
                           _prev_cache: Optional[dict] = None,
                           device="cuda"):
    """3-D analogue of `_bent_times_and_dirs`: predecessor trees from
    the fixpoint condition (`recover_prev3d`, one batched call whose
    prepare3d pack is shared across the K stations), node->station
    backtraces, one bend.  Same accept-or-bias-correct rule."""
    from ..config import DEFAULT_SOLVER_CONFIG
    from .path import recontruct_path
    from .refine import refine_paths_batch
    from .solve3d import recover_prev3d

    rs, vs = _radial_profile(profile, gr3.r, U)
    xs = np.stack([np.asarray(gr3.x), np.asarray(gr3.y),
                   np.asarray(gr3.z)], axis=1)
    if _prev_cache is not None and "prev" in _prev_cache:
        prevs = _prev_cache["prev"]
    else:
        prevs = recover_prev3d(gr3, U, T, [int(s) for s in stations],
                               config or DEFAULT_SOLVER_CONFIG,
                               device=device)
        if _prev_cache is not None:
            _prev_cache["prev"] = prevs
    pts = [xs[recontruct_path(prevs[k], int(s), node)]
           for k, s in enumerate(stations)]
    bent, t = refine_paths_batch(pts, rs, vs,
                                 r_max=float(np.asarray(gr3.r_ax).max()),
                                 device=device)
    return _accept_bent(np.asarray(t, np.float64), bent, T, node,
                        float(np.linalg.norm(xs[node])), rs, vs)


def _location3d(gr3, j: int, t0: float, m: float, w2sum: float, refine_fn
                ) -> Location3D:
    node_rms = float(np.sqrt(max(float(m), 0.0) / w2sum))
    pos = np.array([np.asarray(gr3.x)[j], np.asarray(gr3.y)[j],
                    np.asarray(gr3.z)[j]], np.float64)
    delta = np.zeros(3)
    rms = node_rms
    if refine_fn is not None:
        delta, t0, rms = refine_fn(j)
        pos = _clamp_to(pos + delta, float(np.asarray(gr3.r_ax).max()))
    return Location3D(node=j, x=float(pos[0]), y=float(pos[1]),
                      z=float(pos[2]), r=float(np.linalg.norm(pos)),
                      t0=float(t0), rms=rms, node_rms=node_rms,
                      delta=np.asarray(delta))


def locate3d(gr3, U: np.ndarray, stations: Sequence[int],
             t_obs: Sequence[float],
             sigma: Optional[Sequence[float]] = None, refine: bool = True,
             fields: Optional[np.ndarray] = None, bend: bool = False,
             profile=None, config=None, _search=None,
             _prev_cache: Optional[dict] = None, device="cuda",
             **solve_kwargs) -> Location3D:
    """Locate one event on the 3-D spherical-wedge grid: the same
    reciprocity grid search + eikonal Gauss-Newton as `locate`, with the
    26-point structured stencil supplying the ray directions.  fields:
    precomputed `station_fields3d(...)` to amortise across events.
    bend=True bends the node->station backtraces (recover_prev3d +
    solvers/refine.py) to strip the graph bias from the residuals, as in
    the 2-D `locate`; profile = (radii, velocities) for the continuous
    functional.  The solves, the search and the bend run on `device`."""
    t_obs = np.asarray(t_obs, np.float64)
    K = len(stations)
    if t_obs.shape != (K,):
        raise ValueError(f"t_obs must have shape ({K},), got {t_obs.shape}")
    _check_bend(bend, refine)
    w = _weights(sigma, K)
    if fields is None:
        fields = station_fields3d(gr3, U, stations, config, device=device,
                                  **solve_kwargs)
    T = np.asarray(fields, np.float64)
    if _search is not None:
        j, t0, m = _search
    else:
        (j, t0, m), = _run_search(T, t_obs, w * w, device,
                                           "direct")

    def gauss_newton(j):
        g, spacing = _ray_gradients3d(gr3, U, T, j)
        t_model = T[:, j]
        if bend:
            t_bent, g_bent, ok = _bent_times_and_dirs3d(
                gr3, U, stations, T, j, profile, config=config,
                _prev_cache=_prev_cache, device=device)
            t_model = t_bent
            g = np.where(ok[:, None], g_bent, g)
        return _gn_solve(g, t_model, t_obs, w, spacing)

    return _location3d(gr3, int(j), float(t0), float(m),
                       float(np.sum(w * w)), gauss_newton if refine else None)


def locate3d_phases(gr3, Us, stations, t_obs, sigma=None,
                    refine: bool = True, fields=None, bend: bool = False,
                    profiles=None, config=None,
                    _prev_caches: Optional[Sequence[dict]] = None,
                    device="cuda", **solve_kwargs) -> Location3D:
    """Joint multi-phase 3-D location (the `locate_phases` analogue):
    one entry per phase in Us (per-node velocity tables on the same
    grid), stations, t_obs, and optionally sigma / fields / profiles /
    _prev_caches.  Per-phase station fields stack into one grid search;
    the eikonal Gauss-Newton gradients (and bending) run per phase with
    that phase's velocities."""
    P_ = len(Us)
    if not (len(stations) == len(t_obs) == P_):
        raise ValueError("Us, stations, t_obs must have one entry per "
                         f"phase; got {P_}, {len(stations)}, "
                         f"{len(t_obs)}")
    sigma = sigma if sigma is not None else [None] * P_
    fields = fields if fields is not None else [None] * P_
    profiles = profiles if profiles is not None else [None] * P_
    caches = _prev_caches if _prev_caches is not None else [None] * P_
    _check_bend(bend, refine)

    T_k, w_k, obs_k = [], [], []
    for k in range(P_):
        t_k = np.asarray(t_obs[k], np.float64)
        K = len(stations[k])
        if t_k.shape != (K,):
            raise ValueError(f"phase {k}: t_obs shape {t_k.shape} != "
                             f"({K},)")
        w_k.append(_weights(sigma[k], K))
        T_k.append(np.asarray(
            fields[k] if fields[k] is not None
            else station_fields3d(gr3, Us[k], stations[k], config,
                                  device=device, **solve_kwargs),
            np.float64))
        obs_k.append(t_k)
    T = np.concatenate(T_k, axis=0)
    w = np.concatenate(w_k)
    t_all = np.concatenate(obs_k)
    (j, t0, m), = _run_search(T, t_all, w * w, device, "direct")

    def gauss_newton(j):
        g_rows, t_rows, spacings = [], [], []
        for k in range(P_):
            g_, sp_ = _ray_gradients3d(gr3, Us[k], T_k[k], j)
            t_m = T_k[k][:, j]
            if bend:
                t_b, g_b, ok = _bent_times_and_dirs3d(
                    gr3, Us[k], stations[k], T_k[k], j, profiles[k],
                    config=config, _prev_cache=caches[k], device=device)
                t_m = t_b
                g_ = np.where(ok[:, None], g_b, g_)
            g_rows.append(g_)
            t_rows.append(t_m)
            spacings.append(sp_)
        return _gn_solve(np.concatenate(g_rows, axis=0),
                         np.concatenate(t_rows), t_all, w,
                         float(np.min(spacings)))

    return _location3d(gr3, int(j), float(t0), float(m),
                       float(np.sum(w * w)), gauss_newton if refine else None)


def locate_many3d(gr3, U: np.ndarray, stations: Sequence[int],
                  T_obs: np.ndarray,
                  sigma: Optional[Sequence[float]] = None,
                  refine: bool = True,
                  fields: Optional[np.ndarray] = None, bend: bool = False,
                  profile=None, config=None, device="cuda",
                  **solve_kwargs) -> list:
    """3-D catalogue location: one expanded grid search for the whole
    catalogue (like `locate_many`), station fields and - with bend=True -
    the recovered predecessor trees computed once and shared across
    events."""
    if fields is None:
        fields = station_fields3d(gr3, U, stations, config, device=device,
                                  **solve_kwargs)
    T_obs = np.asarray(T_obs, np.float64)
    w = _weights(sigma, len(stations))
    searches = _run_search(fields, T_obs, w * w, device, "expanded")
    prev_cache: dict = {}
    return [locate3d(gr3, U, stations, row, sigma=sigma, refine=refine,
                     fields=fields, bend=bend, profile=profile,
                     config=config, _search=jtm, _prev_cache=prev_cache,
                     device=device)
            for row, jtm in zip(T_obs, searches)]
