"""Named seismic phases on top of the staged masked solver.

Counterpart of `raytracer_tpu/solvers/phases.py`.  The reference
scaffolds a phase library (src/multiphase/library.jl:9-31) on top of its
ms / multiphase sweeps but never delivers a working named-phase API;
the JAX package finishes the idea on the circulant fast path and this
module carries it over:

  P / S     direct first arrival (plain solve; wave picks Vp/Vs)
  PcP / ScS reflection at the core-mantle boundary: leg 1 solves the
            SSSP restricted to the mantle region (nodes above the CMB,
            boundary included), leg 2 keeps only the CMB boundary
            values and re-solves the same region - the up-leg takes the
            min over all reflection points automatically, which is the
            first-arrival reflected branch
  SKS / PKP the boundary-converted core class: down leg, transmitted
            core leg, up leg, each stage with its own velocity pack
  PP        single surface reflection, composed from two direct-P
            fields by reciprocity (the Fermat-minimax bounce)
  pP / sP   free-surface depth phases from a buried source

Region masks piggyback on the radial partition (models/partition.py):
a phase leg's region is "every layer above reflector k plus boundaries
1..k", which depends only on radius and so collapses to a per-slot lane
mask of the circulant layout.  The staged legs run on the 'stream'
engine (`ops/stream_t.solve_stream_staged`, kernel `csrc/band.cu`) or
the 'sweep' engine (`ops/sweep_theta.solve_sweep_staged`, kernel
`csrc/rsweep.cu` on destination-masked tables); the direct fields on
`AnnulusSolver`, which picks 'circulant' for `device="cpu"` (where the
JAX package picks it for `interpret=True`) and 'auto' on the card.
Entry points run on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..models.partition import partition_grid
from ..ops.circulant import build_circulant, resolve_device
from ..ops.wrapped_t import pack_twrapped_stencil
from .multiphase import (_fingerprint, _halo_slot_map, _lane_mask_of,
                         _solve_stages, _stage)

# reflector name -> boundary index in DISCONTINUITY_RADII (1-based)
REFLECTORS = {"cmb": 7, "660": 5, "410": 4, "moho": 2}


def _region_mask_above(partition, k: int) -> np.ndarray:
    """Nodes in layers 1..k and on boundaries 1..k (the region a ray may
    traverse before reflecting at boundary k)."""
    return ((partition.layer_of >= 1) & (partition.layer_of <= k)) | \
           ((partition.boundary_of >= 1) & (partition.boundary_of <= k))


def _region_mask_below(partition, k: int) -> np.ndarray:
    """Nodes strictly below boundary k: layers k+1.. plus boundaries
    k+1.. - the interior of a transmitted (core) leg.  The boundary-k
    nodes themselves are deliberately EXCLUDED from updating: they sit
    on the topside of the discontinuity and carry topside velocities,
    so letting them relax inside the core stage would fabricate fast
    creep paths riding the mantle side of the interface.  Their twins
    (offset below, carrying underside velocities) are in layer k+1 by
    radius, and the per-iteration unmasked halo min-merge moves values
    across the interface in both directions."""
    return (partition.layer_of > k) | (partition.boundary_of > k)


def _phase_setup(A, halo, gr, U, k: int, config, _reuse=None,
                 engine: str = "stream", device="cuda"):
    """(cg, ws, down stage, reflected up stage) of the region above
    boundary k, the stages' tables on `device`; kept in `_reuse` under
    a key with U's fingerprint, the device and the dtype (ROADMAP C.13)."""
    key = ("phase_setup", k, engine, _fingerprint(U), str(device),
           np.dtype(config.dtype).name)
    if _reuse is not None and key in _reuse:
        return _reuse[key]
    partition = partition_grid(gr)
    dtype = np.dtype(config.dtype)
    cg = build_circulant(gr, A, halo, U, dtype=dtype)
    ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
    down = _stage(engine, cg, ws, _region_mask_above(partition, k), dtype,
                  device, halo_map=_halo_slot_map(cg, ws, halo))
    keep = _lane_mask_of(cg, ws, partition.boundary_of == k)
    # the up leg: the same tables, only boundary k keeps its times
    up = down._replace(reset_keep=torch.as_tensor(keep, device=device),
                       cen_keep=False)
    out = (cg, ws, down, up)
    if _reuse is not None:
        _reuse[key] = out
    return out


def _check_engine(engine):
    if engine not in ("stream", "sweep"):
        raise ValueError(f"engine must be 'stream' or 'sweep', not "
                         f"{engine!r}")


def region_travel_times(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U: np.ndarray,
    reflector: str = "cmb",
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
    _reuse: Optional[dict] = None,
    engine: str = "stream",
) -> np.ndarray:
    """(n,) single-leg field: SSSP restricted to the region above the
    reflector (the 'down leg' primitive; reflected_travel_times composes
    two of these through the boundary restart).  Used by the tests to
    cross-check the staged solve by reciprocity:
    PcP(s, r) = min over boundary nodes b of leg_s[b] + leg_r[b].
    engine='sweep' runs the directional-sweep staged solver (~3-4
    rounds per stage); 'stream' the streamed Jacobi staged solver."""
    _check_engine(engine)
    device = resolve_device(device)
    k = REFLECTORS[reflector.lower()]
    cg, ws, down, _ = _phase_setup(A, halo, gr, U, k, config, _reuse,
                                   engine, device)
    return _solve_stages(engine, cg, ws, [down], source, config, device)[0]


def reflected_travel_times(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U: np.ndarray,
    reflector: str = "cmb",
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
    _reuse: Optional[dict] = None,
    engine: str = "stream",
) -> np.ndarray:
    """(n,) first-arrival times of the branch reflected at `reflector`
    (PcP with U = Vp, ScS with U = Vs).  Two region-masked stages; nodes
    outside the region return +inf.  Pass a dict as `_reuse` to keep
    the one-time circulant pack and the stage tables on the device
    across repeated solves.  engine='sweep' runs the directional-sweep
    staged solver (~3-4 rounds per stage)."""
    return reflected_travel_times_it(A, halo, source, gr, U, reflector,
                                     config, device, _reuse, engine)[0]


def reflected_travel_times_it(A, halo, source, gr, U, reflector="cmb",
                              config: SolverConfig = DEFAULT_SOLVER_CONFIG,
                              device="cuda", _reuse=None,
                              engine: str = "stream"):
    """`reflected_travel_times` and the staged solve's iteration (or
    round) count summed over its two stages."""
    _check_engine(engine)
    device = resolve_device(device)
    k = REFLECTORS[reflector.lower()]
    cg, ws, down, up = _phase_setup(A, halo, gr, U, k, config, _reuse,
                                    engine, device)
    return _solve_stages(engine, cg, ws, [down, up], source, config, device)


def _converted_setup(A, halo, gr, U_down, U_core, U_up, k, config, engine,
                     device, _reuse):
    """(cg, ws, [down, core, up] stages on `device`) of a converted
    solve, the per-leg packs and the stages kept in `_reuse` (keys with
    U's fingerprints and the dtype, ROADMAP C.13)."""
    dtype = np.dtype(config.dtype)
    same_up = U_up is None or U_up is U_down
    skey = ("conv_stages", k, engine, str(device), dtype.name,
            _fingerprint(U_down), _fingerprint(U_core),
            None if same_up else _fingerprint(U_up))
    if _reuse is not None and skey in _reuse:
        return _reuse[skey]
    partition = partition_grid(gr)

    def _pack(tag, U):
        key = ("conv_pack", tag, _fingerprint(U), dtype.name)
        if _reuse is not None and key in _reuse:
            return _reuse[key]
        cg = build_circulant(gr, A, halo, U, dtype=dtype)
        ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
        out = (cg, ws)
        if _reuse is not None:
            _reuse[key] = out
        return out

    cg1, ws1 = _pack("down", U_down)
    cgk, wsk = _pack("core", U_core)
    cg3, ws3 = (cg1, ws1) if same_up else _pack("up", U_up)
    if not (ws1.Mp == wsk.Mp == ws3.Mp and ws1.ML == wsk.ML == ws3.ML):
        raise AssertionError("per-leg circulant packs disagree in layout "
                             "(same graph must give same Mp/ML)")

    halo_map = _halo_slot_map(cg1, ws1, halo)
    region_up = _region_mask_above(partition, k)
    region_dn = _region_mask_below(partition, k)
    orig = partition.boundary_of == k
    # the underside twins of boundary k: `constrain2layers` removes all
    # direct edges between the topside originals and the region below,
    # so the core stage can only be seeded THROUGH the twins (which
    # hold the merged down-leg times at the end of stage 1).  The
    # boundary restart before the core stage keeps the twins too.
    twin = np.zeros_like(orig)
    ha, hb = halo[:, 0], halo[:, 1]
    twin[hb[orig[ha]]] = True
    twin[ha[orig[hb]]] = True
    keep = _lane_mask_of(cg1, ws1, orig)
    keep_dn = _lane_mask_of(cg1, ws1, orig | twin)

    def st(cg_, ws_, region, **kw):
        return _stage(engine, cg_, ws_, region, dtype, device,
                      halo_map=halo_map, **kw)

    out = (cg1, ws1, [
        st(cg1, ws1, region_up),
        st(cgk, wsk, region_dn, reset_keep=keep_dn, cen_keep=False),
        st(cg3, ws3, region_up, reset_keep=keep, cen_keep=False),
    ])
    if _reuse is not None:
        _reuse[skey] = out
    return out


def converted_travel_times(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U_down: np.ndarray,
    U_core: np.ndarray,
    U_up: Optional[np.ndarray] = None,
    reflector: str = "cmb",
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
    _reuse: Optional[dict] = None,
    engine: str = "stream",
) -> np.ndarray:
    """(n,) first arrivals of the boundary-converted core class: a
    three-stage solve with PER-STAGE velocity packs - down leg above
    `reflector` with U_down, transmitted leg below it with U_core, up
    leg with U_up (default U_down).  (Vs, Vp, Vs) is the SKS class,
    (Vp, Vp, Vp) the PKP class (the core region includes the inner
    core, so PKIKP rides the same solve), (Vs, Vp, Vp) SKP.

    The kinematic first arrival of the whole boundary-touching class of
    the leg waves: the boundary restart keeps the boundary values across
    stages and the core leg may be degenerate, so the field is
    min(reflection, topside interface diffraction, converted core
    transit).  Nodes outside the up-leg region (core interior) return
    +inf.  The core stage masks the topside boundary nodes from updating
    (`_region_mask_below`), and its restart keeps the underside twins as
    well as the originals; the up stage keeps only the originals.
    """
    return converted_travel_times_it(A, halo, source, gr, U_down, U_core,
                                     U_up, reflector, config, device,
                                     _reuse, engine)[0]


def converted_travel_times_it(A, halo, source, gr, U_down, U_core,
                              U_up=None, reflector="cmb",
                              config: SolverConfig = DEFAULT_SOLVER_CONFIG,
                              device="cuda", _reuse=None,
                              engine: str = "stream"):
    """`converted_travel_times` and the staged solve's iteration (or
    round) count summed over its three stages."""
    _check_engine(engine)
    device = resolve_device(device)
    k = REFLECTORS[reflector.lower()]
    cg1, ws1, stages = _converted_setup(A, halo, gr, U_down, U_core, U_up,
                                        k, config, engine, device, _reuse)
    return _solve_stages(engine, cg1, ws1, stages, source, config, device)


def pp_travel_times(
    t_src: np.ndarray,
    t_rcv: np.ndarray,
    gr,
    src: int,
    rcv: int,
) -> float:
    """PP time from two direct-P SURFACE fields by reciprocity.

    The classical PP bounce point is a STATIONARY point of
    f(b) = t_src[b] + t_rcv[b] that is a maximum along the bounce path
    (Fermat minimax) - minimising f would collapse toward the direct
    arrival as b approaches either endpoint.  So: evaluate f over
    surface bounce points on the minor arc strictly between source and
    receiver and take the maximum."""
    rr = np.asarray(gr.r)
    surf = np.flatnonzero(rr == rr.max())
    th = np.mod(np.asarray(gr.theta)[surf], 2 * np.pi)
    ts = float(np.mod(gr.theta[src], 2 * np.pi))
    tr = float(np.mod(gr.theta[rcv], 2 * np.pi))
    span = np.mod(tr - ts, 2 * np.pi)
    if span > np.pi:      # minor arc runs the other way
        ts, tr = tr, ts
        span = 2 * np.pi - span
    rel = np.mod(th - ts, 2 * np.pi)
    eps = 1e-9
    ok = (rel > eps) & (rel < span - eps)
    cand = t_src[surf[ok]] + t_rcv[surf[ok]]
    cand = cand[np.isfinite(cand)]
    return float(np.max(cand)) if len(cand) else float("inf")


def _direct_solver(gr, A, halo, U, config, device):
    """The plain-solve `AnnulusSolver` of the direct fields: 'circulant'
    on the CPU (the JAX package's choice under interpret=True), 'auto'
    on the card."""
    from .api import AnnulusSolver

    device = resolve_device(device)
    method = "circulant" if device.type == "cpu" else "auto"
    return AnnulusSolver(gr, A, halo, U, config, method=method,
                         device=device)


def depth_phase_travel_times(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U_up: np.ndarray,
    U_main: np.ndarray,
    receivers: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
) -> np.ndarray:
    """Free-surface depth phases (pP / sP / sS / pS) on the SPM graph.

    A depth phase is an up-going leg from the buried source (wave speed
    `U_up`: Vp for pP/pS, Vs for sP/sS) reflected at the free surface
    into a full main branch (`U_main`).  Composition by reciprocity over
    surface bounce points b: f(b) = t_up[source->b] +
    t_main[b->receiver], the second field solved FROM the receiver.  The
    bounce is an interior LOCAL MINIMUM of f along the surface ring: scan
    the cyclic ring, reject the receiver's own node (the collapsed direct
    arrival), and return the smallest interior cyclic local minimum.
    Returns one time per receiver; inf when no interior local minimum
    exists (e.g. a surface source).

    The margin floor of `depth_phase_pick` is the JAX package's as it
    stands, so both packages return the same times; for the mixed
    phases it rejects the genuine bounce (ROADMAP C.6: sP comes out far
    above the tau-p anchor).
    """
    solver_up = _direct_solver(gr, A, halo, U_up, config, device)
    t_src = np.asarray(solver_up.solve(source, want_prev=False).dist)
    same_U = U_main is U_up or np.shares_memory(U_main, U_up)
    solver_main = solver_up if same_U else _direct_solver(
        gr, A, halo, U_main, config, device)
    surf = surface_ring(gr)
    t_rcv = _fields_from(solver_main, receivers)
    return np.asarray([depth_phase_pick(t_src, t_rcv[int(r_)], surf, source,
                                        int(r_))
                       for r_ in np.asarray(receivers)], dtype=np.float64)


def _fields_from(solver, receivers) -> dict:
    """node -> the field solved from it, one solve a distinct receiver
    node (a receiver fan on a coarse grid maps several degrees to one
    node)."""
    return {int(r_): np.asarray(solver.solve(int(r_), want_prev=False).dist)
            for r_ in np.unique(np.asarray(receivers))}


def surface_ring(gr) -> np.ndarray:
    """The surface nodes in increasing theta (mod 2 pi)."""
    rr = np.asarray(gr.r)
    surf = np.flatnonzero(rr == rr.max())
    order = np.argsort(np.mod(np.asarray(gr.theta)[surf], 2 * np.pi))
    return surf[order]


def depth_phase_pick(t_src, t_rcv, surf, source: int, rcv: int) -> float:
    """The depth-phase time of one receiver from the up-leg field t_src
    (from the source) and the main field t_rcv (from the receiver): the
    smallest interior cyclic local minimum of f = t_src + t_rcv along
    the surface ring `surf`, inf when there is none."""
    f = t_src[surf] + t_rcv[surf]
    fl = np.roll(f, 1)
    fr = np.roll(f, -1)
    is_min = (np.isfinite(f) & (f <= fl) & (f <= fr)
              & ((f < fl) | (f < fr)))
    # degenerate collapses: the receiver's own node and a surface
    # source's own node; spurious f32-noise minima a hair above the
    # direct arrival are rejected by a margin floor
    is_min[surf == rcv] = False
    is_min[surf == source] = False
    f_direct = max(float(t_src[rcv]), float(t_rcv[source]))
    is_min &= f > f_direct + max(0.05, 1e-4 * f_direct)
    return float(np.min(f[is_min])) if is_min.any() else np.inf


def phase_travel_times(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U: np.ndarray,
    phase: str = "P",
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    receivers: Optional[Sequence[int]] = None,
    device="cuda",
    Us: Optional[np.ndarray] = None,
    _reuse: Optional[dict] = None,
    engine: str = "stream",
) -> np.ndarray:
    """First-arrival times of a named phase at `receivers` (or all
    nodes).  U must carry the matching wave speed (Vp for P phases, Vs
    for S phases).  For the converted core phases U is the P-speed
    table and `Us` (required when the phase has an S leg) the S-speed
    table.  Pass one dict as `_reuse` across calls to keep the circulant
    packs and stage tables (keys carry a U fingerprint, so mixed Vp/Vs
    phase batches are safe).

    'P'/'S'     -> plain solve (AnnulusSolver)
    'Pdiff'/'Sdiff' -> the same field: beyond the direct-P shadow the
                   surface first arrival IS the diffracted branch
    'PcP'/'ScS' -> reflected_travel_times at the CMB
    'SKS'/'PKP'/'PKIKP'/'SKP'/'PKS' -> converted_travel_times
    'PP'/'SS'   -> reciprocity composition of two direct fields;
                   requires `receivers` (one time per receiver)
    'pP'/'sP'/'sS'/'pS' (case-sensitive: lowercase = the up leg from a
                   BURIED source) -> free-surface depth phases via
                   depth_phase_travel_times; requires `receivers`, and
                   `Us` when either leg is S
    """
    if phase in ("pP", "sP", "sS", "pS"):
        if receivers is None:
            raise ValueError(f"{phase} needs explicit receivers")
        if "s" in phase.lower() and Us is None:
            raise ValueError(f"{phase} has an S leg: pass Us (the "
                             "S-speed node table) alongside U (P-speed)")
        U_of = {"p": U, "s": Us}
        return depth_phase_travel_times(
            A, halo, source, gr, U_of[phase[0]], U_of[phase[1].lower()],
            receivers, config=config, device=device)
    p = phase.upper()
    if p in ("P", "S", "PDIFF", "SDIFF"):
        solver = _direct_solver(gr, A, halo, U, config, device)
        dist = solver.solve(source, want_prev=False).dist
        return dist if receivers is None else dist[np.asarray(receivers)]
    if p in ("PCP", "SCS"):
        dist = reflected_travel_times(A, halo, source, gr, U,
                                      reflector="cmb", config=config,
                                      device=device, _reuse=_reuse,
                                      engine=engine)
        return dist if receivers is None else dist[np.asarray(receivers)]
    if p in ("SKS", "PKP", "PKIKP", "SKP", "PKS"):
        legs = {"SKS": ("s", "s"), "PKP": ("p", "p"),
                "PKIKP": ("p", "p"), "SKP": ("s", "p"),
                "PKS": ("p", "s")}[p]
        if "s" in legs and Us is None:
            raise ValueError(f"{phase} has an S leg: pass Us (the "
                             "S-speed node table) alongside U (P-speed)")
        U_of = {"p": U, "s": Us}
        dist = converted_travel_times(A, halo, source, gr,
                                      U_down=U_of[legs[0]], U_core=U,
                                      U_up=U_of[legs[1]],
                                      reflector="cmb", config=config,
                                      device=device, _reuse=_reuse,
                                      engine=engine)
        return dist if receivers is None else dist[np.asarray(receivers)]
    if p in ("PP", "SS"):
        if receivers is None:
            raise ValueError(f"{p} needs explicit receivers")
        solver = _direct_solver(gr, A, halo, U, config, device)
        t_src = solver.solve(source, want_prev=False).dist
        t_rcv = _fields_from(solver, receivers)
        return np.asarray([pp_travel_times(t_src, t_rcv[int(r_)], gr, source,
                                           int(r_))
                           for r_ in np.asarray(receivers)])
    raise ValueError(f"unknown phase {phase!r}; supported: P, S, Pdiff, "
                     f"Sdiff, PcP, ScS, PP, SS, SKS, PKP, PKIKP, SKP, "
                     f"PKS, pP, sP, sS, pS")
