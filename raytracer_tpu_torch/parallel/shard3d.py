"""Slab-sharded (domain-decomposed) 3-D directional-sweep solve.

Counterpart of `raytracer_tpu/parallel/shard3d.py`, the 3-D form of
parallel/theta_shard.py: one grid axis of the structured (r, phi, theta)
box is split into contiguous slabs, one a rank, and each round exchanges
a +-1-plane halo with the slab neighbours.  Each round, on every rank:

  1. the boundary plane goes each way (`ring_exchange`; the stencil's
     reach is +-1 per axis).  The ring's wrap pair is harmless: the
     shifted weights are +inf across the global box faces, so a wrapped
     halo plane meets only +inf weights;
  2. a full triaxial sweep round (down and up plane passes along each
     axis, `ops.plane3d.plane_sweep3d`: the kernel `csrc/plane3d.cu` on
     the card).  The passes ALONG the sharded axis seed their carry with
     the neighbour's halo plane (`carry_init`) and are the only ops that
     apply the edges between slabs.  The passes along the OTHER axes run
     on an edge-masked weight copy: every shift with a component along
     the sharded axis is +inf on the slab's first and last plane, so no
     tap or scan of theirs reaches across the slab boundary;
  3. the vote: the changed flags summed over the ranks, read on the host
     once a round by every rank.

At a round that changes nothing the halo planes equal the neighbours'
settled boundary planes, so every edge is satisfied: the fixpoint of
the single-device engines; the arithmetic is the JAX package's op for
op.  The staged solves (reflection, converted) hand their stages over
on radial planes, which are whole on every rank for shard_axis 1 or 2,
so they need no collective beyond the round's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..models.grid3d import Grid3D
from ..solvers.solve3d import (SHIFTS, Solve3DState, _scan_costs_of,
                               _shifted_weights, _sweep_layout3d,
                               mask_region3d)
from ..ops.plane3d import plane_sweep3d
from .mesh import (SHARD3D_AXIS, Mesh, all_gather, any_of,
                   make_shard3d_mesh, ring_exchange)


def _take_plane(v, pos: int, axis: int):
    """Boundary plane of the (S,)+shape field along data axis `axis`."""
    idx = [slice(None)] * v.dim()
    idx[axis] = pos
    return v[tuple(idx)]


def _edge_masked(W, shard_axis: int):
    """Local weight copy with every shift crossing the slab boundary
    along shard_axis masked +inf on the first/last local plane."""
    Wm = W.clone()
    for s, sh in enumerate(SHIFTS):
        d = sh[shard_axis]
        if d == 0:
            continue
        idx = [s] + [slice(None)] * 3
        idx[1 + shard_axis] = -1 if d == 1 else 0
        Wm[tuple(idx)] = float("inf")
    return Wm


def _slab(mesh: Mesh, shp, shard_axis: int) -> slice:
    n = shp[shard_axis] // mesh.size
    return slice(mesh.index * n, (mesh.index + 1) * n)


def _local_weights(W_np: np.ndarray, mesh: Mesh, shard_axis: int):
    """This rank's slab of the (n_shifts, n2, n1, n0) host weights, on
    its device."""
    idx = [slice(None)] * 4
    idx[1 + shard_axis] = _slab(mesh, W_np.shape[1:], shard_axis)
    return torch.from_numpy(np.ascontiguousarray(W_np[tuple(idx)])).to(
        mesh.device)


def _source_field(src_kji: np.ndarray, shp_loc, lo: int, shard_axis: int,
                  dtype, dev):
    """Local (S,)+shp_loc source field from global (k, j, i) coords."""
    S = len(src_kji)
    v = torch.full((S,) + tuple(shp_loc), float("inf"), dtype=dtype,
                   device=dev)
    for b, kji in enumerate(src_kji):
        loc = [int(c) for c in kji]
        loc[shard_axis] -= lo
        if 0 <= loc[shard_axis] < shp_loc[shard_axis]:
            v[(b,) + tuple(loc)] = 0.0
    return v


def _stage_fix(v0, W, tol, max_rounds: int, shard_axis: int,
               mesh: Mesh) -> Solve3DState:
    """One halo-exchanged block-Gauss-Seidel fixpoint on the local slab
    from an explicit initial field (the plain and staged sharded solves
    share it)."""
    Wm = _edge_masked(W, shard_axis)
    scan = _scan_costs_of(Wm)
    layouts = {a: _sweep_layout3d(W if a == shard_axis else Wm, scan, a)
               for a in (0, 1, 2)}
    d_ax = 1 + shard_axis
    v, changed, it = v0, True, 0
    while changed and it < max_rounds:
        # +-1-plane ring halo (global faces self-mask through +inf W)
        h_up, h_dn = ring_exchange(_take_plane(v, -1, d_ax),
                                   _take_plane(v, 0, d_ax), mesh,
                                   SHARD3D_AXIS)
        d = v
        for a in (0, 1, 2):
            if a == shard_axis:
                d = plane_sweep3d(d, layouts[a], a, True, carry_init=h_dn)
                d = plane_sweep3d(d, layouts[a], a, False, carry_init=h_up)
            else:
                d = plane_sweep3d(d, layouts[a], a, True)
                d = plane_sweep3d(d, layouts[a], a, False)
        changed = any_of((d < v - tol).any(), mesh, SHARD3D_AXIS)
        v, it = d, it + 1
    return Solve3DState(v, changed, it)


def _prep(gr: Grid3D, sources, config: SolverConfig, mesh, shard_axis: int,
          device, max_rounds):
    """(mesh, global shape, (S, 3) source coords, tol, round cap) after
    the checks."""
    mesh = mesh if mesh is not None else make_shard3d_mesh(device=device)
    mesh.require_member()
    n0, n1, n2 = gr.nnods
    shp = (n2, n1, n0)
    if shp[shard_axis] % mesh.size:
        raise ValueError(
            f"grid axis {shard_axis} extent {shp[shard_axis]} not "
            f"divisible by mesh size {mesh.size}")
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    kji = np.stack([sources // (n1 * n0), (sources // n0) % n1,
                    sources % n0], axis=1)
    tol = torch.tensor(config.tol_value(),
                       dtype=getattr(torch, np.dtype(config.dtype).name),
                       device=mesh.device)
    cap = max_rounds if max_rounds is not None else config.max_iters
    return mesh, shp, kji, tol, cap


def _staged(Ws, plan, widx, kji, tol, mesh: Mesh, receivers, cap: int,
            shard_axis: int) -> Tuple[np.ndarray, int]:
    """The stages in one go: stage 0 from the sources (global (k, j, i)
    coordinates `kji`), stage i >= 1 from +inf but radial plane dst_k,
    seeded from the previous stage's plane src_k (min-merged with stage
    merge_idx's plane merge_k when that is not None); Ws[widx[i]] the
    stage's host weights, `cap` the rounds a stage may take.  Returns
    the last stage's gathered (S, n_out) values and the rounds of all
    stages."""
    sl = _slab(mesh, tuple(Ws[0].shape[1:]), shard_axis)
    W_loc = [_local_weights(W, mesh, shard_axis) for W in Ws]
    v0 = _source_field(kji, tuple(W_loc[0].shape[1:]), sl.start, shard_axis,
                       W_loc[0].dtype, mesh.device)
    st = _stage_fix(v0, W_loc[widx[0]], tol, cap, shard_axis, mesh)
    fields, total = [st.dist], st.it
    for i, (src_k, dst_k, merge_idx, merge_k) in enumerate(plan):
        seed = fields[-1][:, src_k]
        if merge_idx is not None:
            seed = torch.minimum(seed, fields[merge_idx][:, merge_k])
        d0 = torch.full_like(fields[-1], float("inf"))
        d0[:, dst_k] = seed
        st = _stage_fix(d0, W_loc[widx[i + 1]], tol, cap, shard_axis, mesh)
        fields.append(st.dist)
        total += st.it
    return _gathered(fields[-1], mesh, shard_axis, receivers), total


def _gathered(v, mesh: Mesh, shard_axis: int, receivers) -> np.ndarray:
    """The (S, n) (or (S, n_receivers)) host values of the slabs."""
    d_ax = 1 + shard_axis
    full = all_gather(v.movedim(d_ax, 0), mesh, SHARD3D_AXIS).movedim(0, d_ax)
    vals = full.reshape(full.shape[0], -1)
    if receivers is not None:
        vals = vals[:, torch.as_tensor(np.asarray(receivers, dtype=np.int64)
                                       .ravel(), device=vals.device)]
    return vals.cpu().numpy()


def solve3d_sharded(
    gr: Grid3D,
    U: np.ndarray,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    receivers=None,
    max_rounds: int = None,
    shard_axis: int = 1,
    device=None,
) -> Tuple[np.ndarray, int]:
    """Domain-decomposed 3-D sweep solve over a slab mesh; every rank of
    the mesh calls it and gets the whole result.

    Returns (values, rounds): values is (S, n_out) flat-node-ordered
    travel times (all nodes, or the `receivers` subset).  shard_axis is
    the grid axis to decompose, 0 = r, 1 = phi (default), 2 = theta; its
    extent must divide by the mesh size.  Every rank solves all the
    sources on its slab.  Same fixpoint as `solve3d` (all engines);
    `prev` is not assembled here (solvers/solve3d.recover_prev3d on the
    returned field gives it).  `device` is the default mesh's.
    """
    mesh, _, kji, tol, cap = _prep(gr, sources, config, mesh, shard_axis,
                                   device, max_rounds)
    W = _shifted_weights(gr, U, np.dtype(config.dtype))
    return _staged((W,), (), (0,), kji, tol, mesh, receivers, cap,
                   shard_axis)


def _check_staged_axis(shard_axis: int) -> None:
    if shard_axis not in (1, 2):
        raise ValueError(
            "staged sharded solves need the seed (radial) planes "
            "unsharded; use shard_axis 1 (phi) or 2 (theta), not 0")


def solve3d_reflection_sharded(
    gr: Grid3D,
    U: np.ndarray,
    sources,
    r_reflect: float,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    receivers=None,
    max_rounds: int = None,
    shard_axis: int = 1,
    device=None,
) -> Tuple[np.ndarray, int]:
    """Slab-sharded two-stage topside reflection (3-D PcP class), the
    domain-decomposed form of solvers/solve3d.solve3d_reflection: stage
    A solves the region above `r_reflect`, stage B restarts from the
    reflector plane's stage-A times.  Star-1 stencil only (the +-1-plane
    halo is its reach)."""
    _check_staged_axis(shard_axis)
    mesh, shp, kji, tol, cap = _prep(gr, sources, config, mesh, shard_axis,
                                     device, max_rounds)
    r_ax = np.asarray(gr.r_ax)
    k_lev = int(np.argmin(np.abs(r_ax - r_reflect)))
    if abs(r_ax[k_lev] - r_reflect) > 1e-6:
        raise ValueError("r_reflect must be a grid radial level "
                         "(build with grid3d(force_radii=[r_reflect]))")
    keep = (gr.r >= r_reflect - 1e-6).reshape(shp)
    Wm = mask_region3d(_shifted_weights(gr, U, np.dtype(config.dtype)), keep)
    return _staged((Wm,), ((k_lev, k_lev, None, 0),), (0, 0), kji, tol, mesh,
                   receivers, cap, shard_axis)


def solve3d_converted_sharded(
    gr: Grid3D,
    U_down: np.ndarray,
    U_core: np.ndarray,
    sources,
    r_boundary: float,
    U_up: Optional[np.ndarray] = None,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    receivers=None,
    max_rounds: int = None,
    shard_axis: int = 1,
    device=None,
) -> Tuple[np.ndarray, int]:
    """Slab-sharded three-stage boundary-converted transit (3-D SKS/PKP
    class), the domain-decomposed form of
    solvers/solve3d.solve3d_converted (same twin-doubled-grid
    requirement): topside plane -> underside twin -> topside, radial
    plane copies local to each slab.  Star-1 stencil only."""
    _check_staged_axis(shard_axis)
    mesh, shp, kji, tol, cap = _prep(gr, sources, config, mesh, shard_axis,
                                     device, max_rounds)
    r_ax = np.asarray(gr.r_ax)
    k_top = int(np.argmin(np.abs(r_ax - r_boundary)))
    if (abs(r_ax[k_top] - r_boundary) > 1e-6 or k_top == 0
            or abs(r_ax[k_top - 1]
                   - (r_boundary - gr.twin_offset)) > 1e-6):
        raise ValueError(
            "r_boundary must be a twin-doubled forced radius of the "
            "grid (build with grid3d(force_radii=[r_boundary, ...]))")
    k_under = k_top - 1
    same_up = U_up is None or U_up is U_down
    dtype = np.dtype(config.dtype)
    keep_top = (gr.r >= r_boundary - 1e-6).reshape(shp)
    keep_core = (gr.r <= r_boundary - 1e-6).reshape(shp)
    W_dn = mask_region3d(_shifted_weights(gr, U_down, dtype), keep_top)
    W_k = mask_region3d(_shifted_weights(gr, U_core, dtype), keep_core)
    Ws = (W_dn, W_k) if same_up else (W_dn, W_k, mask_region3d(
        _shifted_weights(gr, U_up, dtype), keep_top))
    widx = (0, 1, 0) if same_up else (0, 1, 2)
    plan = ((k_top, k_under, None, 0), (k_under, k_top, 0, k_top))
    return _staged(Ws, plan, widx, kji, tol, mesh, receivers, cap,
                   shard_axis)
