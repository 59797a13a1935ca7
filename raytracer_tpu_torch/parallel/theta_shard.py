"""Theta-sharded (domain-decomposed) directional-sweep solve.

Counterpart of `raytracer_tpu/parallel/theta_shard.py`.  The annulus'
theta axis is split into contiguous column blocks, one a rank of the
mesh's theta axis, and the field is solved by block Gauss-Seidel over
the ranks.  Each round, on every rank:

  1. centre-fan settle: the centre's value is the minimum over the theta
     ranks (`all_min`; the core point is one node shared by every block);
  2. ring halo: the two boundary columns go each way to the ranks
     (r +- 1) mod D (`ring_exchange`), which also realises the annulus'
     periodic wrap;
  3. forward column sweep of the block (`tsweep`, the kernel
     `csrc/tsweep.cu` on the card) seeded with the LEFT neighbour's two
     halo columns as its carry, then a backward sweep seeded with the
     RIGHT ones: inside a block, the xla engine's sequential
     Gauss-Seidel (`ops.sweep_theta._sweep(carry_init=...)`);
  4. the vote: the changed flags summed over the theta ranks, read on
     the host once a round by every rank.

At the end the field is gathered along theta and every rank extracts the
receiver rows.  Every candidate is a real path cost and a round that
changes nothing anywhere satisfies every stencil edge, so the fixpoint
is the single-device engines'; the arithmetic is the JAX package's op
for op, so the fields and the round counts are its own on the same D.
Per round a boundary moves 4 * S * ML values (two columns each way).

In the 2-D (source, theta) mesh each source row runs that loop on its
slice of the sources with its own theta group; rows never communicate
until the final gather (their loops run independent round counts).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.circulant import CirculantGraph
from ..ops.diag_wrapped import _extract_cached
from ..ops.stream_t import _twin_merge
from ..ops.sweep_theta import (SweepState, _source_field, pack_sweep_tables,
                               sweep_stage_to_device, tables_to_device,
                               tsweep)
from ..ops.wrapped_t import _textract, pack_twrapped_stencil
from .mesh import (SRC_AXIS, THETA_AXIS, Mesh, _world, all_gather, all_min,
                   any_of, make_grid_mesh, make_theta_mesh, ring_exchange)


def _fan_settle(v, cen, tbl, mesh: Mesh):
    cen_loc = (v + tbl.fan_in).amin(dim=(1, 2))
    cen = torch.minimum(cen, all_min(cen_loc, mesh, THETA_AXIS))
    return torch.minimum(v, cen[:, None, None] + tbl.fan_w), cen


def _round(v, cen, tbl, static_loc, mesh: Mesh):
    """Fan, ring halo, forward and backward block sweeps."""
    v, cen = _fan_settle(v, cen, tbl, mesh)
    left, right = ring_exchange(v[:, -2:], v[:, :2], mesh, THETA_AXIS)
    v = tsweep(v, tbl, static_loc, False, carry_init=(left[:, 1], left[:, 0]))
    v = tsweep(v, tbl, static_loc, True,
               carry_init=(right[:, 0], right[:, 1]))
    return v, cen


def _rounds(v, cen, it: int, tbl, static_loc, tol, max_rounds: int,
            mesh: Mesh, halo_map=None) -> SweepState:
    """Rounds until no rank's block improves by more than `tol`, or `it`
    reaches max_rounds; `halo_map` adds a staged solve's twin merge."""
    changed = True
    while changed and it < max_rounds:
        v0, cen0 = v, cen
        v, cen = _round(v, cen, tbl, static_loc, mesh)
        if halo_map is not None:
            # unmasked twin min-merge, gated against the round-start
            # field: lane-space, local to each column block
            v = _twin_merge(v, v0, halo_map)
        changed_loc = (v < v0 - tol).any() | (cen < cen0 - tol).any()
        changed = any_of(changed_loc, mesh, THETA_AXIS)
        it += 1
    return SweepState(v, cen, changed, it)


def _layout(cg: CirculantGraph, config: SolverConfig, mesh: Mesh, _packed):
    """(closure-free stencil, SweepStatic, the tables on the mesh's
    device)."""
    dtype = np.dtype(config.dtype)
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=dtype, band_closure=0)
    tbl, static = pack_sweep_tables(ws, cg, dtype)
    return ws, static, tables_to_device(tbl, mesh.device)


def _check_divisible(nt: int, D: int, what: str) -> None:
    if nt % D:
        raise ValueError(f"ntheta={nt} not divisible by {what} {D}")


def _descriptors(cg: CirculantGraph, sources):
    """(slot, column, is-centre) of each source."""
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    is_cen = sources == cmap.center
    return (np.where(is_cen, 0, cmap.m_of[sources]),
            np.where(is_cen, 0, cmap.c_of[sources]), is_cen)


def _solve_block(src_m, src_c, src_cen, tbl, static, tol, max_rounds: int,
                 mesh: Mesh) -> SweepState:
    """This rank's block solve; the field is gathered along theta."""
    D = mesh.shape[THETA_AXIS]
    ntl = static.nt // D
    static_loc = static._replace(nt=ntl)
    v, cen = _source_field(src_m, src_c, src_cen, ntl, static.ML,
                           tbl.cfp.dtype, mesh.device,
                           col0=mesh.coord(THETA_AXIS) * ntl)
    st = _rounds(v, cen, 0, tbl, static_loc, tol, max_rounds, mesh)
    v, cen = _fan_settle(st.dist, st.cen, tbl, mesh)
    return SweepState(_gather_theta(v, mesh), cen, st.changed, st.it)


def _gather_theta(v, mesh: Mesh):
    """The (S, nt, ML) field from the ranks' (S, ntl, ML) blocks."""
    return all_gather(v.transpose(0, 1), mesh, THETA_AXIS).transpose(0, 1)


def solve_sweep_theta_sharded(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    receivers=None,
    max_rounds: int = None,
    device=None,
    _packed=None,
) -> Tuple[np.ndarray, int]:
    """Domain-decomposed sweep solve over a theta mesh; every rank of the
    mesh calls it and gets the whole result.

    Returns (values, rounds): values is (S, n_out) node-ordered travel
    times (all nodes, or the `receivers` subset).  ntheta must divide by
    the mesh size; every rank solves all the sources on its block --
    shard big SOURCE batches with parallel/multisource.py, big GRIDS
    with this.  `device` is the default mesh's (None: the card).
    """
    mesh = mesh if mesh is not None else make_theta_mesh(device=device)
    mesh.require_member()
    ws, static, tbl = _layout(cg, config, mesh, _packed)
    _check_divisible(static.nt, mesh.size, "mesh size")
    src_m, src_c, is_cen = _descriptors(cg, sources)
    tol = torch.tensor(config.tol_value(), dtype=tbl.cfp.dtype,
                       device=mesh.device)
    cap = max_rounds if max_rounds is not None else config.max_iters
    st = _solve_block(src_m, src_c, is_cen, tbl, static, tol, cap, mesh)
    _, ext = _extract_cached(ws.dcache, cg.cmap, receivers, mesh.device)
    rows = _textract(st.dist, st.cen, st.it, *ext).cpu().numpy()
    return rows[:, :-1], st.it


def solve_sweep_mesh_sharded(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    receivers=None,
    max_rounds: int = None,
    device=None,
    _packed=None,
) -> Tuple[np.ndarray, int]:
    """Sweep solve over a 2-D (source, theta) mesh: the source batch is
    split across the mesh ROWS (no collective between rows, as in
    parallel/multisource.py) while each row domain-decomposes the grid's
    theta axis as `solve_sweep_theta_sharded` does.

    Returns (values, rounds): values is (S, n_out) in the caller's source
    order; rounds is the most over the source rows.  S is padded up to a
    multiple of the row count (pad rows re-solve sources[0] and are
    dropped).  ntheta must divide by the theta-axis size.
    """
    mesh = mesh if mesh is not None else make_grid_mesh(1, device=device)
    if SRC_AXIS not in mesh.shape or THETA_AXIS not in mesh.shape:
        raise ValueError(f"mesh must have axes ({SRC_AXIS!r}, "
                         f"{THETA_AXIS!r}); got {tuple(mesh.shape)}")
    mesh.require_member()
    ws, static, tbl = _layout(cg, config, mesh, _packed)
    _check_divisible(static.nt, mesh.shape[THETA_AXIS], "theta-axis size")
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    S0 = len(sources)
    d_src = mesh.shape[SRC_AXIS]
    pad = (-S0) % d_src
    if pad:
        sources = np.concatenate([sources, np.full(pad, sources[0])])
    n = len(sources) // d_src
    row = mesh.coord(SRC_AXIS)
    src_m, src_c, is_cen = _descriptors(cg, sources[row * n:(row + 1) * n])
    tol = torch.tensor(config.tol_value(), dtype=tbl.cfp.dtype,
                       device=mesh.device)
    cap = max_rounds if max_rounds is not None else config.max_iters
    st = _solve_block(src_m, src_c, is_cen, tbl, static, tol, cap, mesh)
    _, ext = _extract_cached(ws.dcache, cg.cmap, receivers, mesh.device)
    rows = _textract(st.dist, st.cen, st.it, *ext)
    rows = all_gather(rows, mesh, SRC_AXIS).cpu().numpy()
    rounds = int(rows[:, -1].max())
    return rows[:S0, :-1], rounds


def solve_sweep_staged_theta_sharded(
    cg: CirculantGraph,
    ws,
    stages,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    receivers=None,
    max_rounds: int = None,
    device=None,
) -> Tuple[np.ndarray, int]:
    """Staged (region-masked / multi-leg) sweep solve over a theta mesh:
    the sharded counterpart of ops.sweep_theta.solve_sweep_staged's
    stages (solvers/phases.py's PcP/ScS/converted solves), on the xla
    engine's block sweeps.  The stage resets and the twin min-merge act
    within each theta column, so they need no collective beyond the
    plain sharded solve's.  `ws` is the closure-free stencil whose
    dcache holds the extraction arrays; `it` carries across the stages
    and max_rounds caps the total."""
    mesh = mesh if mesh is not None else make_theta_mesh(device=device)
    mesh.require_member()
    dtype = np.dtype(config.dtype)
    _, static = pack_sweep_tables(ws, cg, dtype)
    _check_divisible(static.nt, mesh.size, "mesh size")
    src_m, src_c, is_cen = _descriptors(cg, sources)
    stages = [sweep_stage_to_device(sp, mesh.device) for sp in stages]
    D = mesh.size
    ntl = static.nt // D
    static_loc = static._replace(nt=ntl)
    tdtype = stages[0].tables.cfp.dtype
    tol = torch.tensor(config.tol_value(), dtype=tdtype, device=mesh.device)
    cap = max_rounds if max_rounds is not None else config.max_iters
    v, cen = _source_field(src_m, src_c, is_cen, ntl, static.ML, tdtype,
                           mesh.device, col0=mesh.coord(THETA_AXIS) * ntl)
    st = SweepState(v, cen, True, 0)
    for sp in stages:
        v, cen = st.dist, st.cen
        if sp.reset_keep is not None:
            v = torch.where(sp.reset_keep, v, float("inf"))
            if not sp.cen_keep:
                cen = torch.full_like(cen, float("inf"))
        st = _rounds(v, cen, st.it, sp.tables, static_loc, tol, cap, mesh,
                     halo_map=sp.halo_map)
    v, cen = _fan_settle(st.dist, st.cen, stages[-1].tables, mesh)
    _, ext = _extract_cached(ws.dcache, cg.cmap, receivers, mesh.device)
    rows = _textract(_gather_theta(v, mesh), cen, st.it, *ext)
    return rows.cpu().numpy()[:, :-1], st.it


def _as_station_mesh(mesh: Mesh) -> Mesh:
    """A 1-D mesh viewed as (n stations x 1 theta) on the same process
    group, so that no group has to be made (only the mesh's ranks call
    the sharded functions, and `new_group` needs every rank)."""
    me = mesh.ranks[mesh.index]
    whole = mesh.group(None)
    return Mesh(mesh.ranks, {SRC_AXIS: mesh.size, THETA_AXIS: 1},
                mesh.device, {None: whole, SRC_AXIS: whole,
                              THETA_AXIS: (None, (me,))}, mesh.index)


def station_fields_sharded(
    cg: CirculantGraph,
    stations,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    device=None,
) -> np.ndarray:
    """(n_stations, n) station travel-time fields for the locator
    (solvers/locate.py), the STATION axis split across the mesh
    (reciprocity: one solve a station; no collective between station
    rows) - the sharded form of locate.station_fields.  Pass a (source x
    theta) mesh from make_grid_mesh to also domain-decompose each field;
    a 1-D mesh splits the stations only."""
    if mesh is None:
        mesh = make_grid_mesh(_world(), 1, device=device)
    if SRC_AXIS not in mesh.shape:
        mesh.require_member()
        mesh = _as_station_mesh(mesh)
    vals, _ = solve_sweep_mesh_sharded(cg, stations, config, mesh=mesh)
    return vals
