"""Multi-stage / multiphase BFM sweeps (layer-by-layer propagation).

Counterpart of `raytracer_tpu/solvers/multiphase.py`, the reference's
experimental multi-leg phase scaffolding:
  * `bfm_ms`         (src/SSSP/bfm_new_ms.jl:30-138): element-incidence
    graph with halo, runs the first (downward) and last (upward) levels of
    the partition iterator, restarting from the minimum-distance boundary
    node with distances reset outside that boundary.
  * `bfm_multiphase` (src/SSSP/bfm_multiphase.jl:30-156): nodal sparse
    graph, sweeps the first `nlevels` iterator levels (reference hardcodes
    3), swapping the velocity at the active boundaries above/below per
    sweep direction before each level.

Both are dense-mask reformulations: the per-level frontier restriction
(`ID[Gi] not in current_level && continue`) becomes a boolean level mask
applied when rebuilding the frontier; relaxation itself is unrestricted,
exactly like the reference.  Three engines, as in the JAX package:
'ell' (one masked BFM iteration a call of `ops/relax.bfm_step`, on the
card the kernel `csrc/ell_bfm.cu` with its level mask), 'stream' (the
staged streamed solve, `ops/stream_t.solve_stream_staged`, band sweeps
on `csrc/band.cu`) and 'sweep' (the staged directional sweep,
`ops/sweep_theta.solve_sweep_staged`, radial sweeps on `csrc/rsweep.cu`
with destination-masked tables).  Entry points run on the card unless
the caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig, VELOCITY_BUFFER
from ..models.partition import GridPartition, level_mask, partition_grid
from ..ops.circulant import (build_circulant, recover_prev_device,
                             resolve_device)
from ..ops.relax import BFMState, DeviceGraph, init_state
from ..ops.stream_t import (StageSpec, _stream_tables, masked_stream_tables,
                            solve_stream_staged, stage_to_device)
from ..ops.sweep_theta import (SweepStageSpec, pack_rsweep_tables,
                               pack_sweep_tables, solve_sweep_staged,
                               sweep_stage_to_device)
from ..ops.wrapped_t import pack_twrapped_stencil
from .bfm import _run, prepare
from .types import BellmanFordMoore

_METHODS = ("ell", "stream", "sweep")


def directions(nlayers: int) -> Dict[int, Tuple[str, str]]:
    """Ray direction per iterator level (src/SSSP/bfm_new_ms.jl:1-14)."""
    nmax = 2 * nlayers - 1
    out: Dict[int, Tuple[str, str]] = {}
    out[1] = out[nmax] = ("above", "above")
    for i in range(2, nlayers):
        out[i] = out[nmax - i + 1] = ("below", "above")
    out[nlayers] = ("below", "below")
    return out


def boundary_velocity(
    U: np.ndarray,
    interpolant: Callable,
    r_boundary: float,
    boundary_nodes: np.ndarray,
    ray_direction: str,
    buffer: float = VELOCITY_BUFFER,
) -> np.ndarray:
    """Swap the velocity of boundary nodes to the value just above/below
    (src/SSSP/bfm_new_ms.jl:16-28 convention: 'above' samples r+buffer)."""
    U = np.asarray(U, dtype=np.float64).copy()
    if ray_direction == "above":
        val = interpolant(r_boundary + buffer)
    else:
        val = interpolant(r_boundary - buffer)
    U[boundary_nodes] = val
    return U


def _boundary_nodes(gr, partition: GridPartition) -> Dict[str, np.ndarray]:
    return {
        b: np.flatnonzero(partition.boundary_of == k + 1)
        for k, b in enumerate(partition.boundaries)
    }


def _lane_mask_of(cg, ws, node_mask: np.ndarray) -> np.ndarray:
    """(ML,) lane mask from a per-node mask: partition labels depend only
    on radius and radius is constant along a slot, so any column's node
    represents its slot."""
    rep = cg.cmap.node_of[:, 0]                      # (M,)
    lm = np.zeros(ws.ML, dtype=bool)
    lm[: cg.cmap.M] = node_mask[rep]
    return lm


def _halo_slot_map(cg, ws, halo: np.ndarray) -> Optional[np.ndarray]:
    """(K, ML) partner-slot maps of the halo twin table (identity where
    no twin).  Twins share their original's theta column, so the
    node-level halo collapses to per-slot maps; a destination slot can
    have SEVERAL partner slots (each discontinuity's original slot pairs
    with two twin slots on production annuli), so K rows cover the
    maximum multiplicity - a single last-write-wins permutation would
    silently drop twin-merge links."""
    if halo is None or len(halo) == 0:
        return None
    m_dst = cg.cmap.m_of[halo[:, 1]]
    m_src = cg.cmap.m_of[halo[:, 0]]
    partners = {}
    for a, b in zip(m_dst, m_src):
        partners.setdefault(int(a), []).append(int(b))
    # dedupe BEFORE sizing K: every theta column of a ring maps to the
    # same (dst, src) slot pair, so the raw lists carry ~ntheta copies
    # of each partner and K would balloon to ~ntheta; true multiplicity
    # is ~2
    partners = {a: list(dict.fromkeys(v)) for a, v in partners.items()}
    K = max(len(v) for v in partners.values())
    hm = np.tile(np.arange(ws.ML, dtype=np.int32), (K, 1))
    for a, srcs in partners.items():
        for k, b in enumerate(srcs):
            hm[k, a] = b
    return hm


def _ms_restart(cg, ws, partition, li, level):
    """(reset_keep, cen_keep) of the li-th level of a bfm_ms sequence:
    from the second level on, only the level's first boundary keeps its
    times."""
    if li == 0:
        return None, True
    first_boundary = partition.iterator[level][1]
    bmask = np.isin(partition.id, [first_boundary])
    return (_lane_mask_of(cg, ws, bmask),
            cg.cmap.center >= 0 and bool(bmask[cg.cmap.center]))


def _stage(method, cg, ws, node_mask, dtype, device=None, **kw):
    """One destination-masked stage of `method` ('stream' or 'sweep')
    restricted to the nodes of `node_mask`: host arrays, or tensors on
    `device` when one is given.  `kw` carries the stage's restart
    (reset_keep, cen_keep) and twin maps (halo_map)."""
    lane = _lane_mask_of(cg, ws, node_mask)
    cen_on = cg.cmap.center >= 0 and bool(node_mask[cg.cmap.center])
    if method == "sweep":
        tables, _ = pack_sweep_tables(ws, cg, dtype, slot_mask=lane[: ws.Mp],
                                      cen_on=cen_on)
        (wdn, wup), _ = pack_rsweep_tables(ws, cg, dtype,
                                           slot_mask=lane[: ws.Mp])
        stage = SweepStageSpec(tables=tables, wtab_dn=wdn, wtab_up=wup,
                               **kw)
    else:
        stage = StageSpec(
            tables=masked_stream_tables(ws, lane[: ws.Mp], cen_on, dtype),
            static=_stream_tables(ws, dtype)[1], sel_mask=lane, **kw)
    return stage if device is None else _ENGINES[method][1](stage, device)


def _ms_stages(cg, ws, halo, partition, levels, dtype, method="stream",
               device=None):
    """The stages of the bfm_ms level sequence on `method` (host arrays,
    or on `device`)."""
    halo_map = _halo_slot_map(cg, ws, halo)
    stages = []
    for li, level in enumerate(levels):
        reset_keep, cen_keep = _ms_restart(cg, ws, partition, li, level)
        stages.append(_stage(method, cg, ws, level_mask(partition, level),
                             dtype, device, reset_keep=reset_keep,
                             cen_keep=cen_keep, halo_map=halo_map))
    return stages


# method -> (its staged solve, its stage upload)
_ENGINES = {"stream": (solve_stream_staged, stage_to_device),
            "sweep": (solve_sweep_staged, sweep_stage_to_device)}


def _solve_stages(method, cg, ws, stages, source, config, device):
    """(field from `source`, iterations or rounds summed over the
    stages) of a staged solve on `method`."""
    dist, it = _ENGINES[method][0](cg, ws, stages, [source], config,
                                   device=device)
    return dist[0], it


def _ms_setup(A, halo, gr, U, config, levels, method, device, _reuse):
    """(cg, ws, stages on `device`, levels) of a staged bfm_ms, kept in
    `_reuse` under the JAX package's key plus U's fingerprint, the dtype
    and the device (one-time circulant pack and table upload; the rsweep
    tables' kernel plans stay on their tensors)."""
    dtype = np.dtype(config.dtype)
    key = ("ms_sweep_setup" if method == "sweep" else "ms_setup",
           tuple(levels) if levels else None, _fingerprint(U), dtype.name,
           str(device))
    if _reuse is not None and key in _reuse:
        return _reuse[key]
    partition = partition_grid(gr)
    if levels is None:
        levels = (1, 2 * partition.nlayers - 1)
    cg = build_circulant(gr, A, halo, U, dtype=dtype)
    # closure must stay off: closed-band entries are 2-hop compositions
    # whose intermediate slot is not mask-checked
    ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
    out = (cg, ws, _ms_stages(cg, ws, halo, partition, levels, dtype,
                              method, device), tuple(levels))
    if _reuse is not None:
        _reuse[key] = out
    return out


def _finish(cg, dist, source, want_prev, device, _dcache=None):
    """BellmanFordMoore of a staged field; predecessors recovered
    best-effort from the final field over the unmasked stencil (the
    multi-leg restart makes a single global shortest-path tree
    ill-defined; the reference's experimental ms code has the same
    ambiguity)."""
    if want_prev:
        prev = recover_prev_device(cg, dist, device, _dcache=_dcache)
        prev[source] = source
    else:
        prev = np.arange(len(dist))
    return BellmanFordMoore(prev=prev, dist=dist)


def bfm_ms_staged(A, halo, source, gr, U,
                  config: SolverConfig = DEFAULT_SOLVER_CONFIG,
                  levels: Optional[Tuple[int, ...]] = None,
                  method: str = "stream", device="cuda",
                  _reuse: Optional[dict] = None):
    """(dist, iterations summed over the stages, cg, ws) of bfm_ms on a
    staged engine ('stream': Jacobi iterations; 'sweep': rounds)."""
    device = resolve_device(device)
    cg, ws, stages, _ = _ms_setup(A, halo, gr, U, config, levels, method,
                                  device, _reuse)
    dist, it = _solve_stages(method, cg, ws, stages, source, config, device)
    return dist, it, cg, ws


def masked_solve(g: DeviceGraph, dist, prev, front, mask, max_iters: int
                 ) -> BFMState:
    """The JAX package's `_masked_solve_jit` on the graph's device: the
    frontier ANDed with the level mask, `it` from 0, masked steps until
    the frontier empties or `it` reaches max_iters."""
    front = front & mask
    state = BFMState(dist=dist, prev=prev, front=front,
                     it=torch.zeros((), dtype=torch.int32, device=dist.device),
                     live=front.any().to(torch.int32))
    return _run(g, state, max_iters, mask)


def _level_mask_t(partition, level, gr, n_pad, device):
    mask = np.zeros(n_pad, dtype=bool)
    mask[: gr.nnods] = level_mask(partition, level)
    return torch.as_tensor(mask, device=device)


def _fingerprint(U) -> tuple:
    """A light content fingerprint of U for the `_reuse` keys, so one
    reuse dict can serve several velocity tables (PcP with Vp then ScS
    with Vs; a U-blind key would silently reuse the wrong weights)."""
    Ua = np.asarray(U)
    return (Ua.shape, float(Ua[:: max(1, Ua.size // 16)].sum()))


def _ell_graph(A, halo, gr, U, config, device, _reuse):
    """The prepared ELL graph, kept in `_reuse` under a key that carries
    U's fingerprint (a port-side convenience: the JAX package's ell path
    packs on every call)."""
    key = ("ms_ell_graph", str(device), np.dtype(config.dtype).name,
           _fingerprint(U))
    if _reuse is not None and key in _reuse:
        return _reuse[key]
    g = prepare(A, halo, gr, U, config, device=device)
    if _reuse is not None:
        _reuse[key] = g
    return g


def _ms_ell_levels(gr, levels, n_pad, device, _reuse):
    """Per level of bfm_ms's ELL path: (its node mask, the node ids of
    its first boundary, where the restart keeps its times) as tensors on
    `device`, kept in `_reuse` (the partition's string labels take a
    host pass over every node)."""
    key = ("ms_ell_levels", tuple(levels) if levels else None, str(device))
    if _reuse is not None and key in _reuse:
        return _reuse[key]
    partition = partition_grid(gr)
    if levels is None:
        levels = (1, 2 * partition.nlayers - 1)
    bnodes = _boundary_nodes(gr, partition)
    plan = [(_level_mask_t(partition, level, gr, n_pad, device),
             torch.as_tensor(bnodes[partition.iterator[level][1]],
                             device=device))
            for level in levels]
    if _reuse is not None:
        _reuse[key] = plan
    return plan


def bfm_ms(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    levels: Optional[Tuple[int, ...]] = None,
    method: str = "ell",
    device="cuda",
    want_prev: bool = True,
    _reuse: Optional[dict] = None,
) -> BellmanFordMoore:
    """Multi-stage BFM (src/SSSP/bfm_new_ms.jl:30-138).

    Default levels = (1, last), like the reference's
    `for i in [1, length(iterator)]`.  Between levels the source moves to
    the minimum-distance node of the level's first boundary and all other
    distances reset to +inf.

    method='stream' runs the circulant staged streamed solve (level masks
    as per-slot lane masks, the boundary restart a lane reset); 'sweep'
    the directional-sweep engine (~3-4 rounds a stage); 'ell' the
    general-graph implementation the fast paths are held to, with the
    restart (argmin over the boundary, the reset) on the device.  Pass a
    dict as `_reuse` to keep the one-time pack and upload across solves.
    """
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, not {method!r}")
    if method != "ell":
        dist, _, cg, ws = bfm_ms_staged(A, halo, source, gr, U, config,
                                        levels, method, device, _reuse)
        return _finish(cg, dist, source, want_prev, resolve_device(device),
                       ws.dcache)
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    g = _ell_graph(A, halo, gr, U, config, device, _reuse)
    n_pad = g.nbr.shape[0]
    plan = _ms_ell_levels(gr, levels, n_pad, device, _reuse)

    st = init_state(g, int(source), dtype)
    dist, prev = st.dist, st.prev

    for li, (mask, keep) in enumerate(plan):
        if li > 0:
            # restart from the best node on the level's first boundary:
            # non-boundary distances reset to +inf, the boundary keeps its
            # accumulated travel times (the reference never zeroes the new
            # source, src/SSSP/bfm_new_ms.jl:96-110 - only the frontier is
            # re-seeded around it); argmin and reset stay on the device
            src = keep[torch.argmin(dist[keep])]
            reset = torch.ones(n_pad, dtype=torch.bool, device=device)
            reset[keep] = False
            dist = torch.where(reset, torch.tensor(float("inf"),
                                                   dtype=dist.dtype,
                                                   device=device), dist)
            front = torch.zeros(n_pad, dtype=torch.bool, device=device)
            front[g.nbr[src].long()] = True
            front[src] = True
        else:
            front = st.front

        out = masked_solve(g, dist, prev, front, mask, config.max_iters)
        dist, prev = out.dist, out.prev

    return BellmanFordMoore(prev=prev[: gr.nnods].cpu().numpy(),
                            dist=dist[: gr.nnods].cpu().numpy())


def _multiphase_levels(gr, U, partition, interpolant, nlevels):
    """Per level i = 1..nlevels: (i, U with the level's boundary
    velocities swapped, the swaps accumulating level after level)."""
    bnodes = _boundary_nodes(gr, partition)
    ray_dir = directions(partition.nlayers)
    bdict = dict(zip(partition.boundaries, partition.rboundaries))
    U = np.asarray(U, dtype=np.float64).copy()
    for i in range(1, nlevels + 1):
        current_boundaries = partition.iterator[i][1:]
        if interpolant is not None:
            for b in current_boundaries:
                U = boundary_velocity(
                    U, interpolant, bdict[b], bnodes[b],
                    ray_dir[i][0 if b == current_boundaries[0] else 1])
        yield i, U


def multiphase_stages(A, gr, U, partition: Optional[GridPartition] = None,
                      interpolant: Optional[Callable] = None,
                      config: SolverConfig = DEFAULT_SOLVER_CONFIG,
                      nlevels: int = 3, method: str = "stream",
                      device="cuda"):
    """(cg and ws of level 1, the stages on `device`) of bfm_multiphase
    on a staged engine: each level's boundary velocity swap is one
    circulant repack, so each level gets its own stage tables."""
    device = resolve_device(device)
    partition = partition or partition_grid(gr)
    empty_halo = np.empty((0, 2), dtype=np.int64)
    dtype = np.dtype(config.dtype)

    stages = []
    cg0 = ws0 = None
    for i, Ui in _multiphase_levels(gr, U, partition, interpolant, nlevels):
        cg = build_circulant(gr, A, empty_halo, Ui, dtype=dtype)
        ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
        if cg0 is None:
            cg0, ws0 = cg, ws
        stages.append(_stage(method, cg, ws, level_mask(partition, i),
                             dtype, device))
    return cg0, ws0, stages


def bfm_multiphase_staged(A, source, gr, U,
                          partition: Optional[GridPartition] = None,
                          interpolant: Optional[Callable] = None,
                          config: SolverConfig = DEFAULT_SOLVER_CONFIG,
                          nlevels: int = 3, method: str = "stream",
                          device="cuda"):
    """(dist, iterations summed over the stages, cg of level 1) of
    bfm_multiphase on a staged engine (`multiphase_stages`)."""
    device = resolve_device(device)
    cg0, ws0, stages = multiphase_stages(A, gr, U, partition, interpolant,
                                         config, nlevels, method, device)
    dist, it = _solve_stages(method, cg0, ws0, stages, source, config,
                             device)
    return dist, it, cg0


def bfm_multiphase(
    A: sp.csr_matrix,
    source: int,
    gr,
    U: np.ndarray,
    partition: Optional[GridPartition] = None,
    interpolant: Optional[Callable] = None,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    nlevels: int = 3,
    method: str = "ell",
    device="cuda",
) -> BellmanFordMoore:
    """Multiphase BFM on the nodal graph (src/SSSP/bfm_multiphase.jl:30-156).

    Sweeps the first `nlevels` partition levels (the reference hardcodes
    `for i in 1:3`), updating the boundary-node velocities above/below per
    the level's ray direction before each sweep.  No halo (the reference
    variant predates node doubling).

    method='stream' runs the circulant staged streamed solve (per-level
    repacked weights); 'sweep' the directional-sweep engine (~3-4 rounds
    a stage); 'ell' the general-graph implementation (one `prepare` a
    level, the weights changing with U).
    """
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, not {method!r}")
    device = resolve_device(device)
    if method != "ell":
        dist, _, cg0 = bfm_multiphase_staged(A, source, gr, U, partition,
                                             interpolant, config, nlevels,
                                             method, device)
        return _finish(cg0, dist, source, True, device)
    partition = partition or partition_grid(gr)
    empty_halo = np.empty((0, 2), dtype=np.int64)
    dtype = np.dtype(config.dtype)

    dist = prev = None
    for i, Ui in _multiphase_levels(gr, U, partition, interpolant, nlevels):
        # weights change with U -> repack per level
        g = prepare(A, empty_halo, gr, Ui, config, device=device)
        mask = _level_mask_t(partition, i, gr, g.nbr.shape[0], device)
        st0 = init_state(g, int(source), dtype)
        if dist is None:
            dist, prev = st0.dist, st0.prev
        out = masked_solve(g, dist, prev, st0.front, mask, config.max_iters)
        dist, prev = out.dist, out.prev

    return BellmanFordMoore(prev=prev[: gr.nnods].cpu().numpy(),
                            dist=dist[: gr.nnods].cpu().numpy())


def find_new_source_min(dist: np.ndarray, partition: GridPartition,
                        boundary: str) -> int:
    """Minimum-distance node on a boundary
    (src/SSSP/bfm_multiphase.jl:158-170)."""
    nodes = np.flatnonzero(partition.id == boundary)
    return int(nodes[np.argmin(np.asarray(dist)[nodes])])
