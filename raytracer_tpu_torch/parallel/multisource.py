"""Multi-source travel-time tables, the source batch sharded over a mesh.

Counterpart of `raytracer_tpu/parallel/multisource.py`.  The sources are
padded to a multiple of the mesh size (`pad_sources`, the last source
repeated); each rank takes its block of them and runs the port's
single-device solve of that engine on its device, with the whole block
as one batch (as the JAX package's shard runs its block), and extracts
its receiver rows there.  The relaxation loops hold no collective; the
only one is a single `all_gather` of the rows, after which every rank
returns the whole table.  On the card the engines reach the kernels
`ell_bfm` (`bfm_step`), `titer`, `band`, `rsweep`, `sweep3d` and
`plane3d`.

The JAX package's `interpret` flag has no counterpart: the mesh's device
picks the route (the plain twins for a CPU mesh, the kernels on the
card).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.relax import BFMState, DeviceGraph
from .mesh import (Mesh, SOURCE_AXIS, all_gather, make_mesh, pad_sources,
                   source_sharding)


def _block(mesh: Optional[Mesh], sources, device=None):
    """(mesh, padded sources, this rank's block of them)."""
    mesh = mesh if mesh is not None else make_mesh(device=device)
    mesh.require_member()
    padded = pad_sources(np.asarray(sources), mesh.size)
    return mesh, padded, source_sharding(mesh).local(padded)


def _gather_rows(rows, mesh: Mesh, n_sources: int) -> np.ndarray:
    """The ranks' (S_local, k) row blocks as one (n_sources, k) host
    table (padding rows dropped)."""
    rows = torch.as_tensor(np.asarray(rows) if not torch.is_tensor(rows)
                           else rows).to(mesh.device)
    return all_gather(rows, mesh, SOURCE_AXIS).cpu().numpy()[:n_sources]


def solve_sharded(
    g: DeviceGraph,
    sources: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
) -> BFMState:
    """Solve a batch of sources sharded over the mesh: the state with a
    leading (padded) source axis, on the graph's device, on every rank;
    `it` holds each row's block iteration count.  The graph `g` is each
    rank's own copy, prepared on its device (`solvers.bfm.prepare`)."""
    from ..solvers.bfm import solve_state

    mesh, _, mine = _block(mesh, sources, g.w.device)
    st = solve_state(g, [int(s) for s in mine], config)
    n = len(mine)
    it = st.it.reshape(1).expand(n).to(torch.int32)

    def gather(x):
        return all_gather(x.to(mesh.device), mesh, SOURCE_AXIS).to(g.w.device)

    return BFMState(dist=gather(st.dist), prev=gather(st.prev),
                    front=gather(st.front), it=gather(it),
                    live=torch.zeros((), dtype=torch.int32,
                                     device=g.w.device))


def travel_time_table(
    g: DeviceGraph,
    sources: Sequence[int],
    receivers: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """(n_sources, n_receivers) travel-time table on the ELL graph (the
    `bfm` engine), sources sharded over the mesh."""
    from ..solvers.bfm import solve_state

    sources = np.asarray(sources)
    mesh, _, mine = _block(mesh, sources, g.w.device)
    st = solve_state(g, [int(s) for s in mine], config)
    ridx = torch.as_tensor(np.asarray(receivers, dtype=np.int64),
                           device=g.w.device)
    return _gather_rows(st.dist[:, ridx], mesh, len(sources))


def travel_time_table_twrapped(
    cg,
    sources: Sequence[int],
    receivers: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    device=None,
    _packed=None,
) -> np.ndarray:
    """Sharded table on the theta-major Jacobi engine (`titer` kernel on
    the card); each rank solves its block as one batch."""
    from ..ops.wrapped_t import (pack_twrapped_stencil,
                                 solve_circulant_twrapped, supports_twrapped)

    if not supports_twrapped(cg):
        raise ValueError("theta-major kernel unsupported for this ntheta")
    sources = np.asarray(sources)
    mesh, _, mine = _block(mesh, sources, device)
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=np.dtype(config.dtype), band_closure=config.band_closure)
    rows, _ = solve_circulant_twrapped(
        cg, mine, config, sweeps_per_call=4, batch=len(mine),
        receivers=receivers, device=mesh.device, _packed=ws)
    return _gather_rows(rows, mesh, len(sources))


def travel_time_table_stream(
    cg,
    sources: Sequence[int],
    receivers: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    warm_levels: int = 0,
    device=None,
    _packed=None,
) -> np.ndarray:
    """Sharded table on the streamed engine (`band` kernel on the card),
    optionally warm-started."""
    from ..ops.stream_t import solve_circulant_stream
    from ..ops.wrapped_t import pack_twrapped_stencil

    sources = np.asarray(sources)
    mesh, _, mine = _block(mesh, sources, device)
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=np.dtype(config.dtype), band_closure=config.band_closure)
    rows, _ = solve_circulant_stream(
        cg, mine, config, band_closure=config.band_closure,
        warm_levels=warm_levels, batch=len(mine), receivers=receivers,
        device=mesh.device, _packed=ws)
    return _gather_rows(rows, mesh, len(sources))


def travel_time_table_sweep(
    cg,
    sources: Sequence[int],
    receivers: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    device=None,
    _packed=None,
) -> np.ndarray:
    """Sharded table on the directional-sweep solver's production
    structure (engine "pallas": the `rsweep` kernel on the card)."""
    from ..ops.sweep_theta import solve_circulant_sweep
    from ..ops.wrapped_t import pack_twrapped_stencil

    sources = np.asarray(sources)
    mesh, _, mine = _block(mesh, sources, device)
    # the sweep tables are rebuilt from the raw decomposition: the
    # shared stencil must be packed closure-free
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=np.dtype(config.dtype), band_closure=0)
    rows, _ = solve_circulant_sweep(
        cg, mine, config, batch=len(mine), receivers=receivers,
        engine="pallas", device=mesh.device, _packed=ws)
    return _gather_rows(rows, mesh, len(sources))


def travel_time_table_3d(
    packed,
    sources: Sequence[int],
    receivers: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    engine: str = "xla",
    scan_every: int = None,
    sweeps: int = 8,
    device=None,
) -> np.ndarray:
    """Sharded multi-source 3-D table.  `packed` is a solvers.solve3d
    Packed3D; each rank solves its sources one after another (one field
    on its device at a time) on engine 'xla' (plain torch), 'pallas'
    (the `sweep3d` kernel on the card) or 'sweep' (the `plane3d`
    kernel), and keeps only the receiver values."""
    from ..solvers.solve3d import (_device_layout, _solve3d_kernel,
                                   _solve3d_sweep, _solve3d_xla)

    if engine not in ("xla", "pallas", "sweep"):
        raise ValueError(f"unknown engine {engine!r}")
    sources = np.asarray(sources)
    mesh, _, mine = _block(mesh, sources, device)
    dev = mesh.device
    if scan_every is None:
        scan_every = 0 if engine == "pallas" else 8
    name = "W4" if engine == "pallas" else "W"
    W = _device_layout(packed, name, dev)
    tol = torch.tensor(config.tol_value(), dtype=W.dtype, device=dev)
    ridx = torch.as_tensor(np.asarray(receivers, dtype=np.int64).ravel(),
                           device=dev)
    scan = _device_layout(packed, "scan", dev)
    rows = []
    for src in mine:
        if engine == "pallas":
            plan = packed.plan
            statics = (plan.n1, plan.BR, plan.NB, plan.L0, plan.H8,
                       packed.shape)
            d = _solve3d_kernel([int(src)], W, scan, tol, statics,
                                config.max_iters, scan_every, sweeps).dist[0]
        elif engine == "xla":
            d = _solve3d_xla(int(src), W, scan, tol, config.max_iters,
                             scan_every, packed.shifts).dist
        else:
            d = _solve3d_sweep([int(src)], W, scan, tol, config.max_iters,
                               (0, 1, 2), packed.shifts,
                               _device_layout(packed, "sweep", dev)).dist[0]
        rows.append(d.reshape(-1)[ridx])
    return _gather_rows(torch.stack(rows), mesh, len(sources))


def travel_time_table_circulant(
    cg,
    sources: Sequence[int],
    receivers: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    mesh: Optional[Mesh] = None,
    device=None,
) -> np.ndarray:
    """Sharded table on the circulant layout: each rank runs the plain
    circulant relaxation (`ops.circulant.solve_circulant`, the oracle)
    for each of its sources; float64 host values, as the JAX package
    returns them."""
    from ..ops.circulant import solve_circulant

    sources = np.asarray(sources)
    receivers = np.asarray(receivers, dtype=np.int64)
    mesh, _, mine = _block(mesh, sources, device)
    cache: dict = {}
    rows = np.stack([solve_circulant(cg, int(s), config, device=mesh.device,
                                     _dcache=cache)[0][receivers]
                     for s in mine]).astype(np.float64)
    return _gather_rows(rows, mesh, len(sources))
