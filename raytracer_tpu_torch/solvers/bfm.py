"""Bellman-Ford-Moore SSSP on any graph: the reference's headline solver.

Counterpart of `raytracer_tpu/solvers/bfm.py`.  `prepare` packs the host
CSR graph into a padded ELL `DeviceGraph` on one device once (weights
precomputed, ops/weights.py); `solve` and `solve_many` run single- or
multi-source solves, the sources side by side in one state as the JAX
package's vmapped loop runs them; `bfm` is the reference-signature
convenience wrapper, `bfm_gpu` and `bfm_tpu` its aliases, `bfm3d` the
same solve on a 3-D grid (no halo).

The JAX package runs a solve as one `lax.while_loop` whose condition
(`any(frontier) & it < max_iters`) stays on the device.  Here each
iteration is one `ops/relax.bfm_step` (on the card one call of the
kernel `csrc/ell_bfm.cu`), and a step after the frontier empties changes
nothing, so the loop reads the host only every `CHECK_EVERY` steps on
the card and still returns the JAX package's `it`, `dist` and `prev`.
Entry points run on the card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.circulant import resolve_device
from ..ops.graph import csr_to_ell, pad_halo
from ..ops.relax import (CHECK_EVERY, BFMState, DeviceGraph, bfm_step,
                         device_graph, init_state)
from ..ops.weights import edge_weights_dual, edge_weights_scalar
from .types import BellmanFordMoore


def prepare(
    A: sp.csr_matrix,
    halo: np.ndarray,
    gr,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
) -> DeviceGraph:
    """Pack graph + weights + halo into arrays on `device` (one-time host
    step): the ELL layout of `config.node_pad` x `config.degree_pad`, its
    weights in `config.dtype`, the halo padded to a multiple of 8 rows."""
    dev = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ell = csr_to_ell(A, node_pad=config.node_pad, degree_pad=config.degree_pad)
    U = np.asarray(U)
    if U.ndim == 2:
        w = edge_weights_dual(gr, ell, U, dtype=dtype)
    else:
        w = edge_weights_scalar(gr, ell, U, dtype=dtype)
    hsrc, hdst = pad_halo(halo)
    return device_graph(ell.nbr, w, hsrc, hdst, ell.n, dev)


def _run(g: DeviceGraph, state: BFMState, max_iters: int,
         mask=None) -> BFMState:
    """Steps until the frontier empties or `it` reaches max_iters; with a
    level `mask` the frontier keeps only its rows (`ops/relax.bfm_step`)."""
    check = CHECK_EVERY if g.w.device.type == "cuda" else 1
    while True:
        for _ in range(check):
            state = bfm_step(state, g, max_iters, mask)
        live, it = torch.stack([state.live, state.it]).tolist()
        if not live or it >= max_iters:
            return state


def _dtype_of(g: DeviceGraph, config: SolverConfig):
    dtype = np.dtype(config.dtype)
    if str(g.w.dtype) != f"torch.{dtype.name}":
        raise ValueError(f"graph weights are {g.w.dtype}, config.dtype "
                         f"is {dtype.name}")
    return dtype


def solve_state(g: DeviceGraph, sources, config: SolverConfig = DEFAULT_SOLVER_CONFIG) -> BFMState:
    """The final state of a solve on the graph's device: `sources` an int
    gives (n_pad,) fields, a sequence (S, n_pad) ones."""
    state = init_state(g, sources, _dtype_of(g, config))
    return _run(g, state, config.max_iters)


def solve(g: DeviceGraph, source: int, config: SolverConfig = DEFAULT_SOLVER_CONFIG) -> BellmanFordMoore:
    """Single-source solve -> BellmanFordMoore(prev, dist) (host arrays)."""
    st = solve_state(g, int(source), config)
    return BellmanFordMoore(prev=st.prev[: g.n].cpu().numpy(),
                            dist=st.dist[: g.n].cpu().numpy())


def solve_many(g: DeviceGraph, sources: Sequence[int], config: SolverConfig = DEFAULT_SOLVER_CONFIG) -> BellmanFordMoore:
    """Multi-source solve; prev/dist have a leading source axis.  All
    sources iterate together until every frontier is empty."""
    st = solve_state(g, [int(s) for s in sources], config)
    return BellmanFordMoore(prev=st.prev[:, : g.n].cpu().numpy(),
                            dist=st.dist[:, : g.n].cpu().numpy())


def bfm(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
) -> BellmanFordMoore:
    """Reference-signature entry point (src/SSSP/bfm.jl:1-52).

    Packs the graph and runs the solve.  For repeated solves on the same
    graph use `prepare` + `solve` to amortise packing.
    """
    g = prepare(A, halo, gr, U, config, device=device)
    return solve(g, source, config)


def bfm_gpu(*args, **kwargs) -> BellmanFordMoore:
    """API-parity alias: the reference exposes a separate CUDA entry point
    (src/SSSP/bfm_gpu.jl:207); here it is `bfm`, on the card by default."""
    return bfm(*args, **kwargs)


bfm_tpu = bfm_gpu


def bfm3d(
    A: sp.csr_matrix,
    source: int,
    gr3,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
) -> BellmanFordMoore:
    """BFM on a 3-D spherical-shell grid (models/grid3d.py): the same ELL
    machinery with 3-D cartesian segment lengths and no halo."""
    return bfm(A, np.empty((0, 2), dtype=np.int64), source, gr3, U, config,
               device=device)
