"""Radius-stepping SSSP (delta-stepping flavoured), on the solver's device.

Counterpart of `raytracer_tpu/solvers/radius_stepping.py`, the
reference's experimental solver (src/SSSP/radius_stepping.jl:7-107):
relax out of the frontier, then settle every unsettled node whose
tentative distance is within the new radius (the minimum unsettled
distance).  The JAX package runs it as jnp in one `lax.while_loop`; here
it is plain torch on the graph's device, op for op (no kernel: it
settles about one distance shell an iteration, 211 iterations at 16x6,
and is not on any path the port's users drive).  An iteration after the
frontier empties, or at `max_iters`, changes nothing, so the loop reads
the host only every `CHECK_EVERY` iterations and still counts the JAX
package's iterations.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.relax import DeviceGraph
from .bfm import prepare
from .types import RadiusStepping

CHECK_EVERY = 16


class RSState(NamedTuple):
    dist: torch.Tensor
    prev: torch.Tensor
    unsettled: torch.Tensor  # Q in the reference
    front: torch.Tensor      # F in the reference
    it: torch.Tensor


def _step(s: RSState, g: DeviceGraph, max_iters: int) -> RSState:
    """One iteration, or the state unchanged when the frontier is empty
    or `it` has reached max_iters (decided on the device)."""
    inf = torch.tensor(float("inf"), dtype=s.dist.dtype, device=s.dist.device)
    n_pad, K = g.nbr.shape
    flat = g.nbr.reshape(-1)
    # pull-based relaxation: unsettled nodes take the min over frontier
    # neighbours
    nd = s.dist.index_select(0, flat).view(n_pad, K)
    in_front = s.front.index_select(0, flat).view(n_pad, K)
    cand = torch.where(in_front, nd + g.w, inf)
    kmin = torch.argmin(cand, dim=1, keepdim=True)
    best = cand.gather(1, kmin)[:, 0]
    pbest = g.nbr.gather(1, kmin)[:, 0]
    upd = s.unsettled & (best < s.dist)
    dist = torch.where(upd, best, s.dist)
    prev = torch.where(upd, pbest, s.prev)
    # new radius = min unsettled tentative distance; settle the shell
    delta = torch.min(torch.where(s.unsettled, dist, inf))
    front = s.unsettled & (dist <= delta)
    unsettled = s.unsettled & ~front
    go = s.front.any() & (s.it < max_iters)
    return RSState(torch.where(go, dist, s.dist), torch.where(go, prev, s.prev),
                   torch.where(go, unsettled, s.unsettled),
                   torch.where(go, front, s.front), s.it + go.to(torch.int32))


def radius_stepping(
    A: sp.csr_matrix,
    halo: np.ndarray,
    source: int,
    gr,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
) -> RadiusStepping:
    """Reference-signature entry (src/SSSP/radius_stepping.jl:7-46).

    Like the reference implementation, this ignores halo merging in the
    inner loop (the reference version predates the halo machinery); pass
    an empty halo for graphs without doubled discontinuity nodes.
    """
    g = prepare(A, halo, gr, U, config, device=device)
    st = solve_state(g, source, config)
    return RadiusStepping(prev=st.prev[: g.n].cpu().numpy(),
                          dist=st.dist[: g.n].cpu().numpy())


def solve_state(g: DeviceGraph, source: int,
                config: SolverConfig = DEFAULT_SOLVER_CONFIG) -> RSState:
    """The final state of a radius-stepping solve on the graph's device."""
    dev = g.nbr.device
    dtype = getattr(torch, np.dtype(config.dtype).name)
    n_pad = g.nbr.shape[0]
    dist = torch.full((n_pad,), float("inf"), dtype=dtype, device=dev)
    dist[source] = 0
    prev = torch.arange(n_pad, dtype=torch.int32, device=dev)
    unsettled = torch.ones(n_pad, dtype=torch.bool, device=dev)
    unsettled[source] = False
    front = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    front[source] = True
    s = RSState(dist, prev, unsettled, front,
                torch.zeros((), dtype=torch.int32, device=dev))
    while True:
        for _ in range(CHECK_EVERY):
            s = _step(s, g, config.max_iters)
        if not bool(s.front.any()) or int(s.it) >= config.max_iters:
            return s
