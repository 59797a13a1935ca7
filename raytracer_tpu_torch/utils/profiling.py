"""Profiling hooks: torch.profiler traces + per-iteration solver stats.

The port's counterpart of `raytracer_tpu/utils/profiling.py`:
  * `trace(log_dir)` wraps a block in `torch.profiler.profile` (CPU
    activity, and CUDA activity where a CUDA device is present) and
    writes a Chrome trace (chrome://tracing, Perfetto) into `log_dir`;
  * `iteration_stats` runs the circulant solver host-stepped, recording
    per-iteration frontier statistics (improved-node counts, max delta) -
    the structured equivalent of the reference's convergence printouts.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.circulant import (CirculantGraph, CircState, _circ_step,
                             resolve_device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: `with trace('/tmp/prof') as prof: solver.solve(...)`.

    Yields the `torch.profiler.profile`; on exit the Chrome trace is in
    `log_dir`, its path in `prof.trace_path`.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class IterationStat(NamedTuple):
    iteration: int
    improved_nodes: int
    max_delta: float


def iteration_stats(
    cg: CirculantGraph,
    source: int,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    max_iters: int = 10_000,
    device="cuda",
) -> List[IterationStat]:
    """Host-stepped circulant solve on `device` recording per-iteration
    statistics: one `ops/circulant._circ_step` a call, and its improved
    slots and largest decrease read back to the host.

    Slower than the solve loop (a host read per iteration); for debugging
    and analysis.  Stops at the first step that changes nothing, as
    `solve_circulant` does, so the list is as long as its iteration count.
    """
    device = resolve_device(device)
    dtype = getattr(torch, np.dtype(config.dtype).name)
    cmap = cg.cmap
    M, nt = cmap.M, cmap.ntheta

    dist = torch.full((M, nt), float("inf"), dtype=dtype, device=device)
    dcen = torch.tensor(float("inf"), dtype=dtype, device=device)
    if source == cmap.center:
        dcen = torch.zeros((), dtype=dtype, device=device)
    else:
        dist[int(cmap.m_of[source]), int(cmap.c_of[source])] = 0.0

    src_flat = torch.tensor(cg.src_flat.astype(np.int64), device=device)
    w = torch.tensor(cg.w, dtype=dtype, device=device)
    fan_slots = torch.tensor(cg.fan_slots.astype(np.int64), device=device)
    fan_w = torch.tensor(cg.fan_w, dtype=dtype, device=device)

    state = CircState(dist, dcen, True, 0)
    zero = torch.zeros((), dtype=dtype, device=device)
    stats: List[IterationStat] = []
    for it in range(max_iters):
        new = _circ_step(state, src_flat, w, fan_slots, fan_w)
        improved = int((new.dist < state.dist).sum())
        delta = float(torch.where(torch.isfinite(state.dist),
                                  state.dist - new.dist, zero).max())
        stats.append(IterationStat(it + 1, improved, delta))
        if not new.changed:
            break
        state = new
    return stats
