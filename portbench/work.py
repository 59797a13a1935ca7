"""The least work of a solve, counted from the problem, and the card's
published peaks.

A solve of S sources on a graph of n nodes and E directed edges that
returns `outputs` values needs, whatever the design:
- bytes: each input read once and each output written once.  The input
  is the node velocities (n values: every edge weight 2 L / (U_a + U_b)
  derives from them and the grid's analytic geometry), the output the
  table's entries, all in the configuration's dtype;
- operations: an add and a min per graph edge per source, 2 E S.
The least time is the larger of bytes over the memory bandwidth and
operations over the dtype's peak rate, outside the tensor cores (no
min-plus product runs on them).  Nothing here reads a kernel's tables,
so a redesign of the kernels cannot make it stale; a program that drops
edges of the graph before solving changes the problem and must be
counted on its graph.

Peaks: NVIDIA H100 SXM5 80 GB data sheet, dense rates at the full 700 W
power limit: 3.35 TB/s HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64
outside the tensor cores.  A card set below 700 W reads lower; the
traced run reports the power limit beside the share.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}


class Work(NamedTuple):
    bytes: float
    flops: float
    seconds: float
    bound_by: str


def least_work(nodes: int, edges: int, sources: int, outputs: int,
               dtype: str) -> Work:
    itemsize = np.dtype(dtype).itemsize
    nbytes = float(nodes + outputs) * itemsize
    flops = 2.0 * edges * sources
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS_PER_S[np.dtype(dtype).name]
    return Work(nbytes, flops, max(t_mem, t_ops),
                "bytes" if t_mem >= t_ops else "operations")
