"""Plain exact shortest paths for the reference, in PyTorch.

Bellman-Ford relaxation to its fixpoint: each pass takes, for every node,
the least of its own time and of (neighbour time + edge weight) over its
in-edges, in place, until a pass changes nothing.  With positive weights
the fixpoint is the exact shortest-path field in the arithmetic of
`dtype` (float64 for the reference; bfloat16 for the control, which puts
the reference in the program's place one precision below the
configuration's float32).

The graph is an `EllGraph`: in-edges grouped by node degree into padded
blocks of rows.  A solve works on S sources at once, a block of rows at
a time, so that a gather never holds more than `_BLOCK_ELEMS` values.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

# the largest (sources x rows x width) block gathered at once
_BLOCK_ELEMS = 1 << 25
_WIDTHS = (8, 16, 32, 64, 128, 192, 256, 384, 512, 1024, 2048, 4096)


class EllBlock(NamedTuple):
    rows: torch.Tensor      # (b,) destination nodes
    nbr: torch.Tensor       # (b, K) source nodes, padded with the row
    w: torch.Tensor         # (b, K) weights, +inf in the padding


class EllGraph(NamedTuple):
    n: int
    blocks: List[EllBlock]


def ell_graph(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
              dtype, device) -> EllGraph:
    """In-edge blocks of a graph in CSR form (row = destination, column
    = source, value = float64 weight); the weights are cast to `dtype`
    once."""
    n = len(indptr) - 1
    deg = np.diff(indptr)
    width = np.searchsorted(np.asarray(_WIDTHS), deg)
    blocks = []
    for b in np.unique(width):
        K = int(_WIDTHS[b]) if b < len(_WIDTHS) else int(deg.max())
        rows = np.flatnonzero(width == b)
        step = max(1, _BLOCK_ELEMS // (K * 8))
        for lo in range(0, len(rows), step):
            rr = rows[lo:lo + step]
            k = np.arange(K)
            valid = k[None, :] < deg[rr][:, None]
            pos = np.where(valid, indptr[rr][:, None] + k[None, :], 0)
            nbr = np.where(valid, indices[pos], rr[:, None])
            ww = np.where(valid, data[pos], np.inf)
            blocks.append(EllBlock(
                torch.as_tensor(rr, device=device),
                torch.as_tensor(nbr.astype(np.int64), device=device),
                torch.as_tensor(ww, device=device).to(dtype)))
    return EllGraph(n, blocks)


def _init(n: int, sources, dtype, device) -> torch.Tensor:
    S = len(sources)
    d = torch.full((S, n), float("inf"), dtype=dtype,
                   device=device)
    d[torch.arange(S, device=device),
      torch.as_tensor(np.asarray(sources, np.int64), device=device)] = 0
    return d


def ell_solve(g: EllGraph, sources: Sequence[int], max_passes: int = 100_000
              ) -> Tuple[torch.Tensor, int]:
    """(S, n) shortest times from `sources` and the number of passes."""
    dtype, device = g.blocks[0].w.dtype, g.blocks[0].w.device
    d = _init(g.n, sources, dtype, device)
    passes = 0
    while passes < max_passes:
        changed = torch.zeros((), dtype=torch.bool, device=device)
        for blk in g.blocks:
            cand = (d[:, blk.nbr] + blk.w).amin(dim=2)
            old = d[:, blk.rows]
            better = cand < old
            changed |= better.any()
            d[:, blk.rows] = torch.where(better, cand, old)
        passes += 1
        if not bool(changed):
            break
    return d, passes
