"""Edge travel-time weights of the ELL layout (host NumPy).

The counterpart of `raytracer_tpu/ops/weights.py`: the (n_pad, K) weight
matrix of an `ELLGraph`, +inf on padding slots, each real slot the
segment length times the harmonic-mean slowness of its two endpoints,
2*|xi - xj| / (U_tail + U_head), evaluated in float64 and then cast to
`dtype`.  Two velocity conventions:
  * scalar U (n,): plain harmonic mean;
  * dual U (n, 2) = (below, above): a ray from j up to i leaves j with its
    *above* velocity and enters i with its *below* velocity.

The JAX package evaluates the formula on every slot of the padded matrix
(190M at 180x63, ~20 s on one core) and then masks the padding; here the
same float64 operations, in the same order, run on the real slots only
and are scattered into a +inf matrix, which gives the same floats
(tests/test_torch_graph.py holds them bit-equal).
"""
from __future__ import annotations

import numpy as np

from .circulant import _safe_weight
from .graph import ELLGraph

INF = np.float64(np.inf)


def _coords(gr):
    """Cartesian coordinate tuple of a grid: (x, z) for the 2-D annulus,
    (x, y, z) for 3-D structured grids."""
    if hasattr(gr, "y") and getattr(gr, "y") is not None:
        return (gr.x, gr.y, gr.z)
    return (gr.x, gr.z)


def _real_slots(ell: ELLGraph):
    """(rows, slots, neighbours) of the real ELL slots, row-major."""
    rows, slots = np.nonzero(ell.mask)
    return rows, slots, ell.nbr[rows, slots].astype(np.int64)


def _segment_lengths(coords, rows, cols) -> np.ndarray:
    """|x_row - x_col| in float64, the squares summed axis by axis."""
    total = None
    for axis in coords:
        a = np.asarray(axis, dtype=np.float64)
        d = a[rows] - a[cols]
        total = d * d if total is None else total + d * d
    return np.sqrt(total)


def _scatter(ell: ELLGraph, rows, slots, w, dtype) -> np.ndarray:
    out = np.full(ell.nbr.shape, np.inf, dtype=dtype)
    out[rows, slots] = w.astype(dtype)
    return out


def edge_weights_scalar(gr, ell: ELLGraph, U: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(n_pad, K) weights, +inf on padding slots. U is (n,) velocity."""
    rows, slots, cols = _real_slots(ell)
    U = np.asarray(U, dtype=np.float64)
    L = _segment_lengths(_coords(gr), rows, cols)
    w = _safe_weight(L, U[rows] + U[cols])
    return _scatter(ell, rows, slots, w, dtype)


def edge_weights_dual(gr, ell: ELLGraph, U: np.ndarray, dtype=np.float32) -> np.ndarray:
    """(n_pad, K) weights from dual (below, above) velocities U (n, 2).

    With i the tail (node being updated) and j = nbr[i, k] the head, the
    head velocity is `above` if r_i > r_j else `below`, the tail velocity
    the opposite column.
    """
    rows, slots, cols = _real_slots(ell)
    U = np.asarray(U, dtype=np.float64)
    r = np.asarray(gr.r, dtype=np.float64)
    head_above = r[rows] > r[cols]       # ray travels upward from j to i
    U_head = np.where(head_above, U[cols, 1], U[cols, 0])
    U_tail = np.where(head_above, U[rows, 0], U[rows, 1])
    L = _segment_lengths(_coords(gr), rows, cols)
    w = _safe_weight(L, U_tail + U_head)
    return _scatter(ell, rows, slots, w, dtype)
