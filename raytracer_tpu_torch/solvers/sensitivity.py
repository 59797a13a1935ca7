"""Tomographic sensitivity kernels: exact d(travel time)/d(velocity).

Counterpart of `raytracer_tpu/solvers/sensitivity.py`.  Along a recovered
first-arrival path the travel time is t = sum_e 2 L_e/(U_i + U_j) (the
edge weight of ops/weights.py), so

    dt/dU_k = sum over path edges (i,j) incident to k of  -t_e/(U_i+U_j)

exactly (Fermat: the path itself is stationary, so moving it contributes
nothing to first order).  Scalar-velocity weights are homogeneous of
degree -1 in U, giving the identity  sum_k U_k * dt/dU_k = -t.

The host entry points (`path_sensitivity`, `path_sensitivity_dual`) take
a single path and stay NumPy, copies of the JAX package's.  The device
entry points (`sensitivity_coo`, `sensitivity_matrix`) walk every
receiver's predecessor chain and turn each walked pair into its terms:
one launch of the CUDA kernel `csrc/paths.cu` on the card, which writes
the walk, the COO row and the dense row together; the plain twin (the
walk, the pair terms in torch, `scatter_add_`) on the CPU.  Scalar U
only on the device, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.circulant import resolve_device
from ..ops.paths import paths
from ..ops.weights import _coords
from .path import _int32_on


def _n_nodes(gr) -> int:
    """Total node count for both grid families (annulus: int nnods;
    Grid3D: tuple nnods + nnods_total)."""
    n = getattr(gr, "nnods_total", None)
    return int(n) if n is not None else int(gr.nnods)


def _twin_partners(n: int, halo) -> np.ndarray:
    """(n, P) padded partner table of the zero-cost twin merge pairs
    (models/annulus.py halo; a node may have several partners).  P=1
    with all -1 when there is no halo, so downstream shapes stay static."""
    halo = np.asarray(halo) if halo is not None else np.empty((0, 2), np.int64)
    if halo.size == 0:
        return np.full((n, 1), -1, np.int32)
    a = np.concatenate([halo[:, 0], halo[:, 1]])
    b = np.concatenate([halo[:, 1], halo[:, 0]])
    counts = np.bincount(a, minlength=n)
    P = max(1, int(counts.max()))
    out = np.full((n, P), -1, np.int32)
    slot = np.zeros(n, np.int64)
    for i, j in zip(a, b):
        out[i, slot[i]] = j
        slot[i] += 1
    return out


def _pair_terms(coords, U, a, b, partners, xp):
    """Per-edge (t_e, 1/(U_a+U_b)) for node-id arrays a, b (same shape);
    zero-length or impassable (usum<=0) pairs contribute 0, and so do
    zero-cost twin-merge hops (the backtrace walks them, but the solver
    charges them nothing).  The host form (xp = numpy); the device form
    is `ops/paths.pair_terms`."""
    L2 = None
    for axis in coords:
        axis = xp.asarray(axis)
        d = axis[a] - axis[b]
        L2 = d * d if L2 is None else L2 + d * d
    L = xp.sqrt(L2)
    usum = U[a] + U[b]
    good = usum > 0
    is_twin = (partners[a] == b[..., None]).any(axis=-1)
    inv = xp.where(good & ~is_twin,
                   1.0 / xp.where(good, usum, 1.0), 0.0)
    return 2.0 * L * inv, inv


def path_sensitivity(gr, U: np.ndarray, path: np.ndarray,
                     halo=None) -> np.ndarray:
    """Dense (n,) array dt/dU for one recovered path (node-id sequence
    from `recontruct_path`, receiver..source order).  Scalar U only.
    Pass the grid's halo so zero-cost twin-merge hops are skipped."""
    U = np.asarray(U, np.float64)
    if U.ndim != 1:
        raise ValueError("path_sensitivity expects scalar velocities (n,); "
                         "use path_sensitivity_dual for (n, 2) duals")
    path = np.asarray(path, np.int64)
    out = np.zeros(U.shape[0])
    if path.size < 2:
        return out
    a, b = path[:-1], path[1:]
    partners = _twin_partners(U.shape[0], halo)
    t_e, inv = _pair_terms(_coords(gr), U, a, b, partners, np)
    np.add.at(out, a, -t_e * inv)
    np.add.at(out, b, -t_e * inv)
    return out


def path_sensitivity_dual(gr, U: np.ndarray, path: np.ndarray,
                          halo=None) -> np.ndarray:
    """Dense (n, 2) array dt/dU for dual (below, above) velocities.

    Edge (tail i, head j=prev[i]) picks head/tail columns by relative
    radius exactly as ops/weights.py::edge_weights_dual; the derivative
    lands only on the two picked entries."""
    U = np.asarray(U, np.float64)
    path = np.asarray(path, np.int64)
    out = np.zeros_like(U)
    if path.size < 2:
        return out
    i, j = path[:-1], path[1:]            # dist[i] = dist[j] + w(i<-j)
    head_above = np.asarray(gr.r)[i] > np.asarray(gr.r)[j]
    U_head = np.where(head_above, U[j, 1], U[j, 0])
    U_tail = np.where(head_above, U[i, 0], U[i, 1])
    L2 = None
    for axis in _coords(gr):
        d = np.asarray(axis)[i] - np.asarray(axis)[j]
        L2 = d * d if L2 is None else L2 + d * d
    partners = _twin_partners(U.shape[0], halo)
    is_twin = (partners[i] == j[:, None]).any(axis=1)
    usum = U_head + U_tail
    good = (usum > 0) & ~is_twin
    inv = np.where(good, 1.0 / np.where(good, usum, 1.0), 0.0)
    g = -2.0 * np.sqrt(L2) * inv * inv
    np.add.at(out, (i, np.where(head_above, 0, 1)), g)   # tail column
    np.add.at(out, (j, np.where(head_above, 1, 0)), g)   # head column
    return out


def _device_terms(gr, U, halo, dev: torch.device):
    """(coords (ndim, n), U (n,), partners (n, P) int32) on `dev`, in U's
    dtype when it is float32, else float64."""
    U = np.asarray(U)
    if U.ndim != 1:
        raise ValueError("device sensitivity supports scalar velocities")
    dt = torch.float32 if U.dtype == np.float32 else torch.float64
    coords = torch.as_tensor(np.stack([np.asarray(c, np.float64)
                                       for c in _coords(gr)]),
                             dtype=dt, device=dev)
    partners = torch.as_tensor(_twin_partners(_n_nodes(gr), halo),
                               device=dev)
    return coords, torch.as_tensor(U, dtype=dt, device=dev), partners


def _device_rows(gr, U, prev, source, receivers, max_len, halo, dense,
                 device):
    dev = resolve_device(device)
    terms = _device_terms(gr, U, halo, dev)
    return paths(_int32_on(prev, dev), int(source),
                 _int32_on(receivers, dev).reshape(-1), int(max_len),
                 terms, dense)


def sensitivity_coo(gr, U, prev, source, receivers, max_len: int,
                    halo=None, device="cuda"):
    """Padded COO kernels on `device`: (ids, vals) tensors of shape
    (n_rec, 2*(max_len-1)).  Duplicate ids are additive; padding rows
    carry value 0 at the source id.  Scales to meshes where the dense
    (n_rec, n) matrix does not fit."""
    out = _device_rows(gr, U, prev, source, receivers, max_len, halo,
                       False, device)
    return out.ids, out.vals


def sensitivity_matrix(gr, U, prev, source, receivers, max_len: int,
                       halo=None, device="cuda") -> torch.Tensor:
    """Dense (n_rec, n) tomography matrix G on `device`, G[r, k] =
    dt_r/dU_k (the walk and the scatter in one launch on the card)."""
    return _device_rows(gr, U, prev, source, receivers, max_len, halo,
                        True, device).dense
