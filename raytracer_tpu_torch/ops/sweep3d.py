"""The 26-tap multi-sweep kernel of the 3-D spherical-shell solve.

Counterpart of `raytracer_tpu/ops/sweep3d.py`.  The (n2, n1, n0) field
is flattened to rows = k*n1 + j and lanes = i and padded with +inf to
(NB*BR, L0); a tap (dk, dj, di) of the 26-point stencil is then a row
shift by dk*n1 + dj plus a lane shift by di, taken mod L0.  The weights
`W4` (NB, 26, BR, L0) carry +inf across the non-periodic box faces and in
the padding (solvers/solve3d._shifted_weights), so every read that would
cross a j-row or an i-lane boundary is masked by its weight and the
sweep needs no masks.

`sweep3d_T_batched` runs T Jacobi sweeps of S fields (S, NB*BR, L0) that
share the weights: on CUDA tensors as the hand-written kernel
`csrc/sweep3d.cu`, on CPU tensors as its plain twin `sweep3d_reference`,
which follows the Pallas kernel's form (a page with H8 +inf rows at
each end, one row slice and one lane roll per tap, a running minimum).
Every candidate is one add and the minimum does not depend on order, so
kernel and twin give the same floats as the Pallas kernel.
`sweep3d_T.launches` counts the kernel's calls through either wrapper.

The weight packing (`plan_sweep3d`) is NumPy, a copy of the JAX
package's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from .diag_circulant import LANES, SUB, _round_up

# the 26 taps, same order as solvers/solve3d.SHIFTS
SHIFTS3 = tuple(
    (dk, dj, di)
    for dk in (-1, 0, 1)
    for dj in (-1, 0, 1)
    for di in (-1, 0, 1)
    if (dk, dj, di) != (0, 0, 0)
)


class Sweep3DPlan(NamedTuple):
    """Static layout of the kernel + host-packed weights.

    W4   : (NB, NT, BR, L0) per-block weight slabs (NT=26), +inf padded
    shape: (n2, n1, n0) logical field shape
    """

    W4: np.ndarray
    shape: Tuple[int, int, int]
    n1: int
    BR: int
    NB: int
    L0: int
    H8: int


def sweep3d_statics(shape, block_rows: int = 1024):
    """(n1, BR, NB, L0, H8) of the padded flat layout of an
    (n2, n1, n0) field: BR rows per weight block, NB blocks, L0 lanes (a
    multiple of 128) and H8 >= n1 + 1 +inf rows at each end of a page."""
    n2, n1, n0 = shape
    rows = n2 * n1
    L0 = _round_up(n0, LANES)
    BR = min(_round_up(rows, SUB), _round_up(block_rows, SUB))
    NB = -(-rows // BR)
    H8 = _round_up(n1 + 1, SUB)
    return n1, BR, NB, L0, H8


def plan_sweep3d(W: np.ndarray, block_rows: int = 1024) -> Sweep3DPlan:
    """Pack the (26, n2, n1, n0) weight array for the kernel."""
    NT, n2, n1, n0 = W.shape
    assert NT == len(SHIFTS3)
    rows = n2 * n1
    _, BR, NB, L0, H8 = sweep3d_statics((n2, n1, n0), block_rows)
    W4 = np.full((NB, NT, BR, L0), np.inf, dtype=W.dtype)
    Wf = W.reshape(NT, rows, n0)
    for b in range(NB):
        lo = b * BR
        hi = min(rows, lo + BR)
        W4[b, :, : hi - lo, :n0] = Wf[:, lo:hi, :]
    return Sweep3DPlan(W4=W4, shape=(n2, n1, n0), n1=n1, BR=BR, NB=NB,
                       L0=L0, H8=H8)


def pack_field(dist3: torch.Tensor, plan: Sweep3DPlan) -> torch.Tensor:
    """(..., n2, n1, n0) -> padded flat (..., NB*BR, L0), +inf in the
    padding."""
    n2, n1, n0 = plan.shape
    lead = tuple(dist3.shape[:-3])
    out = torch.full(lead + (plan.NB * plan.BR, plan.L0), float("inf"),
                     dtype=dist3.dtype, device=dist3.device)
    out[..., : n2 * n1, :n0] = dist3.reshape(lead + (n2 * n1, n0))
    return out


def unpack_field(flat: torch.Tensor, plan: Sweep3DPlan) -> torch.Tensor:
    n2, n1, n0 = plan.shape
    lead = tuple(flat.shape[:-2])
    return flat[..., : n2 * n1, :n0].reshape(lead + (n2, n1, n0))


def sweep3d_reference(dist_flat: torch.Tensor, W4: torch.Tensor, n1: int,
                      BR: int, NB: int, L0: int, H8: int,
                      T: int) -> torch.Tensor:
    """Plain PyTorch twin of `sweep3d_T_batched`, in the Pallas kernel's
    form: each sweep reads a page with H8 +inf rows at each end, takes
    every tap as a row slice offset by dk*n1 + dj rolled on lanes by
    (-di) mod L0, and keeps the running minimum of tap + weight.
    dist_flat (S, NB*BR, L0); returns a new (S, NB*BR, L0) field."""
    S = dist_flat.shape[0]
    P = NB * BR
    Wt = W4.permute(1, 0, 2, 3).reshape(len(SHIFTS3), P, L0)
    pad = torch.full((S, H8, L0), float("inf"), dtype=dist_flat.dtype,
                     device=dist_flat.device)
    cur = dist_flat
    for _ in range(T):
        page = torch.cat([pad, cur, pad], dim=1)
        acc = cur
        for s, (dk, dj, di) in enumerate(SHIFTS3):
            r = H8 + dk * n1 + dj
            cand = page[:, r:r + P]
            if di:
                cand = torch.roll(cand, (-di) % L0, dims=2)
            acc = torch.minimum(acc, cand + Wt[s])
        cur = acc
    return cur


def _check_args(dist_flat, W4, n1, BR, NB, L0, H8, T):
    if T < 1:
        raise ValueError("needs at least one sweep (T >= 1)")
    if dist_flat.dim() != 3 or tuple(dist_flat.shape[1:]) != (NB * BR, L0):
        raise ValueError(f"dist_flat must be (S, {NB * BR}, {L0}), got "
                         f"{tuple(dist_flat.shape)}")
    if tuple(W4.shape) != (NB, len(SHIFTS3), BR, L0):
        raise ValueError(f"W4 must be ({NB}, {len(SHIFTS3)}, {BR}, {L0}), "
                         f"got {tuple(W4.shape)}")
    if H8 < n1 + 1:
        raise ValueError(f"H8={H8} pad rows do not cover the taps' row "
                         f"reach n1 + 1 = {n1 + 1}")
    if W4.device != dist_flat.device:
        raise ValueError(f"sweep3d tensors on {W4.device} and "
                         f"{dist_flat.device}")
    if W4.dtype != dist_flat.dtype:
        raise TypeError(f"sweep3d tensors of {W4.dtype} and {dist_flat.dtype}")


def _sweep3d_lib() -> ctypes.CDLL:
    lib = kernels.load("sweep3d")
    fn = lib.sweep3d_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    return lib


def sweep3d_T_batched(dist_flat: torch.Tensor, W4: torch.Tensor, n1: int,
                      BR: int, NB: int, L0: int, H8: int, T: int,
                      interpret: bool = False) -> torch.Tensor:
    """T relaxation sweeps of S flat fields (S, NB*BR, L0) sharing the
    weights W4 (NB, 26, BR, L0); returns a new field, the input
    untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/sweep3d.cu`
    (float32 or float64; `sweep3d_T.launches` counts its calls); a CPU
    tensor goes to `sweep3d_reference`.  Any other device raises.
    `interpret` is accepted for parity with the JAX package, whose Pallas
    interpreter it selects; the port has no interpreter on the card, so
    `interpret=True` with a CUDA tensor raises.
    """
    _check_args(dist_flat, W4, n1, BR, NB, L0, H8, T)
    if dist_flat.device.type == "cpu":
        return sweep3d_reference(dist_flat, W4, n1, BR, NB, L0, H8, T)
    if dist_flat.device.type != "cuda":
        raise ValueError(f"sweep3d runs on cuda or cpu, not "
                         f"{dist_flat.device}")
    if interpret:
        raise ValueError("interpret=True runs the JAX package's Pallas "
                         "interpreter; the port has none on a CUDA device")
    if dist_flat.dtype not in (torch.float32, torch.float64):
        raise TypeError("the sweep3d kernel takes float32 or float64, not "
                        f"{dist_flat.dtype}")
    if not (dist_flat.is_contiguous() and W4.is_contiguous()):
        raise ValueError("sweep3d takes contiguous tensors")
    S = dist_flat.shape[0]
    out = torch.empty_like(dist_flat)
    scratch = torch.empty_like(dist_flat) if T > 1 else out
    stream = torch.cuda.current_stream(dist_flat.device).cuda_stream
    rc = _sweep3d_lib().sweep3d_launch(
        dist_flat.data_ptr(), W4.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), S, n1, BR, NB, L0, T,
        int(dist_flat.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"sweep3d kernel launch failed: CUDA error {rc}")
    sweep3d_T.launches += 1
    return out


def sweep3d_T(dist_flat: torch.Tensor, W4: torch.Tensor, n1: int, BR: int,
              NB: int, L0: int, H8: int, T: int,
              interpret: bool = False) -> torch.Tensor:
    """T relaxation sweeps of one flat (NB*BR, L0) field."""
    return sweep3d_T_batched(dist_flat[None], W4, n1, BR, NB, L0, H8, T,
                             interpret)[0]


sweep3d_T.launches = 0
