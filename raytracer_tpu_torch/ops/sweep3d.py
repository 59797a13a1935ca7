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

The kernel reads the weights in a mirrored 13-tap layout (`M13`): the
edge weights are symmetric, so tap 25 - s at p is tap s at p - s.
`mirror_weights` derives it from W4 once per tensor and checks, bit for
bit, that the 26 weights it implies (`expand_mirrored`) are W4's, and
`sweep3d_mirrored_reference` evaluates the sweeps in that form.

The weight packing (`plan_sweep3d`) is NumPy, a copy of the JAX
package's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..kernels import BLOCK_SMEM
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


# ----------------------------------------------------------------------
# the mirrored 13-tap layout the kernel reads
# ----------------------------------------------------------------------

HALF = 13   # taps 0..12 of SHIFTS3; tap 25 - s is -SHIFTS3[s]


def _flat_taps(W4: torch.Tensor) -> torch.Tensor:
    """(NB, 26, BR, L0) -> (26, NB*BR, L0)."""
    NB, NT, BR, L0 = W4.shape
    return W4.permute(1, 0, 2, 3).reshape(NT, NB * BR, L0)


def expand_mirrored(M13: torch.Tensor, n1: int) -> torch.Tensor:
    """The (26, P, L0) weights the kernel uses from the (13, P, L0)
    mirrored layout: tap s < 13 is M13[s] at p, or +inf where its
    neighbour leaves [0, n1) in j (the kernel reads +inf there); tap
    25 - s is M13[s] at p - s (lanes mod L0), or +inf where p - s leaves
    [0, n1) in j or the rows [0, P)."""
    _, P, L0 = M13.shape
    dev = M13.device
    row = torch.arange(P, device=dev)
    j = row % n1
    inf = torch.tensor(float("inf"), dtype=M13.dtype, device=dev)
    out = torch.empty((len(SHIFTS3), P, L0), dtype=M13.dtype, device=dev)
    for s, (dk, dj, di) in enumerate(SHIFTS3[:HALF]):
        own = (j + dj >= 0) & (j + dj < n1)
        out[s] = torch.where(own[:, None], M13[s], inf)
        src = row - dk * n1 - dj
        live = (j - dj >= 0) & (j - dj < n1) & (src >= 0) & (src < P)
        moved = torch.roll(M13[s][src.clamp(0, P - 1)], di, dims=1)
        out[len(SHIFTS3) - 1 - s] = torch.where(live[:, None], moved, inf)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def mirror_weights(W4: torch.Tensor, n1: int) -> torch.Tensor:
    """The kernel's (13, NB*BR, L0) weights of W4 (NB, 26, BR, L0), on
    W4's device: a copy of its taps 0..12.  Derived once per tensor (kept
    on it, derived again if W4 is modified in place) and checked there:
    the 26 weights they imply must equal W4 bit for bit, +inf at the box
    faces, the lane wrap and the padding included; otherwise ValueError."""
    cache = getattr(W4, "_sweep3d_m13", None)
    if cache is not None and cache[0] == (W4._version, n1):
        return cache[1]
    NB, _, BR, L0 = W4.shape
    M13 = torch.empty((HALF, NB * BR, L0), dtype=W4.dtype, device=W4.device)
    M13.view(HALF, NB, BR, L0).copy_(W4[:, :HALF].permute(1, 0, 2, 3))
    if not torch.equal(_bits(expand_mirrored(M13, n1)),
                       _bits(_flat_taps(W4))):
        raise ValueError(
            "the weights are not mirror-symmetric (tap -s at p must equal "
            "tap s at p - s bit for bit, +inf where either leaves the box): "
            "the sweep3d kernel cannot read them in its 13-tap layout")
    W4._sweep3d_m13 = ((W4._version, n1), M13)
    return M13


def sweep3d_mirrored_reference(dist_flat: torch.Tensor, M13: torch.Tensor,
                               n1: int, T: int) -> torch.Tensor:
    """Plain PyTorch evaluation of T sweeps in the kernel's form: a
    neighbour read that leaves [0, n1) in j or the rows reads +inf, and
    the 26 weights come from the 13-tap layout (`expand_mirrored`).
    dist_flat (S, P, L0); returns a new field."""
    S, P, L0 = dist_flat.shape
    W = expand_mirrored(M13, n1)
    row = torch.arange(P, device=dist_flat.device)
    j = row % n1
    cur = dist_flat
    for _ in range(T):
        acc = cur
        for s, (dk, dj, di) in enumerate(SHIFTS3):
            src = row + dk * n1 + dj
            live = (j + dj >= 0) & (j + dj < n1) & (src >= 0) & (src < P)
            cand = cur[:, src.clamp(0, P - 1)]
            cand = torch.where(live[None, :, None], cand, float("inf"))
            if di:
                cand = torch.roll(cand, -di, dims=2)
            acc = torch.minimum(acc, cand + W[s])
        cur = acc
    return cur


def sweep3d_tiling(n1: int, L0: int, S: int, itemsize: int, planes: int,
                   sms: int = 132):
    """(lc, tj, kc, sc, smem bytes) of the kernel: a CTA walks kc k-planes
    of tj j-rows x lc lanes, sc fields at a time, with a ring of 4 plane
    tiles (one-row halo in j, the neighbouring lane each side) in shared
    memory.  tj = 8, lc = L0 and all S fields at once where they fit,
    else fewer rows, then narrower lane chunks (multiples of 128 dividing
    L0), then fewer fields; kc so that there is about one CTA per SM (the
    fastest of the tilings timed on an H100 at 128x128x64, S = 1 and 7)."""
    def smem(lc, tj, sc):
        return 4 * sc * (tj + 2) * (lc + 8) * itemsize

    lc, tj, sc = L0, min(8, n1), S
    while tj > 1 and smem(lc, tj, sc) > BLOCK_SMEM:
        tj //= 2
    while lc > LANES and smem(lc, tj, sc) > BLOCK_SMEM:
        lc = max(d for d in range(LANES, lc, LANES) if L0 % d == 0)
    while smem(lc, tj, sc) > BLOCK_SMEM:
        sc -= 1
    blocks = planes * -(-n1 // tj) * (L0 // lc)
    return lc, tj, max(1, -(-blocks // sms)), sc, smem(lc, tj, sc)


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
    return lib


def sweep3d_T_batched(dist_flat: torch.Tensor, W4: torch.Tensor, n1: int,
                      BR: int, NB: int, L0: int, H8: int, T: int,
                      interpret: bool = False) -> torch.Tensor:
    """T relaxation sweeps of S flat fields (S, NB*BR, L0) sharing the
    weights W4 (NB, 26, BR, L0); returns a new field, the input
    untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/sweep3d.cu`
    (float32 or float64; `sweep3d_T.launches` counts its calls), which
    reads W4 in the 13-tap layout of `mirror_weights` (derived and
    checked once per W4 tensor; a W4 whose weights are not symmetric
    raises); a CPU tensor goes to `sweep3d_reference`.  Any other device
    raises.
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
    kernels.require_float("sweep3d", dist_flat.dtype)
    if not (dist_flat.is_contiguous() and W4.is_contiguous()):
        raise ValueError("sweep3d takes contiguous tensors")
    M13 = mirror_weights(W4, n1)
    S = dist_flat.shape[0]
    sms = torch.cuda.get_device_properties(
        dist_flat.device).multi_processor_count
    lc, tj, kc, sc, _ = sweep3d_tiling(n1, L0, S, dist_flat.element_size(),
                                       -(-NB * BR // n1), sms)
    out = torch.empty_like(dist_flat)
    scratch = torch.empty_like(dist_flat) if T > 1 else out
    stream = torch.cuda.current_stream(dist_flat.device).cuda_stream
    rc = _sweep3d_lib().sweep3d_launch(
        dist_flat.data_ptr(), M13.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), S, n1, NB * BR, L0, T, lc, tj, kc, sc,
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
