"""The bending optimiser of solvers/refine.py: kernel and twin.

The JAX package bends a batch of polylines to the continuous Fermat
minimum with `optax.adam` inside a `lax.scan` (`raytracer_tpu/solvers/
refine.py` `_bend_scan_jit`, 200 steps a dispatch, 800 or 1,600 steps in
all), vmapped over the paths, with no Pallas kernel.  As torch ops with
autograd every step is dozens of small launches and a trip through
Python, so on the card the whole bend of a (sub-)batch is one launch of
the hand-written CUDA kernel `csrc/bend.cu` (a kernel of the port's own
choice).  The card has no optax: the twin writes optax's Adam out, and
the kernel computes the same formula.

What a bend computes (`bend_reference`, on (B, m, d) float polylines,
d = 2 or 3, the two endpoints of each path pinned):
  * the functional of `_make_ttime`: t(P) = sum over segments of
    L * mean_k s(|A + (B - A) t_k|), t_k the `quad` midpoints of [0, 1],
    L = sqrt(|B - A|^2 + eps) and the radius sqrt(|p|^2 + eps) with
    eps = 1e-18 (a zero-length segment or a vertex at the origin would
    otherwise give a NaN gradient), s the linear interpolation of a
    uniform slowness table (`SlownessTable`) at the clipped index;
  * per step: t and its gradient g (autograd in the twin); the best
    iterate so far kept where t < best (False for a NaN t, so a NaN
    never replaces it); Adam with optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8, eps_root 0: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    the bias corrections 1 - b^count, update -lr mu^ / (sqrt(nu^) + eps)),
    the gradient and the update multiplied by the free mask (0 at the
    endpoints); then every vertex outside r_max scaled back onto it;
  * at the end, the final iterate's t against the best.
The Adam count carries across calls, so a bend cut into chunks
(`chunk=`) gives the result of one run.

`bend` takes CPU polylines to the twin and CUDA ones to the kernel (or
raises); `bend.launches` counts the kernel's launches.  On the card a
block bends one path; `bend_plan` picks its threads and the lanes that
share a segment's quadrature points from the batch, the path and the
card's SM count, and `bias_table` gives the launch its steps' Adam bias
corrections, computed on the host as the twin computes them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..kernels import BLOCK_SMEM

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
EPS = 1e-18          # under each sqrt of the functional
MAX_WARPS = 32       # csrc/bend.cu kMaxWarps: the warps' partial times
BIAS_WINDOW = 64     # csrc/bend.cu kBiasWindow: steps of bias corrections
SM_THREADS = 1024    # threads an SM holds at the kernel's 64 registers
SM_SMEM = 228 * 1024  # shared memory an SM has (1 KB of it kept a block)
H100_SMS = 132
# the planner's cost of a step, in the latency of one float32 quadrature
# point (a float64 one costs two): the fixed part (the segment's length
# and terms, the Adam update, two barriers), a doubling of the block's
# warps (the warps' sum, the barriers) and one level of xor shuffles in a
# group (set from the fan's and the table sub-batch's times at 12 plans
# on an H100, PERF.md)
STEP_FIXED, WARP_LEVEL, SHUFFLE_LEVEL = 4.0, 1.2, 3.0


class SlownessTable(NamedTuple):
    """Uniform-radius slowness table: s(r) = tab at (r - r0) * inv_dr."""

    r0: float
    inv_dr: float
    tab: torch.Tensor    # (n,) of the polylines' dtype, on their device


class BendState(NamedTuple):
    P: torch.Tensor      # (B, m, d) current iterate
    mu: torch.Tensor     # Adam's first moment
    nu: torch.Tensor     # Adam's second moment
    count: int           # Adam steps taken
    bestP: torch.Tensor  # (B, m, d) best iterate so far
    bestT: torch.Tensor  # (B,) its time


@functools.lru_cache(maxsize=16)
def quad_points(quad: int, dtype, device) -> torch.Tensor:
    """The `quad` midpoints of [0, 1] (jnp.linspace's values; kept: a copy
    to the card in every call would wait for the card each time)."""
    ts = np.linspace(0.5 / quad, 1.0 - 0.5 / quad, quad)
    return torch.as_tensor(ts, dtype=dtype, device=device)


def ttime(P: torch.Tensor, prof: SlownessTable, quad: int) -> torch.Tensor:
    """(B,) travel times of the (B, m, d) polylines under `prof`
    (differentiable: the twin takes its gradient by autograd)."""
    tab = prof.tab
    n = tab.shape[0]
    r0 = torch.tensor(prof.r0, dtype=P.dtype, device=P.device)
    inv_dr = torch.tensor(prof.inv_dr, dtype=P.dtype, device=P.device)
    A, B = P[..., :-1, :], P[..., 1:, :]
    ts = quad_points(quad, P.dtype, P.device)
    E = B - A
    pts = A[..., :, None, :] + E[..., :, None, :] * ts[:, None]
    r = torch.sqrt(torch.sum(pts * pts, dim=-1) + EPS)
    x = torch.clamp((r - r0) * inv_dr, 0.0, n - 1.0)
    i = torch.clamp(x.to(torch.int64), 0, n - 2)
    f = x - i.to(x.dtype)
    s = tab[i] * (1.0 - f) + tab[i + 1] * f
    L = torch.sqrt(torch.sum(E ** 2, dim=-1) + EPS)
    return torch.sum(L * torch.mean(s, dim=-1), dim=-1)


def _free(m: int, dtype, device) -> torch.Tensor:
    free = torch.ones((m, 1), dtype=dtype, device=device)
    free[0] = 0.0
    free[-1] = 0.0
    return free


def bend_init(P: torch.Tensor, prof: SlownessTable, quad: int) -> BendState:
    """The state before the first step: Adam's zeros, the input as the
    best iterate with its time."""
    with torch.no_grad():
        t0 = ttime(P, prof, quad)
    z = torch.zeros_like(P)
    return BendState(P.clone(), z, z.clone(), 0, P.clone(), t0)


def bend_steps_reference(state: BendState, prof: SlownessTable, lr: float,
                         r_max: float, iters: int, quad: int) -> BendState:
    """`iters` Adam steps of the twin (see the module docstring)."""
    P, mu, nu, count, bestP, bestT = state
    free = _free(P.shape[-2], P.dtype, P.device)
    rmax = torch.tensor(r_max, dtype=P.dtype, device=P.device)
    for _ in range(iters):
        Pg = P.detach().requires_grad_(True)
        t = ttime(Pg, prof, quad)
        g, = torch.autograd.grad(t.sum(), Pg)
        t = t.detach()
        better = t < bestT
        bestP = torch.where(better[:, None, None], P, bestP)
        bestT = torch.where(better, t, bestT)
        g = g * free
        mu = (1 - B1) * g + B1 * mu
        nu = (1 - B2) * g ** 2 + B2 * nu
        count += 1
        mu_hat = mu / (1 - B1 ** count)
        nu_hat = nu / (1 - B2 ** count)
        upd = -lr * (mu_hat / (torch.sqrt(nu_hat + 0.0) + ADAM_EPS))
        P = P + upd * free
        r = torch.sqrt(torch.sum(P * P, dim=-1, keepdim=True))
        P = torch.where(r > rmax, P * (rmax / r), P)
    return BendState(P, mu, nu, count, bestP, bestT)


def bend_final(state: BendState, prof: SlownessTable,
               quad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points, times): the final iterate where its time beats the best
    (a NaN time does not), else the best."""
    with torch.no_grad():
        tF = ttime(state.P, prof, quad)
    better = tF < state.bestT
    return (torch.where(better[:, None, None], state.P, state.bestP),
            torch.where(better, tF, state.bestT))


def bend_reference(P: torch.Tensor, prof: SlownessTable, lr: float,
                   r_max: float, iters: int, quad: int,
                   chunk: Optional[int] = None):
    """The plain twin of the `bend` kernel: (bent points, times)."""
    state = bend_init(P, prof, quad)
    for n in _chunks(iters, chunk):
        state = bend_steps_reference(state, prof, lr, r_max, n, quad)
    return bend_final(state, prof, quad)


def _chunks(iters: int, chunk: Optional[int]):
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if chunk is None or chunk >= iters:
        return [iters]
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return [min(chunk, iters - k) for k in range(0, iters, chunk)]


def smem_bytes(m: int, d: int, quad: int, itemsize: int) -> int:
    """The kernel's dynamic shared memory for one path: the iterate, the
    best iterate, Adam's two moments, the segments' two gradients, the
    quadrature points, the warps' partial times and the window of bias
    corrections."""
    return itemsize * (4 * m * d + 2 * (m - 1) * d + quad + MAX_WARPS
                       + 2 * BIAS_WINDOW)


class BendPlan(NamedTuple):
    """How the kernel bends a batch: one path a block of `threads`
    threads, `lanes` lanes a segment (each takes every lanes-th
    quadrature point), `smem` bytes of shared memory a block, `per_sm`
    blocks an SM holds at once."""

    threads: int
    lanes: int
    smem: int
    per_sm: int


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def bend_plan(Bn: int, m: int, d: int, quad: int, itemsize: int,
              sms: int = H100_SMS) -> BendPlan:
    """The kernel's block for a batch of Bn paths of m vertices in d
    dimensions: the (threads, lanes) of least modelled time, waves of
    blocks x (STEP_FIXED + WARP_LEVEL a doubling of warps + the longest
    lane's quadrature points a step, itemsize/4 each + SHUFFLE_LEVEL a
    shuffle level); ties go to fewer threads, then fewer lanes.  A path
    whose state does not fit one block's shared memory raises."""
    smem = smem_bytes(m, d, quad, itemsize)
    if smem > BLOCK_SMEM:
        raise ValueError(f"bend: a path of {m} vertices in {d} dimensions "
                         f"at quad {quad} needs {smem} bytes of shared "
                         f"memory, above the {BLOCK_SMEM} a block may have")
    best = None
    for threads in (128, 256, 512, 1024):
        per_sm = min(SM_THREADS // threads, SM_SMEM // (smem + 1024))
        waves = max(1, math.ceil(Bn / (sms * per_sm)))
        lanes = 1
        while lanes <= min(32, _pow2_ceil(quad)):
            chain = (math.ceil((m - 1) * lanes / threads)
                     * math.ceil(quad / lanes))
            cost = waves * (STEP_FIXED + chain * itemsize / 4
                            + WARP_LEVEL * math.log2(threads // 32)
                            + SHUFFLE_LEVEL * (lanes.bit_length() - 1))
            if best is None or cost < best[0]:
                best = (cost, BendPlan(threads, lanes, smem, per_sm))
            lanes *= 2
    return best[1]


@functools.lru_cache(maxsize=16)
def bias_table(count0: int, iters: int, dtype, device) -> torch.Tensor:
    """(2, iters): 1 - B1 ** count and 1 - B2 ** count for count =
    count0 + 1 ... count0 + iters, Python's float power in double as the
    twin computes them, cast to `dtype` (kept: a bend of the same steps
    reuses it)."""
    counts = range(count0 + 1, count0 + iters + 1)
    return torch.tensor([[1 - B1 ** c for c in counts],
                         [1 - B2 ** c for c in counts]],
                        dtype=torch.float64).to(dtype=dtype, device=device)


def _bend_lib() -> ctypes.CDLL:
    lib = kernels.load("bend")
    fn = lib.bend_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                       + [ctypes.c_double] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
    return lib


def _launch(state: BendState, prof: SlownessTable, lr: float, r_max: float,
            iters: int, quad: int, plan: BendPlan, init: bool,
            final: bool) -> BendState:
    """One kernel launch: [init,] `iters` steps [, final], in place on
    copies of the state's tensors."""
    P, mu, nu, count, bestP, bestT = state
    Bn, m, d = P.shape
    ts = quad_points(quad, P.dtype, P.device)
    bias = bias_table(count, iters, P.dtype, P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    rc = _bend_lib().bend_launch(
        P.data_ptr(), mu.data_ptr(), nu.data_ptr(), bestP.data_ptr(),
        bestT.data_ptr(), ts.data_ptr(), bias.data_ptr(),
        prof.tab.data_ptr(), prof.tab.shape[0], float(prof.r0),
        float(prof.inv_dr), float(lr), float(r_max), int(iters), int(quad),
        Bn, m, d, plan.threads, plan.lanes,
        int(init) | (int(final) << 1), int(P.dtype == torch.float64),
        stream)
    if rc != 0:
        raise RuntimeError(f"bend kernel launch failed: CUDA error {rc}")
    bend.launches += 1
    return BendState(P, mu, nu, count + iters, bestP, bestT)


def _check(P: torch.Tensor, prof: SlownessTable, quad: int):
    if P.dim() != 3 or P.shape[-1] not in (2, 3) or P.shape[-2] < 2:
        raise ValueError(f"P must be (B, m, d) with m >= 2 and d 2 or 3, "
                         f"got {tuple(P.shape)}")
    if quad < 1:
        raise ValueError(f"quad must be >= 1, got {quad}")
    tab = prof.tab
    if tab.dim() != 1 or tab.shape[0] < 2 or tab.dtype != P.dtype \
            or tab.device != P.device:
        raise ValueError(f"the slowness table must be (n >= 2,) {P.dtype} "
                         f"on {P.device}, got {tuple(tab.shape)} "
                         f"{tab.dtype} on {tab.device}")


def bend(P: torch.Tensor, prof: SlownessTable, lr: float, r_max: float,
         iters: int, quad: int, chunk: Optional[int] = None):
    """Bend the (B, m, d) polylines `P` for `iters` Adam steps; returns
    (points (B, m, d), times (B,)), the best iterate of each path.  With
    `chunk`, the steps run in pieces of at most `chunk` (the state
    carried between them; the result is the same).

    CUDA polylines (float32 or float64) go to the hand-written kernel
    `csrc/bend.cu`: one block a path as `bend_plan` shapes it, its
    iterate, best iterate and Adam moments in shared memory, every step
    of a chunk in one launch (`bend.launches` counts them).  CPU
    polylines go to `bend_reference`.  Any other device raises."""
    _check(P, prof, quad)
    if P.device.type == "cpu":
        return bend_reference(P, prof, lr, r_max, iters, quad, chunk)
    if P.device.type != "cuda":
        raise ValueError(f"bend runs on cuda or cpu, not {P.device}")
    kernels.require_float("bend", P.dtype)
    Bn, m, d = P.shape
    plan = bend_plan(Bn, m, d, quad, P.element_size(),
                     torch.cuda.get_device_properties(P.device)
                     .multi_processor_count)
    P = P.contiguous().clone()
    z = torch.zeros_like(P)
    state = BendState(P, z, z.clone(), 0, P.clone(),
                      torch.empty(Bn, dtype=P.dtype, device=P.device))
    pieces = _chunks(iters, chunk)
    for k, n in enumerate(pieces):
        state = _launch(state, prof, lr, r_max, n, quad, plan, init=k == 0,
                        final=k == len(pieces) - 1)
    return state.bestP, state.bestT


bend.launches = 0


def bend_work(Bn: int, m: int, d: int, quad: int, iters: int,
              itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one bend: the polylines read and the bent
    ones and their times written, the table's entries not counted (a few
    per quadrature point, from cache); about 40 operations a quadrature
    point of a segment for the time and its gradient, and 20 a
    coordinate for Adam and the projection, each of the iters steps plus
    the first and the last evaluation."""
    nbytes = itemsize * (2 * Bn * m * d + Bn)
    evals = (iters + 2) * Bn * (m - 1) * quad
    ops = 40.0 * evals + 20.0 * iters * Bn * m * d
    return float(nbytes), float(ops)


def uniform_table(r0: float, inv_dr: float, tab: np.ndarray, dtype,
                  device) -> SlownessTable:
    """A SlownessTable with `tab` on `device` in `dtype`."""
    return SlownessTable(float(r0), float(inv_dr),
                         torch.as_tensor(np.asarray(tab), dtype=dtype,
                                         device=device))
