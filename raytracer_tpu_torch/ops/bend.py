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
raises); `bend.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..kernels import BLOCK_SMEM

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
EPS = 1e-18          # under each sqrt of the functional
THREADS = 128        # the kernel's block: one block a path


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


def quad_points(quad: int, dtype, device) -> torch.Tensor:
    """The `quad` midpoints of [0, 1] (jnp.linspace's values)."""
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
    quadrature points and the reduction's slots."""
    return itemsize * (4 * m * d + 2 * (m - 1) * d + quad + THREADS // 32
                       + 2)


def _bend_lib() -> ctypes.CDLL:
    lib = kernels.load("bend")
    fn = lib.bend_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                       + [ctypes.c_double] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    return lib


def _launch(state: BendState, prof: SlownessTable, lr: float, r_max: float,
            iters: int, quad: int, init: bool, final: bool) -> BendState:
    """One kernel launch: [init,] `iters` steps [, final], in place on
    copies of the state's tensors."""
    P, mu, nu, count, bestP, bestT = state
    Bn, m, d = P.shape
    ts = quad_points(quad, P.dtype, P.device)
    stream = torch.cuda.current_stream(P.device).cuda_stream
    rc = _bend_lib().bend_launch(
        P.data_ptr(), mu.data_ptr(), nu.data_ptr(), bestP.data_ptr(),
        bestT.data_ptr(), ts.data_ptr(), prof.tab.data_ptr(),
        prof.tab.shape[0], float(prof.r0), float(prof.inv_dr), float(lr),
        float(r_max), int(count), int(iters), int(quad), Bn, m, d,
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
    `csrc/bend.cu`: one block a path, its iterate, best iterate and Adam
    moments in shared memory, every step of a chunk in one launch
    (`bend.launches` counts them).  CPU polylines go to
    `bend_reference`.  Any other device raises."""
    _check(P, prof, quad)
    if P.device.type == "cpu":
        return bend_reference(P, prof, lr, r_max, iters, quad, chunk)
    if P.device.type != "cuda":
        raise ValueError(f"bend runs on cuda or cpu, not {P.device}")
    kernels.require_float("bend", P.dtype)
    Bn, m, d = P.shape
    need = smem_bytes(m, d, quad, P.element_size())
    if need > BLOCK_SMEM:
        raise ValueError(f"a path of {m} vertices needs {need} bytes of "
                         f"shared memory, above the {BLOCK_SMEM} a block "
                         "may have")
    P = P.contiguous().clone()
    z = torch.zeros_like(P)
    state = BendState(P, z, z.clone(), 0, P.clone(),
                      torch.empty(Bn, dtype=P.dtype, device=P.device))
    pieces = _chunks(iters, chunk)
    for k, n in enumerate(pieces):
        state = _launch(state, prof, lr, r_max, n, quad, init=k == 0,
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
