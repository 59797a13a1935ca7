"""One Bellman-Ford-Moore iteration on the padded ELL graph: kernel and twin.

Counterpart of `raytracer_tpu/ops/relax.py`, which the JAX package runs
as the body of one jitted `lax.while_loop` (solvers/bfm.py).  As plain
torch one iteration is ~15 ops on a (n_pad, K) gather (190M slots at
180x63) and a solve several hundred iterations, so on the card an
iteration is one call of the hand-written CUDA kernel `csrc/ell_bfm.cu`
(a kernel of the port's own choice: the JAX package has no Pallas
kernel here).

What an iteration computes (`bfm_step_reference`, the JAX function op for
op, on (S, n_pad) fields, S sources side by side as `jax.vmap` runs
them):
  1. relax: for each node in the frontier, the minimum over its ELL
     slots of dist0[nbr] + w, the FIRST slot on ties (`argmin`); dist and
     prev take it where it is strictly below dist0;
  2. halo merge (the twin nodes of the doubled discontinuities): a row
     (s, d) whose source improved in this iteration and beats d pulls
     its distance into d (scatter-min) and, where it won, its
     predecessor; several winning rows of one destination resolve to the
     LAST in table order, as the JAX package's `.at[].set` does on the
     CPU (tests/test_torch_bfm.py pins the rule against it), and so does
     `init_state`'s twin pre-pointing;
  3. frontier: the improved nodes and their neighbours, ANDed with the
     level mask when one is given (the JAX package's `_masked_step` of
     solvers/multiphase.py: the reference's level-masked `_update_Q!`,
     src/SSSP/bfm_new_ms.jl:152-168); relaxation itself stays unmasked.
The state also carries `live`, 1 while the frontier is not empty, and a
step with `live` 0 or `it` at `max_iters` changes nothing, so a loop may
read the host only every few steps and still count the JAX package's
`it` (`solvers/bfm.py`).

`bfm_step` takes a CPU tensor to the twin and a CUDA tensor to the
kernel (or raises).  The kernel reads only the first `deg[i]` slots of a
row (`csr_to_ell` fills slots 0..deg-1 and pads with self-pointing +inf
slots, which never win) and gives each halo destination one warp over
its rows in table order (`ops/graph.halo_by_destination`), so its floats
and ids are the twin's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .graph import halo_by_destination

_INT32_MAX = 2 ** 31 - 1  # the iteration cap when none is given
# steps a solve on the card enqueues between two host reads of its flag
# (solvers/bfm, ops/banded)
CHECK_EVERY = 8


class DeviceGraph(NamedTuple):
    """Frozen device arrays for one solve configuration.

    nbr      : (n_pad, K) int32 ELL neighbour ids (self-pointing padding)
    w        : (n_pad, K) edge weights, +inf on padding
    halo_src : (H,) int32 twin-merge source ids (padded with 0)
    halo_dst : (H,) int32 twin-merge destination ids (padded with 0)
    n        : true node count
    deg      : (n_pad,) int32 the slots a row's relaxation reads: one
               past its last slot that does not point at the row itself
    didx, hoff, hsrc : the halo grouped by destination
               (`ops/graph.halo_by_destination`)
    """

    nbr: torch.Tensor
    w: torch.Tensor
    halo_src: torch.Tensor
    halo_dst: torch.Tensor
    n: int
    deg: torch.Tensor
    didx: torch.Tensor
    hoff: torch.Tensor
    hsrc: torch.Tensor


class BFMState(NamedTuple):
    dist: torch.Tensor   # (S, n_pad) or (n_pad,) current travel times
    prev: torch.Tensor   # same shape, int32 predecessor ids
    front: torch.Tensor  # same shape, bool frontier mask Q
    it: torch.Tensor     # () int32 iteration counter
    live: torch.Tensor   # () int32, 1 while the frontier is not empty


def row_degrees(nbr: np.ndarray) -> np.ndarray:
    """(n_pad,) int32: one past the last slot of each row that does not
    point at the row itself (0 for a row of padding only).  Slots past
    it point at the row, with weights >= 0, so they never improve it."""
    n_pad, k = nbr.shape
    real = nbr != np.arange(n_pad, dtype=nbr.dtype)[:, None]
    last = k - np.argmax(real[:, ::-1], axis=1)
    return np.where(real.any(axis=1), last, 0).astype(np.int32)


def device_graph(nbr, w, halo_src, halo_dst, n: int, device) -> DeviceGraph:
    """A DeviceGraph on `device` from host arrays (any dtype of w is kept:
    float32 or float64)."""
    nbr = np.ascontiguousarray(nbr, dtype=np.int32)
    w = np.ascontiguousarray(w)
    hs = np.ascontiguousarray(halo_src, dtype=np.int32)
    hd = np.ascontiguousarray(halo_dst, dtype=np.int32)
    didx, hoff, hsrc = halo_by_destination(hs, hd, nbr.shape[0])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DeviceGraph(nbr=t(nbr), w=t(w), halo_src=t(hs), halo_dst=t(hd),
                       n=int(n), deg=t(row_degrees(nbr)), didx=t(didx),
                       hoff=t(hoff), hsrc=t(hsrc))


def _set_last(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """base with base[..., idx[h]] = vals[..., h] for the rows h where
    `mask` holds (all when None); of several rows with one index the
    LAST in order wins.  base (S, n), idx (H,), vals and mask (S, H)."""
    H = idx.shape[0]
    if H == 0:
        return base
    rows = torch.arange(H, device=base.device).expand(vals.shape)
    key = rows if mask is None else torch.where(mask, rows,
                                                torch.full_like(rows, -1))
    last = torch.full(base.shape, -1, dtype=torch.int64, device=base.device)
    last = last.scatter_reduce(-1, idx.long().expand(vals.shape), key,
                               "amax", include_self=True)
    picked = vals.gather(-1, last.clamp(min=0))
    return torch.where(last >= 0, picked, base)


def relax_dense(dist0: torch.Tensor, nbr: torch.Tensor,
                w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """min over neighbour slots of dist0[nbr] + w -> (best_dist, best_prev)
    for dist0 (S, n_pad); the first slot on ties."""
    S, n_pad = dist0.shape
    K = nbr.shape[1]
    cand = dist0.index_select(1, nbr.reshape(-1)).view(S, n_pad, K) + w
    kmin = torch.argmin(cand, dim=2, keepdim=True)
    best = cand.gather(2, kmin)[..., 0]
    pbest = nbr.expand(S, n_pad, K).gather(2, kmin)[..., 0]
    return best, pbest


def halo_merge(dist, prev, dist0, halo_src, halo_dst):
    """Twin-node min-merge for (S, n_pad) fields, deterministic.

    For each halo row (s, d): if dist[s] improved this iteration and is
    better than dist[d], pull it (and its predecessor) into d.  Several
    rows of one d resolve to the min via scatter-min; of several rows
    that win, the last in table order gives the predecessor."""
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    hs, hd = halo_src.long(), halo_dst.long()
    ds = dist[:, hs]
    cond = (ds < dist0[:, hs]) & (dist[:, hd] > ds)
    cand = torch.where(cond, ds, inf)
    dist_new = dist.scatter_reduce(1, hd.expand(cand.shape), cand, "amin",
                                   include_self=True)
    won = cond & (dist_new[:, hd] == cand)
    prev_new = _set_last(prev, hd, prev[:, hs], won)
    return dist_new, prev_new


def _batched(state: BFMState):
    """The state's fields as (S, n_pad), and whether they were 1-D."""
    one = state.dist.dim() == 1
    if one:
        return (state.dist[None], state.prev[None], state.front[None]), True
    return (state.dist, state.prev, state.front), False


def _steps(state: BFMState, max_iters: Optional[int]) -> bool:
    """Whether a step changes the state: a frontier, and `it` below the
    cap.  Reads the host."""
    cap = _INT32_MAX if max_iters is None else max_iters
    live, it = torch.stack([state.live, state.it]).tolist()
    return bool(live) and it < cap


def _check_mask(mask: Optional[torch.Tensor], g: DeviceGraph):
    if mask is None:
        return
    n_pad = g.nbr.shape[0]
    if mask.dtype != torch.bool or tuple(mask.shape) != (n_pad,) \
            or mask.device != g.nbr.device:
        raise ValueError(f"mask must be a ({n_pad},) bool tensor on "
                         f"{g.nbr.device}, got {tuple(mask.shape)} "
                         f"{mask.dtype} on {mask.device}")


def bfm_step_reference(state: BFMState, g: DeviceGraph,
                       max_iters: Optional[int] = None,
                       mask: Optional[torch.Tensor] = None) -> BFMState:
    """One full BFM iteration, plain torch: relax the frontier, halo merge,
    rebuild the frontier (the JAX package's `bfm_step`); with `mask`
    ((n_pad,) bool) the new frontier keeps only the masked rows (the JAX
    package's `_masked_step`), and so does `live`."""
    _check_mask(mask, g)
    if not _steps(state, max_iters):
        return state
    (dist0, prev, Q), one = _batched(state)
    best, pbest = relax_dense(dist0, g.nbr, g.w)
    upd = Q & (best < dist0)
    dist = torch.where(upd, best, dist0)
    prev = torch.where(upd, pbest, prev)

    dist, prev = halo_merge(dist, prev, dist0, g.halo_src, g.halo_dst)

    improved = dist < dist0
    S, n_pad = dist.shape
    K = g.nbr.shape[1]
    Q_new = improved | improved.index_select(1, g.nbr.reshape(-1)).view(
        S, n_pad, K).any(dim=2)
    if mask is not None:
        Q_new = Q_new & mask
    live = Q_new.any().to(torch.int32)
    if one:
        dist, prev, Q_new = dist[0], prev[0], Q_new[0]
    return BFMState(dist=dist, prev=prev, front=Q_new, it=state.it + 1,
                    live=live)


def _ell_bfm_lib() -> ctypes.CDLL:
    lib = kernels.load("ell_bfm")
    fn = lib.ell_bfm_step_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return lib


def bfm_step(state: BFMState, g: DeviceGraph,
             max_iters: Optional[int] = None,
             mask: Optional[torch.Tensor] = None) -> BFMState:
    """One BFM iteration of `state` (fields (n_pad,) or (S, n_pad)) on the
    graph `g`; returns a new state, the input untouched.  A state whose
    frontier is empty, or whose `it` has reached `max_iters`, comes back
    unchanged (a copy on the card).  `mask` ((n_pad,) bool, optional) is
    the level mask of the staged solves: the new frontier, and `live`,
    keep only its rows (in the kernel, so a loop that reads `live` every
    few steps stops where the JAX package's masked loop stops).

    A CUDA state (float32 or float64) goes to the hand-written kernel
    `csrc/ell_bfm.cu`: two launches, the relaxation with the halo merge
    (a warp a row, a halo destination's warp also relaxing its sources),
    then the frontier with `it` and `live`, all on the device
    (`bfm_step.launches` counts the calls).  A CPU state goes to
    `bfm_step_reference`.  Any other device raises.
    """
    d = state.dist
    if d.device != g.w.device or d.dtype != g.w.dtype:
        raise ValueError(f"state ({d.device}, {d.dtype}) and graph "
                         f"({g.w.device}, {g.w.dtype}) differ")
    if d.device.type == "cpu":
        return bfm_step_reference(state, g, max_iters, mask)
    if d.device.type != "cuda":
        raise ValueError(f"bfm_step runs on cuda or cpu, not {d.device}")
    kernels.require_float("ell_bfm", d.dtype)
    _check_mask(mask, g)
    (dist0, prev0, front0), one = _batched(state)
    S, n_pad = dist0.shape
    if g.nbr.shape[0] != n_pad or prev0.dtype != torch.int32:
        raise ValueError(f"state ({S}, {n_pad}) {prev0.dtype} does not fit "
                         f"the graph ({tuple(g.nbr.shape)})")
    dist0, prev0 = dist0.contiguous(), prev0.contiguous()
    front0 = front0.contiguous().view(torch.uint8)
    it_in = state.it.to(torch.int32).contiguous()
    live_in = state.live.to(torch.int32).contiguous()
    dist1 = torch.empty_like(dist0)
    prev1 = torch.empty_like(prev0)
    front1 = torch.empty_like(front0)
    improved = torch.empty_like(front0)
    it_out = torch.empty((), dtype=torch.int32, device=d.device)
    live_out = torch.zeros((), dtype=torch.int32, device=d.device)
    cap = _INT32_MAX if max_iters is None else int(max_iters)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = _ell_bfm_lib().ell_bfm_step_launch(
        dist0.data_ptr(), prev0.data_ptr(), front0.data_ptr(),
        g.nbr.data_ptr(), g.w.data_ptr(), g.deg.data_ptr(),
        g.didx.data_ptr(), g.hoff.data_ptr(), g.hsrc.data_ptr(),
        None if mask is None else mask.contiguous().data_ptr(),
        it_in.data_ptr(), live_in.data_ptr(), dist1.data_ptr(),
        prev1.data_ptr(), improved.data_ptr(), front1.data_ptr(),
        it_out.data_ptr(), live_out.data_ptr(), S, n_pad, g.nbr.shape[1],
        cap, int(d.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"ell_bfm kernel launch failed: CUDA error {rc}")
    bfm_step.launches += 1
    front1 = front1.view(torch.bool)
    if one:
        dist1, prev1, front1 = dist1[0], prev1[0], front1[0]
    return BFMState(dist=dist1, prev=prev1, front=front1, it=it_out,
                    live=live_out)


bfm_step.launches = 0


def init_state(g: DeviceGraph, source, dtype,
               mask: Optional[torch.Tensor] = None) -> BFMState:
    """Initial distances, frontier and predecessors: +inf but 0 at the
    source, the frontier the source's neighbourhood (incl. itself), the
    halo twins pre-pointing at each other (the last row of a destination
    in table order wins).  `source` an int gives (n_pad,) fields, a
    sequence of S ints (S, n_pad) ones.  With a level `mask` ((n_pad,)
    bool) the frontier, and `live`, keep only its rows."""
    _check_mask(mask, g)
    dev = g.nbr.device
    dtype = getattr(torch, np.dtype(dtype).name)
    one = np.ndim(source) == 0
    src = torch.as_tensor(np.atleast_1d(np.asarray(source, dtype=np.int64)),
                          device=dev)
    S = src.shape[0]
    n_pad = g.nbr.shape[0]
    rows = torch.arange(S, device=dev)
    dist = torch.full((S, n_pad), float("inf"), dtype=dtype, device=dev)
    dist[rows, src] = 0
    prev = torch.arange(n_pad, dtype=torch.int32, device=dev).expand(
        S, n_pad)
    H = g.halo_dst.shape[0]
    prev = _set_last(prev, g.halo_dst, g.halo_src.expand(S, H))
    front = torch.zeros((S, n_pad), dtype=torch.bool, device=dev)
    front[rows[:, None], g.nbr[src].long()] = True
    front[rows, src] = True
    if mask is not None:
        front = front & mask
    live = front.any().to(torch.int32)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    if one:
        dist, prev, front = dist[0], prev[0], front[0]
    return BFMState(dist=dist, prev=prev.contiguous(), front=front, it=it,
                    live=live)
