"""Banded min-plus solver: the fast path for UNSTRUCTURED 2-D meshes.

Counterpart of `raytracer_tpu/ops/banded.py`.  After a reverse
Cuthill-McKee reordering every edge (j -> i) has a small index offset
o = j - i (|o| <= the bandwidth, 629 on the production Delaunay annulus
of 47,480 nodes), so the pull-based relaxation is a DIAGONAL sweep: for
each occupied offset o, cand = min(cand, roll(dist, -o) + W[o]), W[o][i]
the weight of edge (i+o -> i) (+inf where that edge does not exist).  A
finite W[o][i] exists only for a real edge, whose endpoint i+o lies in
[0, n), so the roll never wraps a finite candidate.  Predecessors come
from the converged field through the host `PrevRecovery`.

`prepare_banded` builds the JAX package's arrays (RCM order, offsets, the
dense W, the halo in permuted ids) on the host and puts on one device
what the kernels read: the finite taps of each row (the source row i+o
and the weight, CSR by row), and the halo grouped by destination
(`ops/graph.halo_by_destination`).  The dense W stays on the host: only
the plain twins read it, and they take it to the field's device.

The solves (`solve_banded`, Jacobi; `solve_banded_gs`, Gauss-Seidel
block sweeps) are loops of two steps, each a hand-written CUDA kernel
(`csrc/banded.cu`, kernels of the port's own choice: the JAX package
runs them as XLA) on a CUDA field and its plain twin on a CPU one:
  * `banded_step` (kernel `banded_sweep`): up to `count` Jacobi
    iterations of the JAX package's `_solve_banded_jit` loop (the sweep,
    the halo scatter-min with every source read before any write, the
    changed flag; while changed and it < max_iters), `it` and the flag
    kept on the device.  On the card one cooperative launch runs them
    with a grid sync between iterations, on the route `jacobi_plan`
    picks from the shapes: the shared route (each block's rows, their
    taps laid out by `jacobi_layout` and the block's window of the field
    in shared memory) where they fit, the global route (the tap lists
    and the field from L2) where they do not.  `solve_banded` runs the
    whole solve as one call and reads the host once.  Each candidate is
    one add and the min is exact, so the kernel's walk over the finite
    taps gives the floats of the twin's dense rolls.
  * `banded_gs` (kernel `banded_gs`): one direction of
    `_solve_banded_gs_jit`'s `sweep`, blocks of B rows strictly in order
    with P passes a block (a pass reads the block's own rows as they
    stood at its start, the rows outside as they stood when the block
    began), then the halo merge.  `gs_plan` picks its route from the
    shapes: the window route (the rows a block's taps reach, and its
    taps laid out by `gs_layout`, in shared memory) where they fit, the
    wide-band route (rows out of the block from global memory) where
    they do not; neither refuses a graph for its size.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels
from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..kernels import BLOCK_SMEM
from .circulant import csr_edge_weights, resolve_device
from .graph import _round_up, halo_by_destination, pad_halo, rcm_permutation
from .bend import H100_SMS
from .relax import _INT32_MAX

CHUNK = 8  # offsets folded into one step of the JAX package's scan


class BandedGraph(NamedTuple):
    """Frozen banded layout (RCM-permuted node order) on one device.

    offs   : (mc, C) int32 diagonal offsets, 0-padded
    W      : (mc, C, n_pad) weights of edge (i+o -> i), +inf where absent,
             a host tensor (the kernels read the tap lists)
    halo_src/halo_dst : (H,) int32 twin-merge pairs in PERMUTED ids
    perm   : (n,) new -> old node ids;  iperm: old -> new (host arrays)
    n, n_pad : true / padded node counts
    offsets_np : (m,) host copy of the real offsets
    toff, tcol, tw : the finite taps of each row, CSR by row: row i's
             taps are tcol[toff[i]:toff[i+1]] (the source rows i+o,
             int32) with weights tw, in offset order
    didx, hoff, hsrc : the halo grouped by destination
    gs     : banded_gs's window layouts on the device, by (B, dtype):
             `gs_layout`, built at prepare time on a CUDA device for the
             default block, else at first use
    jacobi : banded_sweep's plans and shared-route layouts on the device,
             by (S, dtype): `jacobi_layout`, built at first use
    """

    offs: torch.Tensor
    W: torch.Tensor
    halo_src: torch.Tensor
    halo_dst: torch.Tensor
    perm: np.ndarray
    iperm: np.ndarray
    n: int
    n_pad: int
    offsets_np: np.ndarray
    toff: torch.Tensor
    tcol: torch.Tensor
    tw: torch.Tensor
    didx: torch.Tensor
    hoff: torch.Tensor
    hsrc: torch.Tensor
    gs: dict
    jacobi: dict


def tap_lists(offs: np.ndarray, W: np.ndarray):
    """(toff, tcol, tw): the finite entries of the packed W (rows
    offs.size, columns n_pad) as per-row tap lists, CSR by row, each row's
    taps in offset order, the source row i+o in tcol."""
    W2 = W.reshape(-1, W.shape[-1])
    o = np.asarray(offs, dtype=np.int64).reshape(-1)
    rows, t = np.nonzero(np.isfinite(W2.T))
    toff = np.zeros(W2.shape[1] + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=W2.shape[1]), out=toff[1:])
    return toff, (rows + o[t]).astype(np.int32), W2[t, rows]


def banded_graph(offs, W, halo_src, halo_dst, perm, iperm, n: int,
                 n_pad: int, offsets_np, device) -> BandedGraph:
    """A BandedGraph on `device` from the host arrays of the JAX package's
    layout (W float32 or float64, kept as it is, and on the host)."""
    offs = np.ascontiguousarray(offs, dtype=np.int32)
    W = np.ascontiguousarray(W)
    hs = np.ascontiguousarray(halo_src, dtype=np.int32)
    hd = np.ascontiguousarray(halo_dst, dtype=np.int32)
    toff, tcol, tw = tap_lists(offs, W)
    if tcol.size and (tcol.min() < 0 or tcol.max() >= n):
        raise ValueError("a finite weight reaches outside [0, n): the "
                         "dense roll would wrap it")
    didx, hoff, hsrc = halo_by_destination(hs, hd, n_pad)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    bg = BandedGraph(offs=t(offs), W=torch.from_numpy(W), halo_src=t(hs),
                     halo_dst=t(hd),
                     perm=np.asarray(perm, dtype=np.int64),
                     iperm=np.asarray(iperm, dtype=np.int64), n=int(n),
                     n_pad=int(n_pad),
                     offsets_np=np.asarray(offsets_np, dtype=np.int64),
                     toff=t(toff), tcol=t(tcol), tw=t(tw), didx=t(didx),
                     hoff=t(hoff), hsrc=t(hsrc), gs={}, jacobi={})
    if bg.tw.device.type == "cuda":
        _gs_route(bg, _gs_block(bg.n_pad, 512))
    return bg


def prepare_banded(
    A: sp.csr_matrix,
    halo: np.ndarray,
    gr,
    U: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    order: str = "rcm",
    device="cuda",
) -> BandedGraph:
    """Pack graph + weights into diagonal rows (one-time host step) on
    `device`.  order='rcm' (default) minimises the diagonal count;
    'natural' keeps the input order."""
    dev = resolve_device(device)
    dtype = np.dtype(config.dtype)
    n = A.shape[0]
    if order == "rcm":
        perm = rcm_permutation(A)
    elif order == "natural":
        perm = np.arange(n, dtype=np.int64)
    else:
        raise ValueError(f"unknown order {order!r}")
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)

    coo = A.tocoo()
    # weights use ORIGINAL ids (coordinates/velocities are not permuted);
    # csr_edge_weights is pull-form: weight of edge col -> row
    w = csr_edge_weights(gr, coo.row, coo.col, U).astype(dtype)
    rows = iperm[coo.row]
    cols = iperm[coo.col]

    off = cols - rows
    offsets = np.unique(off)
    m = len(offsets)
    mc = _round_up(max(m, 1), CHUNK) // CHUNK
    n_pad = _round_up(n, 512)

    offs = np.zeros((mc * CHUNK,), dtype=np.int32)
    offs[:m] = offsets
    W = np.full((mc * CHUNK, n_pad), np.inf, dtype=dtype)
    oidx = np.searchsorted(offsets, off)
    W[oidx, rows] = w

    halo = np.asarray(halo)
    hsrc, hdst = pad_halo(iperm[halo] if halo.size else halo)

    return banded_graph(offs.reshape(mc, CHUNK), W.reshape(mc, CHUNK, n_pad),
                        hsrc, hdst, perm, iperm, n, n_pad, offsets, dev)


# ----------------------------------------------------------------------
# the plain twins
# ----------------------------------------------------------------------

def banded_sweep_reference(dist0: torch.Tensor, offsets_np: np.ndarray,
                           W: torch.Tensor) -> torch.Tensor:
    """One full relaxation sweep: min over all diagonals of
    roll(dist0, -o) + W[o], for dist0 (S, n_pad), W (mc, C, n_pad) and
    the m real offsets (0-padded to mc*C, as the packed `offs`); the JAX
    package's `_banded_sweep`, the C rolls of a chunk taken as one gather
    from the wrap-extended field."""
    n_pad = dist0.shape[-1]
    ext = torch.cat([dist0, dist0], dim=-1)
    ar = torch.arange(n_pad, device=dist0.device)
    offs = np.zeros(W.shape[0] * W.shape[1], dtype=np.int64)
    offs[: len(offsets_np)] = offsets_np
    acc = dist0
    for c, o_chunk in enumerate(offs.reshape(W.shape[0], W.shape[1])):
        start = torch.as_tensor(np.remainder(o_chunk, n_pad),
                                device=dist0.device)
        win = ext[:, start[:, None] + ar]               # (S, C, n_pad)
        acc = torch.minimum(acc, (win + W[c]).amin(dim=1))
    return acc


def _merge(d: torch.Tensor, halo_src, halo_dst) -> torch.Tensor:
    """Twin min-merge: every source read before any write."""
    return d.scatter_reduce(1, halo_dst.long().expand(d.shape[0], -1),
                            d[:, halo_src.long()], "amin", include_self=True)


class BandedState(NamedTuple):
    dist: torch.Tensor      # (S, n_pad) in permuted order
    changed: torch.Tensor   # () int32, 1 while the last iteration improved
    it: torch.Tensor        # () int32


def banded_step_reference(s: BandedState, bg: BandedGraph,
                          max_iters: Optional[int] = None) -> BandedState:
    """One Jacobi iteration, plain torch (the body of the JAX package's
    `_solve_banded_jit`); the state unchanged when the last iteration
    changed nothing or `it` has reached max_iters."""
    cap = _INT32_MAX if max_iters is None else max_iters
    changed, it = torch.stack([s.changed, s.it]).tolist()
    if not changed or it >= cap:
        return s
    acc = banded_sweep_reference(s.dist, bg.offsets_np,
                                 bg.W.to(s.dist.device))
    dist = torch.minimum(s.dist, acc)
    # twin min-merge; padded rows are (0, 0) self-merges, harmless
    dist = _merge(dist, bg.halo_src, bg.halo_dst)
    return BandedState(dist=dist,
                       changed=(dist < s.dist).any().to(torch.int32),
                       it=s.it + 1)


def _gs_block(n_pad: int, block: int) -> int:
    B = block
    while n_pad % B:
        B //= 2
    return B


def banded_gs_reference(dist: torch.Tensor, bg: BandedGraph, forward: bool,
                        block: int = 512, passes: int = 2) -> torch.Tensor:
    """One direction of the Gauss-Seidel block sweep and the halo merge,
    plain torch (`_solve_banded_gs_jit`'s `sweep` then `merge`): blocks
    of B rows in order (ascending when forward), P passes a block, each
    pass a Jacobi update of the block over all taps reading the block's
    rows as they stood at the pass's start and the rows outside as they
    stood when the block began; the taps of a pass are taken as one
    gather from the window."""
    offsets = bg.offsets_np
    m = len(offsets)
    S, n_pad = dist.shape
    B = _gs_block(n_pad, block)
    NB = n_pad // B
    K = max(int(np.abs(offsets).max()) if m else 1, 1)
    dev = dist.device
    W2 = bg.W.to(dev).reshape(-1, n_pad)[:m]
    buf = torch.nn.functional.pad(dist, (K, K), value=float("inf"))
    idx = torch.as_tensor(K + offsets, device=dev)[:, None] + torch.arange(
        B, device=dev)                                   # (m, B)
    for g in range(NB):
        b = g * B if forward else (NB - 1 - g) * B
        win = buf[:, b: b + B + 2 * K]
        wblk = W2[:, b: b + B]
        cur = win[:, K: K + B]
        for _ in range(passes):
            ext = torch.cat([win[:, :K], cur, win[:, K + B:]], dim=1)
            cur = torch.minimum(cur, (ext[:, idx] + wblk).amin(dim=1))
        buf = torch.cat([buf[:, : b + K], cur, buf[:, b + K + B:]], dim=1)
    return _merge(buf[:, K: K + n_pad], bg.halo_src, bg.halo_dst)


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------

def _banded_lib() -> ctypes.CDLL:
    lib = kernels.load("banded")
    if lib.banded_jacobi_launch.argtypes is None:
        lib.banded_jacobi_launch.restype = ctypes.c_int
        lib.banded_jacobi_launch.argtypes = (
            [ctypes.c_void_p] * 19 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.banded_gs_launch.restype = ctypes.c_int
        lib.banded_gs_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.banded_gs_window_launch.restype = ctypes.c_int
        lib.banded_gs_window_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    return lib


def _check_field(d: torch.Tensor, bg: BandedGraph, name: str) -> bool:
    """True for a CUDA field the kernel takes, False for a CPU one; raises
    otherwise."""
    if d.device != bg.tw.device or d.dtype != bg.tw.dtype:
        raise ValueError(f"field ({d.device}, {d.dtype}) and weights "
                         f"({bg.tw.device}, {bg.tw.dtype}) differ")
    if d.dim() != 2 or d.shape[1] != bg.n_pad:
        raise ValueError(f"field must be (S, {bg.n_pad}), got "
                         f"{tuple(d.shape)}")
    if d.device.type == "cpu":
        return False
    if d.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {d.device}")
    kernels.require_float(name, d.dtype)
    return True


# ----------------------------------------------------------------------
# banded_sweep: many Jacobi iterations a launch
# ----------------------------------------------------------------------

JACOBI_MIN_ROWS = 32
JACOBI_MAX_WINDOW = 65536       # uint16 window slots


class JacobiPlan(NamedTuple):
    """A banded_sweep launch: `route` "shared" (each of `blocks` blocks
    owns R rows, a multiple of 32, a thread slot each, and holds their
    taps, nmax tap slots, and its window of the field, S x Wmax values,
    in `smem` bytes of shared memory) or "global" (`blocks` blocks stride
    over the (field, row) items and read the taps and the field from
    L2)."""

    route: str
    blocks: int
    smem: int
    R: int = 0
    nmax: int = 0
    Wmax: int = 0


def jacobi_smem(S: int, Wmax: int, R: int, nmax: int,
                itemsize: int) -> int:
    """csrc/banded.cu JacobiSmem: the window (S x Wmax values), the slots'
    metadata (R int2), the weights and the uint16 window slots (nmax
    each), each region a multiple of 16 bytes."""
    return (_align16(S * Wmax * itemsize) + _align16(8 * R)
            + _align16(nmax * itemsize) + _align16(2 * nmax))


def _jacobi_shape(toff: np.ndarray, tcol: np.ndarray, n_pad: int, R: int):
    """Blocks of R rows over [0, n_pad): (blocks, order, width, goff,
    nmax, lo, hi) - `_gs_shape` of the rows padded to blocks x R with
    empty rows, and each block's window [lo, hi): its own rows and every
    row its taps read."""
    toff = np.asarray(toff, dtype=np.int64)
    G = -(-n_pad // R)
    toff_p = np.concatenate([toff, np.full(G * R - n_pad, toff[-1])])
    order, width, goff, nmax = _gs_shape(toff_p, G * R, R)
    lo = np.arange(G, dtype=np.int64) * R
    hi = np.minimum(lo + R, n_pad)
    deg = np.diff(toff)
    if len(tcol):
        b = np.repeat(np.arange(n_pad), deg) // R
        tc = np.asarray(tcol, dtype=np.int64)
        np.minimum.at(lo, b, tc)
        np.maximum.at(hi, b, tc + 1)
    return G, order, width, goff, nmax, lo, hi


def jacobi_plan(toff, tcol, n_pad: int, S: int, itemsize: int,
                sms: int = H100_SMS) -> JacobiPlan:
    """The route of a banded_sweep launch from the shapes alone: the
    shared route, one block of 512 threads an SM (the rows split evenly,
    at least 32 a block, a multiple of 32), where a block's taps and its
    window of the S fields fit its shared memory (and the window uint16
    slots); else the global route.  Never raises for size."""
    toff = np.asarray(toff.cpu() if torch.is_tensor(toff) else toff)
    tcol = np.asarray(tcol.cpu() if torch.is_tensor(tcol) else tcol)
    R = _round_up(max(-(-n_pad // sms), JACOBI_MIN_ROWS), 32)
    G, _, width, _, nmax, lo, hi = _jacobi_shape(toff, tcol, n_pad, R)
    Wmax = int((hi - lo).max())
    smem = jacobi_smem(S, Wmax, R, nmax, itemsize)
    if (Wmax <= JACOBI_MAX_WINDOW and nmax < GS_MAX_START
            and int(width.max(initial=0)) < GS_MAX_WIDTH
            and smem <= BLOCK_SMEM):
        return JacobiPlan("shared", G, smem, R, nmax, Wmax)
    return JacobiPlan("global", sms, 0)


class JacobiLayout(NamedTuple):
    """banded_sweep's shared-route layout (`jacobi_layout`): block b owns
    rows [b R, b R + R) (the last one fewer), sorted by tap count onto
    R thread slots as `GsLayout`'s blocks are; tap k of slot t at
    blk[b] + start[b, t] + 32 k.
      meta : (blocks, R, 2) int32: the slot's row in the block (-1:
             none), and start | width << 20
      idx  : (total,) uint16 bits (int16 storage) the source row's slot in
             the block's window, row - win[b, 0]; padding: the slot's own
             row's, with weight +inf
      w    : (total,) the weights
      blk  : (blocks + 1,) int32 the blocks' tap starts
      win  : (blocks, 2) int32 the window rows [lo, hi)"""

    meta: torch.Tensor
    idx: torch.Tensor
    w: torch.Tensor
    blk: torch.Tensor
    win: torch.Tensor
    plan: JacobiPlan


def jacobi_layout(toff, tcol, tw, n_pad: int, S: int, itemsize: int,
                  device, sms: int = H100_SMS):
    """banded_sweep's layout of S fields (see `JacobiLayout`) from the tap
    lists (host arrays or tensors), on `device`, with its plan from
    `jacobi_plan`; on the global route that JacobiPlan alone."""
    toff, tcol, tw = (np.asarray(a.cpu() if torch.is_tensor(a) else a)
                      for a in (toff, tcol, tw))
    plan = jacobi_plan(toff, tcol, n_pad, S, itemsize, sms)
    if plan.route != "shared":
        return plan
    R = plan.R
    G, order, width, goff, _, lo, hi = _jacobi_shape(toff, tcol, n_pad, R)
    Gn = R // 32
    counts = 32 * width                                    # (G, Gn)
    blk = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(counts.sum(axis=1), out=blk[1:])
    total = int(blk[-1])
    rows = np.arange(G)[:, None] * R + order               # global rows
    real = rows < n_pad
    # every slot position: (block, group, lane, k); padding first
    gstart = (blk[:-1, None] + goff).reshape(-1)
    n_of = counts.reshape(-1)
    gid = np.repeat(np.arange(G * Gn), n_of)
    q = np.arange(total) - np.repeat(gstart, n_of)
    rb = gid // Gn
    t = (gid % Gn) * 32 + q % 32
    idx = (rows[rb, t] - lo[rb]).astype(np.uint16)
    w = np.full(total, np.inf, dtype=tw.dtype)
    # the real taps: tap k of row r at its slot's position
    deg = np.diff(toff.astype(np.int64))
    r = np.repeat(np.arange(n_pad), deg)
    k = np.arange(len(tcol)) - np.repeat(toff[:-1].astype(np.int64), deg)
    slot_of = np.empty((G, R), dtype=np.int64)
    np.put_along_axis(slot_of, order, np.arange(R)[None, :], axis=1)
    rbt, lr = r // R, r % R
    ts = slot_of[rbt, lr]
    pos = blk[rbt] + goff[rbt, ts // 32] + ts % 32 + 32 * k
    idx[pos] = (np.asarray(tcol, dtype=np.int64) - lo[rbt]).astype(np.uint16)
    w[pos] = tw
    meta = np.zeros((G, R, 2), dtype=np.int32)
    meta[..., 0] = np.where(real, order, -1)
    lane = np.arange(R) % 32
    meta[..., 1] = (goff[:, np.arange(R) // 32] + lane[None, :]) \
        | (width[:, np.arange(R) // 32] << 20)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return JacobiLayout(meta=dev(meta), idx=dev(idx.view(np.int16)),
                        w=dev(w), blk=dev(blk.astype(np.int32)),
                        win=dev(np.stack([lo, hi], 1).astype(np.int32)),
                        plan=plan)


def _jacobi_route(bg: BandedGraph, S: int):
    """The plan of a launch on S fields of bg (a JacobiLayout for the
    shared route, built once and kept in bg.jacobi; a JacobiPlan for the
    global route)."""
    key = (S, str(bg.tw.dtype))
    got = bg.jacobi.get(key)
    if got is None:
        sms = torch.cuda.get_device_properties(
            bg.tw.device).multi_processor_count
        got = jacobi_layout(bg.toff, bg.tcol, bg.tw, bg.n_pad, S,
                            bg.tw.element_size(), bg.tw.device, sms)
        bg.jacobi[key] = got
    return got


def banded_step(s: BandedState, bg: BandedGraph,
                max_iters: Optional[int] = None,
                count: int = 1) -> BandedState:
    """Up to `count` Jacobi iterations of the banded solve (fewer where
    the field stops changing or `it` reaches max_iters, the JAX package's
    loop rule); returns a new state, the input untouched.  A CUDA field
    (float32 or float64) goes to the hand-written kernel `banded_sweep`
    of `csrc/banded.cu`: one cooperative launch that runs the iterations
    with a grid sync between them, on the route `jacobi_plan` picks from
    the shapes (`banded_step.launches` counts the launches).  A CPU
    field goes to `count` calls of `banded_step_reference`.  Any other
    device raises."""
    if count < 1:
        raise ValueError(f"count must be >= 1, got {count}")
    d = s.dist
    if not _check_field(d, bg, "banded_sweep"):
        for _ in range(count):
            nxt = banded_step_reference(s, bg, max_iters)
            if nxt is s:
                break
            s = nxt
        return s
    d = d.contiguous()
    S = d.shape[0]
    route = _jacobi_route(bg, S)
    out = torch.empty_like(d)
    tmp = torch.empty_like(d) if count > 1 else out
    it_in = s.it.to(torch.int32).contiguous()
    ch_in = s.changed.to(torch.int32).contiguous()
    it_out = torch.empty((), dtype=torch.int32, device=d.device)
    ch_out = torch.empty((), dtype=torch.int32, device=d.device)
    flags = torch.zeros(3, dtype=torch.int32, device=d.device)
    cap = _INT32_MAX if max_iters is None else int(max_iters)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    if isinstance(route, JacobiLayout):
        p = route.plan
        lay = [route.meta.data_ptr(), route.idx.data_ptr(),
               route.w.data_ptr(), route.blk.data_ptr(), route.win.data_ptr()]
    else:
        p = route
        lay = [None] * 5
    rc = _banded_lib().banded_jacobi_launch(
        d.data_ptr(), out.data_ptr(), tmp.data_ptr(), bg.toff.data_ptr(),
        bg.tcol.data_ptr(), bg.tw.data_ptr(), bg.didx.data_ptr(),
        bg.hoff.data_ptr(), bg.hsrc.data_ptr(), *lay, it_in.data_ptr(),
        ch_in.data_ptr(), it_out.data_ptr(), ch_out.data_ptr(),
        flags.data_ptr(), S, bg.n_pad, cap, int(min(count, _INT32_MAX)),
        int(p.route == "shared"), p.blocks, p.R, p.nmax, p.Wmax,
        p.smem, int(d.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"banded_sweep kernel launch failed: CUDA error "
                           f"{rc}")
    banded_step.launches += 1
    return BandedState(dist=out, changed=ch_out, it=it_out)


banded_step.launches = 0


def gs_smem_bytes(B: int, itemsize: int) -> int:
    """Shared memory of a wide-band banded_gs block that keeps its rows
    there: the block's rows twice (the pass's snapshot and its result).
    Raises over an H100 block's shared memory (the route then keeps them
    in global memory)."""
    smem = 2 * B * itemsize
    if smem > BLOCK_SMEM:
        raise ValueError(f"a banded_gs block of {B} rows needs {smem} bytes "
                         f"of shared memory: over the {BLOCK_SMEM} bytes an "
                         f"H100 block may have")
    return smem


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


# the window route's int16 ring slots and the metadata's packing of a
# group's first slot (20 bits) and width (11 bits)
GS_MAX_RING = 32768
GS_MAX_START = 1 << 20
GS_MAX_WIDTH = 1 << 11


class GsPlan(NamedTuple):
    """One banded_gs direction: `route` "window" (K the band's reach, a
    ring of Wr rows, 2K + 2B rounded up to a power of 2, G32 thread slots
    a block, nmax the most
    tap slots a block holds) or "wide"; `threads` a block and `smem`
    bytes of dynamic shared memory (0 on the wide route when the block's
    rows go to global memory)."""

    route: str
    threads: int
    smem: int
    K: int = 0
    Wr: int = 0
    G32: int = 0
    nmax: int = 0


def gs_window_smem(Wr: int, B: int, G32: int, nmax: int,
                   itemsize: int) -> int:
    """csrc/banded.cu GsSmem: the ring, the pass's new values and two tap
    buffers (per-slot metadata, weights, int16 ring slots), each region a
    multiple of 16 bytes."""
    buf = _align16(8 * G32 + nmax * itemsize + 2 * nmax)
    return _align16(Wr * itemsize) + _align16(B * itemsize) + 2 * buf


def _gs_threads(rows: int) -> int:
    return 1024 if rows >= 1024 else (rows + 31) // 32 * 32


def gs_plan(B: int, K: int, nmax: int, width: int,
            itemsize: int) -> GsPlan:
    """The route of a banded_gs direction from the shapes alone: blocks of
    B rows, the band's reach K, the most tap slots a block's layout holds
    (nmax) and its widest group (width).  The window route where its ring
    (2K + 2B rows rounded up to a power of 2) fits int16 slots and the
    whole of it an H100 block's shared memory;
    else the wide-band route, its rows in shared memory where 2 B values
    fit and in global memory where they do not.  Never raises for size."""
    K = max(int(K), 1)
    Wr = 1 << (2 * K + 2 * B - 1).bit_length()
    G32 = -(-B // 32) * 32
    if Wr <= GS_MAX_RING and nmax < GS_MAX_START and width < GS_MAX_WIDTH:
        smem = gs_window_smem(Wr, B, G32, nmax, itemsize)
        if smem <= BLOCK_SMEM:
            return GsPlan("window", _gs_threads(G32), smem, K, Wr, G32, nmax)
    try:
        smem = gs_smem_bytes(B, itemsize)
    except ValueError:
        smem = 0    # the block's rows in global memory
    return GsPlan("wide", _gs_threads(B), smem)


class GsLayout(NamedTuple):
    """banded_gs's window layout of one block size B (`gs_layout`): the
    row blocks' taps, each block's rows sorted by tap count (descending,
    ties by row) onto G32 thread slots, 32 slots a group padded to the
    group's most taps; tap k of slot t (group t // 32, lane t % 32) at
    blk[rb] + start[rb, t] + 32 k.
      meta : (NB, G32, 2) int32: the slot's row in the block (-1: none),
             and start | width << 20 (width: its group's most taps)
      idx  : (total,) int16 the source row's ring slot (row mod Wr, Wr a
             power of 2);
             padding: the slot's own row's, with weight +inf
      w    : (total,) the weights
      blk  : (NB + 1,) int32 block starts, multiples of 32"""

    meta: torch.Tensor
    idx: torch.Tensor
    w: torch.Tensor
    blk: torch.Tensor
    plan: GsPlan


def _gs_shape(toff: np.ndarray, n_pad: int, B: int):
    """(order, width, goff, nmax): each block's rows by tap count
    (NB, G32; -1 past B), each group's width (NB, G), its first slot in
    the block (NB, G) and the most slots a block holds."""
    deg = np.diff(np.asarray(toff, dtype=np.int64))
    NB, G = n_pad // B, -(-B // 32)
    db = deg.reshape(NB, B)
    order = np.full((NB, G * 32), -1, dtype=np.int64)
    order[:, :B] = np.argsort(-db, axis=1, kind="stable")
    ds = np.zeros((NB, G * 32), dtype=np.int64)
    ds[:, :B] = np.take_along_axis(db, order[:, :B], axis=1)
    width = ds.reshape(NB, G, 32).max(axis=2)
    goff = np.zeros((NB, G), dtype=np.int64)
    np.cumsum(32 * width[:, :-1], axis=1, out=goff[:, 1:])
    nmax = int((32 * width).sum(axis=1).max()) if NB else 0
    return order, width, goff, nmax


def gs_layout(toff, tcol, tw, n_pad: int, B: int, K: int, itemsize: int,
              device):
    """The window layout of banded_gs for blocks of B rows (see
    `GsLayout`), from the tap lists (host arrays or tensors), on
    `device`, with its plan from `gs_plan`; where the shapes take the
    wide-band route, that GsPlan alone (the route needs no layout)."""
    toff, tcol, tw = (np.asarray(a.cpu() if torch.is_tensor(a) else a)
                      for a in (toff, tcol, tw))
    order, width, goff, nmax = _gs_shape(toff, n_pad, B)
    plan = gs_plan(B, K, nmax, int(width.max(initial=0)), itemsize)
    if plan.route != "window":
        return plan
    NB, G32, Wr = n_pad // B, plan.G32, plan.Wr
    G = G32 // 32
    counts = 32 * width                                    # (NB, G)
    blk = np.zeros(NB + 1, dtype=np.int64)
    np.cumsum(counts.sum(axis=1), out=blk[1:])
    total = int(blk[-1])
    # every slot position: (block, group, lane, k); padding first
    gstart = (blk[:-1, None] + goff).reshape(-1)
    n_of = counts.reshape(-1)
    gid = np.repeat(np.arange(NB * G), n_of)
    q = np.arange(total) - np.repeat(gstart, n_of)
    rb = gid // G
    t = (gid % G) * 32 + q % 32
    row = order[rb, t]
    own = np.where(row >= 0, (rb * B + np.maximum(row, 0)) % Wr, 0)
    idx = own.astype(np.int16)
    w = np.full(total, np.inf, dtype=np.asarray(tw).dtype)
    # the real taps: tap k of row r at its slot's position
    deg = np.diff(toff.astype(np.int64))
    r = np.repeat(np.arange(n_pad), deg)
    k = np.arange(len(tcol)) - np.repeat(toff[:-1].astype(np.int64), deg)
    slot_of = np.empty((NB, B), dtype=np.int64)
    np.put_along_axis(slot_of, order[:, :B], np.arange(B)[None, :], axis=1)
    rbt, lr = r // B, r % B
    ts = slot_of[rbt, lr]
    pos = blk[rbt] + goff[rbt, ts // 32] + ts % 32 + 32 * k
    idx[pos] = (np.asarray(tcol, dtype=np.int64) % Wr).astype(np.int16)
    w[pos] = tw
    meta = np.zeros((NB, G32, 2), dtype=np.int32)
    meta[..., 0] = order
    lane = np.arange(G32) % 32
    start = goff[:, np.arange(G32) // 32] + lane[None, :]
    meta[..., 1] = start | (width[:, np.arange(G32) // 32] << 20)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GsLayout(meta=dev(meta), idx=dev(idx), w=dev(w),
                    blk=dev(blk.astype(np.int32)), plan=plan)


def _gs_reach(bg: BandedGraph) -> int:
    o = bg.offsets_np
    return max(int(np.abs(o).max()) if len(o) else 1, 1)


def _gs_route(bg: BandedGraph, B: int):
    """The plan of a direction in blocks of B rows on bg (a GsLayout for
    the window route, built once and kept in bg.gs; a GsPlan for the
    wide-band route)."""
    key = (B, str(bg.tw.dtype))
    got = bg.gs.get(key)
    if got is None:
        got = gs_layout(bg.toff, bg.tcol, bg.tw, bg.n_pad, B, _gs_reach(bg),
                        bg.tw.element_size(), bg.tw.device)
        bg.gs[key] = got
    return got


def banded_gs(dist: torch.Tensor, bg: BandedGraph, forward: bool,
              block: int = 512, passes: int = 2) -> torch.Tensor:
    """One Gauss-Seidel direction of the banded solve (blocks ascending
    when `forward`, descending otherwise) and the halo merge, on a
    (S, n_pad) field in permuted order; returns a new field, the input
    untouched.  A CUDA field (float32 or float64) goes to the hand-written
    kernel `banded_gs` of `csrc/banded.cu`, one block of threads a source
    marching the row blocks, on the route `gs_plan` picks from the
    shapes: the window route (the ring of rows the block's taps reach
    and its taps, streamed one block ahead, in shared memory) or the
    wide-band route (rows out of the block from global memory); then a
    copy with the halo min (`banded_gs.launches` counts the calls).  A
    CPU field goes to `banded_gs_reference`.  Any other device raises."""
    if not _check_field(dist, bg, "banded_gs"):
        return banded_gs_reference(dist, bg, forward, block, passes)
    d = dist.contiguous()
    S, n_pad = d.shape
    B = _gs_block(n_pad, block)
    route = _gs_route(bg, B)
    n_dest = int(bg.hoff.shape[0]) - 1
    out = torch.empty_like(d)
    tmp = torch.empty_like(d) if n_dest > 0 else out
    stream = torch.cuda.current_stream(d.device).cuda_stream
    is_double = int(d.dtype == torch.float64)
    if isinstance(route, GsLayout):
        p = route.plan
        rc = _banded_lib().banded_gs_window_launch(
            d.data_ptr(), tmp.data_ptr(), out.data_ptr(),
            route.meta.data_ptr(), route.idx.data_ptr(), route.w.data_ptr(),
            route.blk.data_ptr(), bg.didx.data_ptr(), bg.hoff.data_ptr(),
            bg.hsrc.data_ptr(), n_dest, S, n_pad, B, passes, int(forward),
            p.K, p.Wr, p.G32, p.nmax, p.smem, is_double, stream)
    else:
        gbuf = (torch.empty((S, 2, B), dtype=d.dtype, device=d.device)
                if route.smem == 0 else None)
        rc = _banded_lib().banded_gs_launch(
            d.data_ptr(), tmp.data_ptr(), out.data_ptr(), bg.toff.data_ptr(),
            bg.tcol.data_ptr(), bg.tw.data_ptr(), bg.didx.data_ptr(),
            bg.hoff.data_ptr(), bg.hsrc.data_ptr(),
            None if gbuf is None else gbuf.data_ptr(), n_dest, S, n_pad, B,
            passes, int(forward), route.smem, is_double, stream)
    if rc != 0:
        raise RuntimeError(f"banded_gs kernel launch failed: CUDA error {rc}")
    banded_gs.launches += 1
    return out


banded_gs.launches = 0


# ----------------------------------------------------------------------
# the solves
# ----------------------------------------------------------------------

def _sources(bg: BandedGraph, sources, config: SolverConfig):
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    dtype = getattr(torch, np.dtype(config.dtype).name)
    if bg.tw.dtype != dtype:
        raise ValueError(f"weights are {bg.tw.dtype}, config.dtype is "
                         f"{np.dtype(config.dtype).name}")
    dev = bg.tw.device
    src_p = torch.as_tensor(bg.iperm[sources], device=dev)
    S = len(sources)
    dist = torch.full((S, bg.n_pad), float("inf"), dtype=dtype, device=dev)
    dist[torch.arange(S, device=dev), src_p] = 0
    return dist


def _unpermute(bg: BandedGraph, dist: torch.Tensor) -> np.ndarray:
    return dist[:, torch.as_tensor(bg.iperm, device=dist.device)].cpu().numpy()


def solve_banded(
    bg: BandedGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
) -> Tuple[np.ndarray, int]:
    """(S, n) distance fields in ORIGINAL node order + iteration count.

    Exact fixpoint: iterate while any distance strictly improves.  The
    whole solve is one `banded_step` call (on the card one launch of
    banded_sweep), then one host read."""
    one = torch.ones((), dtype=torch.int32, device=bg.tw.device)
    s = BandedState(dist=_sources(bg, sources, config), changed=one,
                    it=torch.zeros_like(one))
    s = banded_step(s, bg, config.max_iters, max(config.max_iters, 1))
    return _unpermute(bg, s.dist), int(s.it)


def solve_banded_gs(
    bg: BandedGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    block: int = 512,
    passes: int = 2,
) -> Tuple[np.ndarray, int]:
    """Directional (Gauss-Seidel) banded solve: the field of solve_banded
    in far fewer sweeps.  `iters` counts fwd+bwd rounds; the host reads
    the changed flag once a round."""
    dist = _sources(bg, sources, config)
    it = 0
    while it < config.max_iters:
        d = banded_gs(dist, bg, True, block, passes)
        d = banded_gs(d, bg, False, block, passes)
        it += 1
        changed = bool((d < dist).any())
        dist = d
        if not changed:
            break
    return _unpermute(bg, dist), it
