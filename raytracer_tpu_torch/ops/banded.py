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
  * `banded_step` (kernel `banded_sweep`): one Jacobi iteration of the
    JAX package's `_solve_banded_jit` body, the sweep, the halo
    scatter-min (every source read before any write) and the changed
    flag, with `it` and the flag kept on the device; an iteration after
    the field stops changing, or at max_iters, changes nothing, so the
    loop reads the host every `CHECK_EVERY` iterations.  Each candidate
    is one add and the min is exact, so the kernel's walk over the finite
    taps gives the floats of the twin's dense rolls.
  * `banded_gs` (kernel `banded_gs`): one direction of
    `_solve_banded_gs_jit`'s `sweep`, blocks of B rows strictly in order
    with P passes a block (a pass reads the block's own rows as they
    stood at its start, the rows outside as they stood when the block
    began), then the halo merge.
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
from .relax import _INT32_MAX, CHECK_EVERY

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
    return BandedGraph(offs=t(offs), W=torch.from_numpy(W), halo_src=t(hs),
                       halo_dst=t(hd),
                       perm=np.asarray(perm, dtype=np.int64),
                       iperm=np.asarray(iperm, dtype=np.int64), n=int(n),
                       n_pad=int(n_pad),
                       offsets_np=np.asarray(offsets_np, dtype=np.int64),
                       toff=t(toff), tcol=t(tcol), tw=t(tw), didx=t(didx),
                       hoff=t(hoff), hsrc=t(hsrc))


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
    if lib.banded_sweep_launch.argtypes is None:
        lib.banded_sweep_launch.restype = ctypes.c_int
        lib.banded_sweep_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.banded_gs_launch.restype = ctypes.c_int
        lib.banded_gs_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
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


def banded_step(s: BandedState, bg: BandedGraph,
                max_iters: Optional[int] = None) -> BandedState:
    """One Jacobi iteration of the banded solve; returns a new state, the
    input untouched.  A CUDA field (float32 or float64) goes to the
    hand-written kernel `banded_sweep` of `csrc/banded.cu` (one launch: a
    thread a (source, row) over the row's finite taps, a halo
    destination's thread also sweeping its sources; `it` and `changed`
    on the device; `banded_step.launches` counts the calls), a CPU field
    to `banded_step_reference`.  Any other device raises."""
    d = s.dist
    if not _check_field(d, bg, "banded_sweep"):
        return banded_step_reference(s, bg, max_iters)
    d = d.contiguous()
    out = torch.empty_like(d)
    it_in = s.it.to(torch.int32).contiguous()
    ch_in = s.changed.to(torch.int32).contiguous()
    it_out = torch.empty((), dtype=torch.int32, device=d.device)
    ch_out = torch.zeros((), dtype=torch.int32, device=d.device)
    cap = _INT32_MAX if max_iters is None else int(max_iters)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = _banded_lib().banded_sweep_launch(
        d.data_ptr(), out.data_ptr(), bg.toff.data_ptr(),
        bg.tcol.data_ptr(), bg.tw.data_ptr(), bg.didx.data_ptr(),
        bg.hoff.data_ptr(), bg.hsrc.data_ptr(), it_in.data_ptr(),
        ch_in.data_ptr(), it_out.data_ptr(), ch_out.data_ptr(),
        d.shape[0], bg.n_pad, cap, int(d.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"banded_sweep kernel launch failed: CUDA error "
                           f"{rc}")
    banded_step.launches += 1
    return BandedState(dist=out, changed=ch_out, it=it_out)


banded_step.launches = 0


def gs_smem_bytes(B: int, itemsize: int) -> int:
    """Shared memory of a banded_gs block: the block's rows twice (the
    pass's snapshot and its result)."""
    smem = 2 * B * itemsize
    if smem > BLOCK_SMEM:
        raise ValueError(f"a banded_gs block of {B} rows needs {smem} bytes "
                         f"of shared memory: over the {BLOCK_SMEM} bytes an "
                         f"H100 block may have")
    return smem


def banded_gs(dist: torch.Tensor, bg: BandedGraph, forward: bool,
              block: int = 512, passes: int = 2) -> torch.Tensor:
    """One Gauss-Seidel direction of the banded solve (blocks ascending
    when `forward`, descending otherwise) and the halo merge, on a
    (S, n_pad) field in permuted order; returns a new field, the input
    untouched.  A CUDA field (float32 or float64) goes to the hand-written
    kernel `banded_gs` of `csrc/banded.cu` (one block of threads a source
    marching the row blocks, the block's rows double-buffered in shared
    memory, then a copy with the halo min; `banded_gs.launches` counts
    the calls), a CPU field to `banded_gs_reference`.  Any other device
    raises."""
    if not _check_field(dist, bg, "banded_gs"):
        return banded_gs_reference(dist, bg, forward, block, passes)
    d = dist.contiguous()
    S, n_pad = d.shape
    B = _gs_block(n_pad, block)
    smem = gs_smem_bytes(B, d.element_size())
    n_dest = int(bg.hoff.shape[0]) - 1
    out = torch.empty_like(d)
    tmp = torch.empty_like(d) if n_dest > 0 else out
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = _banded_lib().banded_gs_launch(
        d.data_ptr(), tmp.data_ptr(), out.data_ptr(), bg.toff.data_ptr(),
        bg.tcol.data_ptr(), bg.tw.data_ptr(), bg.didx.data_ptr(),
        bg.hoff.data_ptr(), bg.hsrc.data_ptr(), n_dest, S, n_pad, B,
        passes, int(forward), smem, int(d.dtype == torch.float64), stream)
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

    Exact fixpoint: iterate while any distance strictly improves."""
    one = torch.ones((), dtype=torch.int32, device=bg.tw.device)
    s = BandedState(dist=_sources(bg, sources, config), changed=one,
                    it=torch.zeros_like(one))
    check = CHECK_EVERY if bg.tw.device.type == "cuda" else 1
    while True:
        for _ in range(check):
            s = banded_step(s, bg, config.max_iters)
        changed, it = torch.stack([s.changed, s.it]).tolist()
        if not changed or it >= config.max_iters:
            return _unpermute(bg, s.dist), it


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
