"""Theta-major full-iteration Jacobi engine ('twrapped'), PyTorch port.

Counterpart of `raytracer_tpu/ops/wrapped_t.py`.  The distance page is
stored THETA-MAJOR: row t of a source block holds theta (t mod nt), lane
m holds slot m, and the nt theta rows are padded to NTT (a multiple of
8) with dup = NTT - nt duplicate rows.  One Jacobi iteration is

    ring scan (theta, rows) -> chain scan (slots, lanes)
        -> moving-frame band sweep over (dm, dc in -2..2) + duplicate-row
           merge -> centre fan

and `titer` runs `iters` of them per call: on a CUDA tensor as the
hand-written kernel `csrc/titer.cu` (one launch function that enqueues
three kernels an iteration), on a CPU tensor as its plain twin
`titer_reference`, which follows the Pallas body op for op
(`titer_tiles_reference` replays the kernel's work partition).  The solve
loop calls it until no distance improves by more than
`SolverConfig.tol`, counting `sweeps_per_call` iterations per call as
the JAX package does.

The host table packing (`pack_twrapped_stencil`, the band closure) is
NumPy, a copy of the JAX package's; the sweep solver also packs its
tables from a closure-free `TWStencil`.

Exactness: every candidate is a real path cost, wrong reads are +inf
(pad lanes [Mp, ML) hold +inf in every cost table, so lane rolls that
wrap are self-masking), iterates decrease to the SSSP fixpoint.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..kernels import BLOCK_SMEM
from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..utils import profiling
from .circulant import CirculantGraph, _DC_RANGE, resolve_device
from .diag_circulant import LANES, SUB, _round_up, decompose_diagonals
from .diag_wrapped import (_chain_spans, _compose_vertical, _extract_cached,
                           _pipelined_chunk_solve, _pow2_below,
                           _window_costs)

RING_REPEAT = 16   # fixed span of the theta (row) scan after the statics
NDC = 2 * _DC_RANGE + 1


class TWStencil(NamedTuple):
    """Host-packed stencil for the theta-major kernel.

    wrows  : (R8, ML) weight rows; row 5*t + (dc+2) = weights of diagonal
             (dm = -maxdm + t, dc), +inf where the stencil has no such
             diagonal and on pad lanes [Mp, ML)
    ring_f/b : (1, ML) per-slot ring hop costs
    cfl/cbl  : (L, 1, ML) chain window costs (spans 1,2,..,CHAIN_REPEAT)
    fan_w    : (1, ML) centre<->slot fan weights
    """

    wrows: np.ndarray
    ring_f: np.ndarray
    ring_b: np.ndarray
    cfl: np.ndarray
    cbl: np.ndarray
    fan_w: np.ndarray
    maxdm: int
    Mp: int
    ML: int
    M: int
    nt: int
    NTT: int
    # per-stencil cache of packed tables and device-resident tensors
    # (keyed by table kind, receiver set and device)
    dcache: dict


def _compose_band(dms, dcs, wmat, pad_dm: int, levels: int):
    """Min-plus square the truncated band `levels` times.

    B'[dm, dc] = min(B[dm, dc], min over splits (B[dm1, dc1][m] +
    B[dm2, dc2][m + dm1])) truncated to |dm| <= pad_dm, |dc| <= _DC_RANGE.
    Every composed weight is a real 2-hop path cost, so relaxing with the
    closed band preserves the exact SSSP fixpoint while letting one sweep
    advance up to 2**levels original hops.  In the theta-major kernel the
    sweep already visits every (dm, dc) slot (absent ones are +inf
    no-ops), so the denser band costs NOTHING per sweep - the closure
    trades one-time host work for iteration count.
    """
    Mp = wmat.shape[1]
    n_dm = 2 * pad_dm + 1
    B = np.full((n_dm, NDC, Mp), np.inf)
    for d in range(len(dms)):
        i, j = int(dms[d]) + pad_dm, int(dcs[d]) + _DC_RANGE
        B[i, j] = np.minimum(B[i, j], wmat[d])
    ident = np.zeros(Mp)
    for _ in range(levels):
        out = B.copy()
        # identity terms: B composed with the zero-cost stay-put "hop"
        out[pad_dm, _DC_RANGE] = np.minimum(out[pad_dm, _DC_RANGE], ident)
        for i1 in range(n_dm):
            dm1 = i1 - pad_dm
            blk1 = B[i1]                       # (NDC, Mp)
            if not np.isfinite(blk1).any():
                continue
            # B2 shifted to the first hop's landing slot: m -> m + dm1
            sh = np.full_like(B, np.inf)
            if dm1 >= 0:
                sh[:, :, : Mp - dm1] = B[:, :, dm1:]
            else:
                sh[:, :, -dm1:] = B[:, :, : Mp + dm1]
            for j1 in range(NDC):
                w1 = blk1[j1]
                if not np.isfinite(w1).any():
                    continue
                dc1 = j1 - _DC_RANGE
                # (dm2, dc2) windows whose sum stays inside the truncation
                i2 = slice(max(0, -dm1), min(n_dm, n_dm - dm1))
                j2 = slice(max(0, -dc1), min(NDC, NDC - dc1))
                cand = w1[None, None, :] + sh[i2, j2]
                tgt = out[i2.start + dm1:i2.stop + dm1,
                          j2.start + dc1:j2.stop + dc1]
                np.minimum(tgt, cand, out=tgt)
        B = out
    dms2, dcs2, rows = [], [], []
    for i in range(n_dm):
        for j in range(NDC):
            if i == pad_dm and j == _DC_RANGE:
                continue  # identity slot
            if np.isfinite(B[i, j]).any():
                dms2.append(i - pad_dm)
                dcs2.append(j - _DC_RANGE)
                rows.append(B[i, j])
    return (np.asarray(dms2, dms.dtype), np.asarray(dcs2, dcs.dtype),
            np.stack(rows))


_VMEM_BUDGET = 100 * 1024 * 1024


def max_twrapped_batch(tw: "TWStencil",
                       limit_bytes: int = _VMEM_BUDGET) -> int:
    """Largest source block S whose monolithic kernel fits the TPU
    kernel's scoped VMEM limit (the JAX package's figure, kept as it is
    so that a grid takes the same engine in both packages).  The kernel
    materialises ~13 field-sized arrays of (S*NTT, ML).  0 means even
    S=1 does not fit: route to the streamed path (ops/stream_t.py)."""
    itemsize = np.dtype(tw.wrows.dtype).itemsize
    per_source = 13 * tw.NTT * tw.ML * itemsize
    fixed = tw.wrows.size * itemsize
    return max(0, int((limit_bytes - fixed) // per_source))


def supports_twrapped(cg: CirculantGraph) -> bool:
    """Same wrap condition as the slot-major kernel, on the 8-row cover:
    every defect row needs a defect-free twin."""
    nt = cg.ntheta
    NTT = _round_up(nt, SUB)
    dup = NTT - nt
    return nt >= SUB and (dup == 0 or dup >= _DC_RANGE)


def pack_twrapped_stencil(cg: CirculantGraph, dtype=np.float32,
                          vertical_closure: int = 0,
                          band_closure: int = 0) -> TWStencil:
    """Theta-major stencil tables; the sweep solver packs it with
    band_closure=0 and keeps its own tables in `dcache`."""
    dec = decompose_diagonals(cg)
    dms, dcs, wmat = dec.dms, dec.dcs, dec.wmat.copy()
    if vertical_closure:
        dms, dcs, wmat = _compose_vertical(dms, dcs, wmat, dec.pad,
                                           vertical_closure)
    if band_closure:
        dms, dcs, wmat = _compose_band(dms, dcs, wmat, dec.pad, band_closure)
    return pack_tables_from_decomp(dms, dcs, wmat, dec.Mp, dec.nt, dec.M,
                                   cg.fan_slots, cg.fan_w, dtype)


def pack_tables_from_decomp(dms, dcs, wmat, Mp: int, nt: int, M: int,
                            fan_slots, fan_w, dtype=np.float32) -> TWStencil:
    """Pack kernel tables from an explicit (dms, dcs, wmat) diagonal
    decomposition - the tail of pack_twrapped_stencil, split out so the
    streamed path's theta-coarsened warm-start stencils (which synthesise
    their own decompositions) share the exact same packing code."""
    NTT = _round_up(nt, SUB)
    maxdm = int(np.max(np.abs(dms)))
    ML = _round_up(Mp + maxdm + 1, LANES)

    # weight rows are stored in the band sweep's MOVING FRAME: the kernel
    # rolls the accumulator (not the 5-page stack) by one lane per trip,
    # so row (t, dc) holds w shifted to source-slot coordinates:
    # w_t[x] = w[x - dm] (dst m = x - dm reads src slot x = m + dm)
    R = (2 * maxdm + 1) * NDC
    wrows = np.full((_round_up(R, SUB), ML), np.inf)
    for d in range(len(dms)):
        dm, dc = int(dms[d]), int(dcs[d])
        if dc == 0 and abs(dm) <= 1:
            continue  # dm in {-1,0,+1}, dc=0 handled exactly by the chain scan
        t = dm + maxdm
        lo, hi = max(0, dm), min(Mp + dm, Mp)  # x range with x-dm in [0,Mp)
        row = wrows[t * NDC + (dc + _DC_RANGE)]
        row[lo:hi] = np.minimum(row[lo:hi], wmat[d][lo - dm:hi - dm])

    def _diag_vec(dm0: int, dc0: int) -> np.ndarray:
        hit = (dms == dm0) & (dcs == dc0)
        out = np.full(ML, np.inf)
        if hit.any():
            out[:Mp] = wmat[int(np.flatnonzero(hit)[0])]
        return out

    chain_f = _diag_vec(-1, 0)
    chain_f[0] = np.inf
    chain_b = _diag_vec(+1, 0)
    chain_b[Mp - 1] = np.inf
    chain_b[Mp:] = np.inf
    spans = _chain_spans(Mp)
    cfl = _window_costs(chain_f, spans)[:, None, :]
    cbl = _window_costs(chain_b[::-1], spans)[:, ::-1][:, None, :]

    fan_row = np.full((1, ML), np.inf)
    fan_row[0, fan_slots] = fan_w

    return TWStencil(
        wrows=wrows.astype(dtype),
        ring_f=_diag_vec(0, -1)[None, :].astype(dtype),
        ring_b=_diag_vec(0, +1)[None, :].astype(dtype),
        cfl=cfl.astype(dtype), cbl=cbl.astype(dtype),
        fan_w=fan_row.astype(dtype),
        maxdm=maxdm, Mp=Mp, ML=ML, M=M, nt=nt, NTT=NTT,
        dcache={},
    )


def _textract(dist: torch.Tensor, cen: torch.Tensor, it: int,
              m_idx, c_idx, center_mask, valid) -> torch.Tensor:
    """(S, k+1): node-ordered values gathered on the device from the
    (S, nt, ML) field, with the round count appended as the last column
    - one tensor, one copy to the host."""
    with profiling.span("extract", dist.device):
        S, nt, ML = dist.shape
        flat = dist.reshape(S, nt * ML)
        g = flat[:, c_idx * ML + m_idx]                      # (S, k)
        profiling.count(profiling.HOST_SYNCS)   # inf, a copy from host memory
        inf = torch.tensor(float("inf"), dtype=dist.dtype,
                           device=dist.device)
        g = torch.where(valid[None, :], g, inf)
        vals = torch.where(center_mask[None, :], cen[:, None], g)
        itcol = torch.full((S, 1), float(it), dtype=dist.dtype,
                           device=dist.device)
        return torch.cat([vals, itcol], dim=1)


# ----------------------------------------------------------------------
# T Jacobi iterations: CUDA kernel wrapper + plain twin
# ----------------------------------------------------------------------


class TWStatic(NamedTuple):
    """Static geometry of the theta-major kernel (the JAX `tw_static`)."""

    Mp: int
    ML: int
    NTT: int
    nt: int
    maxdm: int


class TWTables(NamedTuple):
    """The kernel's cost tables as tensors on one device."""

    wrows: torch.Tensor   # (R8, ML)
    ring_f: torch.Tensor  # (1, ML)
    ring_b: torch.Tensor  # (1, ML)
    cfl: torch.Tensor     # (L, 1, ML)
    cbl: torch.Tensor     # (L, 1, ML)
    fan_w: torch.Tensor   # (1, ML)


def _scan_plan(st: TWStatic):
    """(ring statics, n_ring, chain statics, chain repeat span, n_chain):
    the span schedule of the TPU kernel's ring and chain scans."""
    Mp, NTT = st.Mp, st.NTT
    ring_statics = tuple(s for s in _pow2_below(RING_REPEAT) if s < NTT)
    n_ring = (max(0, -(-(NTT - RING_REPEAT) // RING_REPEAT))
              if NTT > RING_REPEAT else 0)
    chain_all = _chain_spans(Mp)
    chain_statics, chain_rep = chain_all[:-1], chain_all[-1]
    n_chain = max(0, -(-(Mp - chain_rep) // chain_rep))
    return ring_statics, n_ring, chain_statics, chain_rep, n_chain


def _titer_scans(st: TWStatic, tbl: TWTables, rows: int, dtype, dev):
    """The ring and chain scans of one iteration of the (rows, ML) field,
    op for op the TPU kernel's (shared by both plain versions)."""
    Mp, ML, NTT, nt, maxdm = st
    ring_statics, n_ring, chain_statics, chain_rep, n_chain = _scan_plan(st)
    row = (torch.arange(rows, device=dev) % NTT)[:, None]
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    rf, rb = tbl.ring_f, tbl.ring_b
    cfl, cbl = tbl.cfl, tbl.cbl

    def ring_scan(v):
        # row t improves from row t-s (theta - s) at cost s*rf
        for s in ring_statics:
            cand = torch.roll(v, s, dims=0) + (s * rf)
            v = torch.minimum(v, torch.where(row < s, inf, cand))
        costF = RING_REPEAT * rf
        for _ in range(n_ring):
            cand = torch.roll(v, RING_REPEAT, dims=0) + costF
            v = torch.minimum(v, torch.where(row < RING_REPEAT, inf, cand))
        for s in ring_statics:
            cand = torch.roll(v, rows - s, dims=0) + (s * rb)
            v = torch.minimum(v, torch.where(row >= NTT - s, inf, cand))
        costB = RING_REPEAT * rb
        for _ in range(n_ring):
            cand = torch.roll(v, rows - RING_REPEAT, dims=0) + costB
            v = torch.minimum(v, torch.where(row >= NTT - RING_REPEAT, inf,
                                             cand))
        return v

    def chain_scan(v):
        # +inf window-boundary costs make lane-wrap reads self-masking
        for k, s in enumerate(chain_statics):
            v = torch.minimum(v, torch.roll(v, s, dims=1) + cfl[k])
        L = len(chain_statics)
        for _ in range(n_chain):
            v = torch.minimum(v, torch.roll(v, chain_rep, dims=1) + cfl[L])
        for k, s in enumerate(chain_statics):
            v = torch.minimum(v, torch.roll(v, ML - s, dims=1) + cbl[k])
        for _ in range(n_chain):
            v = torch.minimum(v, torch.roll(v, ML - chain_rep, dims=1)
                              + cbl[L])
        return v

    return ring_scan, chain_scan


def titer_reference(st: TWStatic, dist: torch.Tensor, cen: torch.Tensor,
                    tbl: TWTables, iters: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of `titer`: `iters` Jacobi iterations of the
    (S*NTT, ML) theta-major field, following the TPU kernel's body op for
    op (`_make_titer_kernel` of the JAX package).  cen (S,) holds each
    source block's centre distance.  Returns new (dist, cen)."""
    Mp, ML, NTT, nt, maxdm = st
    rows = dist.shape[0]
    S = rows // NTT
    dup = NTT - nt
    n_dm = 2 * maxdm + 1
    dev = dist.device
    ring_scan, chain_scan = _titer_scans(st, tbl, rows, dist.dtype, dev)
    row = (torch.arange(rows, device=dev) % NTT)[:, None]
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dev)
    fan, w_ref = tbl.fan_w, tbl.wrows

    def band_sweep(cur):
        pages = []
        for dc in range(-_DC_RANGE, _DC_RANGE + 1):
            if dc == 0:
                r = cur
            elif dup == 0 and S > 1:
                # exact wrap within each source block
                r = torch.roll(cur.view(S, NTT, ML), -dc, dims=1
                               ).reshape(rows, ML)
            else:
                r = torch.roll(cur, (-dc) % rows, dims=0)
                if dup:
                    if dc > 0:
                        r = torch.where(row >= NTT - dc, inf, r)
                    else:
                        r = torch.where(row < -dc, inf, r)
            pages.append(r)
        # moving-frame accumulator: one lane roll per trip; the weight
        # rows are host-shifted into source-slot coordinates
        macc = torch.roll(cur, (ML - maxdm - 1) % ML, dims=1)
        for t in range(n_dm):
            macc = torch.roll(macc, 1, dims=1)
            for u5 in range(NDC):
                w = w_ref[t * NDC + u5: t * NDC + u5 + 1, :]
                macc = torch.minimum(macc, pages[u5] + w)
        return torch.roll(macc, (ML - maxdm) % ML, dims=1)

    def merge_dup(acc):
        if not dup:
            return acc
        fwd = torch.where(row < dup, torch.roll(acc, (-nt) % rows, dims=0),
                          inf)
        bwd = torch.where(row >= nt, torch.roll(acc, nt, dims=0), inf)
        return torch.minimum(acc, torch.minimum(fwd, bwd))

    v = dist
    for _ in range(iters):
        v = chain_scan(ring_scan(v))
        v = merge_dup(band_sweep(v)).view(S, NTT, ML)
        cen = torch.minimum(cen, (v + fan).amin(dim=(1, 2)))
        v = torch.minimum(v, cen[:, None, None] + fan).reshape(rows, ML)
    return v, cen


# csrc/titer.cu's tiles: a band block's lanes and its step of theta rows
# (the kernel's kBandLanes, kBandRows, kBandRing), a ring block's columns
BAND_LANES = 128
BAND_ROWS = 4
BAND_RING = 16
RING_COLS = 8


def titer_launch_plan(st: TWStatic, itemsize: int):
    """(ring rows a thread, ring warps a column, chain lanes a thread,
    chain warps a row): the strips csrc/titer.cu's launch function takes
    for this geometry - a ring column of NTT rows on one warp, 2, 4 or 8
    rows a thread, else 32 a thread on several warps; a chain row of
    exactly ML lanes, the most lanes a thread (a multiple of 4, at most
    32) that divide ML / 32.  Raises ValueError where one of its kernels
    would need more than an H100 block may have (BLOCK_SMEM bytes of
    shared memory, 32 warps); the kernel refuses such a launch too."""
    Mp, ML, NTT, nt, maxdm = st
    ring_r = 2 if NTT <= 64 else 4 if NTT <= 128 else 8 if NTT <= 256 else 32
    ring_nw = -(-NTT // (32 * ring_r))
    cols = RING_COLS if ring_nw == 1 else 1
    ring = (2 * ring_nw * 32 + NTT * (cols + 1)) * itemsize
    if ring_nw > 32 or ring > BLOCK_SMEM:
        raise ValueError(f"the titer kernel's ring holds a column of {NTT} "
                         f"theta rows in one block: more than 32 warps or "
                         f"{BLOCK_SMEM // 1024} KB of shared memory")
    chain_r = next(r for r in range(32, 0, -4) if (ML // 32) % r == 0)
    chain_nw = ML // (32 * chain_r)
    if chain_nw > 32:
        raise ValueError(f"the titer kernel's chain holds a row of {ML} "
                         f"lanes in one block: more than 32 warps of "
                         f"{chain_r} lanes a thread")
    band = BAND_RING * (BAND_LANES + 2 * maxdm) * itemsize
    if band > BLOCK_SMEM:
        raise ValueError(f"the titer kernel's band ring of {BAND_RING} rows "
                         f"x {BAND_LANES + 2 * maxdm} lanes needs {band} "
                         f"bytes of shared memory, more than the "
                         f"{BLOCK_SMEM // 1024} KB an H100 block may have")
    return ring_r, ring_nw, chain_r, chain_nw


def titer_tiles_reference(st: TWStatic, dist: torch.Tensor, cen: torch.Tensor,
                          tbl: TWTables, iters: int, run: int = BAND_ROWS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/titer.cu's band in plain torch ops: the same floats as
    `titer_reference` by another route.  Each tile of BAND_LANES lanes x
    `run` theta rows (a multiple of BAND_ROWS) of a source block reads
    the rows c_begin - 2 .. c_end + 1 (wrapped mod NTT when dup == 0,
    +inf past the block's edge when dup > 0) at the lanes m0 - maxdm ..
    m0 + BAND_LANES - 1 + maxdm (wrapped mod ML), every (dm, dc) tap of
    every lane, +inf weights too, one add a candidate.  Each row's band
    is evaluated once; the duplicate merge (rows t < dup take row t+nt's
    result, rows t >= nt row t-nt's) and the fan run at the start of the
    next pass, and the centre takes its minimum from the band's output
    before the merge, as in the kernel.  The ring and chain scans are
    `titer_reference`'s."""
    Mp, ML, NTT, nt, maxdm = st
    rows = dist.shape[0]
    S = rows // NTT
    dup = NTT - nt
    n_dm = 2 * maxdm + 1
    dev, dtype = dist.device, dist.dtype
    ring_scan, chain_scan = _titer_scans(st, tbl, rows, dtype, dev)
    inf = float("inf")
    fan = tbl.fan_w[0]
    width = BAND_LANES + 2 * maxdm
    n_runs = -(-NTT // run)
    # every run's ring rows (theta rows, -1 where the row is +inf)
    q = (torch.arange(n_runs, device=dev)[:, None] * run - 2
         + torch.arange(run + NDC - 1, device=dev)[None, :])
    if dup == 0:
        q = q % NTT
    else:
        q = torch.where((q >= 0) & (q < NTT), q, -1)
    j = torch.arange(width, device=dev)
    lane = torch.arange(BAND_LANES, device=dev)

    def band(x):
        """(rows, ML) band output, unmerged."""
        y = torch.empty_like(x)
        for b in range(S):
            xb = x[b * NTT:(b + 1) * NTT]
            for m0 in range(0, ML, BAND_LANES):
                lx = (m0 - maxdm + j) % ML
                win = torch.where(q[:, :, None] >= 0,
                                  xb[q.clamp(min=0)][:, :, lx], inf)
                # output row i of a run reads ring row i + 2 + dc
                acc = win[:, 2:2 + run, maxdm:maxdm + BAND_LANES].clone()
                for t in range(n_dm):
                    xw = (m0 - maxdm + t + lane) % ML
                    for u in range(NDC):
                        w = tbl.wrows[t * NDC + u, xw]
                        acc = torch.minimum(
                            acc, win[:, u:u + run, t:t + BAND_LANES] + w)
                y[b * NTT:(b + 1) * NTT, m0:m0 + BAND_LANES] = \
                    acc.reshape(n_runs * run, BAND_LANES)[:NTT]
        return y

    def merge_and_fan(y, c):
        y3 = y.view(S, NTT, ML)
        if dup:
            fwd = torch.full_like(y3, inf)
            bwd = torch.full_like(y3, inf)
            fwd[:, :dup] = y3[:, nt:]
            bwd[:, nt:] = y3[:, :dup]
            y3 = torch.minimum(y3, torch.minimum(fwd, bwd))
        return torch.minimum(y3, c[:, None, None] + fan).reshape(rows, ML)

    v = dist
    for it in range(iters):
        if it:
            v = merge_and_fan(v, cen)
        y = band(chain_scan(ring_scan(v)))
        # each lane with a finite fan weight folds min(y + fan) into cen
        fin = torch.isfinite(fan)
        part = y.view(S, NTT, ML)[:, :, fin] + fan[fin]
        if part.numel():
            cen = torch.minimum(cen, part.amin(dim=(1, 2)))
        v = y
    return (merge_and_fan(v, cen) if iters else v.clone()), cen.clone()


def _check_titer_args(st: TWStatic, dist: torch.Tensor, cen: torch.Tensor,
                      tbl: TWTables):
    Mp, ML, NTT, nt, maxdm = st
    if dist.dim() != 2 or dist.shape[1] != ML or dist.shape[0] % NTT:
        raise ValueError(f"dist must be (S*{NTT}, {ML}), got "
                         f"{tuple(dist.shape)}")
    S = dist.shape[0] // NTT
    if tuple(cen.shape) != (S,):
        raise ValueError(f"cen must be ({S},), got {tuple(cen.shape)}")
    L = len(_chain_spans(Mp))
    want = {"wrows": (_round_up((2 * maxdm + 1) * NDC, SUB), ML),
            "ring_f": (1, ML), "ring_b": (1, ML), "cfl": (L, 1, ML),
            "cbl": (L, 1, ML), "fan_w": (1, ML)}
    for name, shape in want.items():
        t = getattr(tbl, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in (dist, cen) + tuple(tbl):
        if t.device != dist.device:
            raise ValueError(f"titer tensors on {t.device} and {dist.device}")
        if t.dtype != dist.dtype:
            raise TypeError(f"titer tensors of {t.dtype} and {dist.dtype}")


def _titer_lib() -> ctypes.CDLL:
    lib = kernels.load("titer")
    fn = lib.titer_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
    return lib


def titer(st: TWStatic, dist: torch.Tensor, cen: torch.Tensor,
          tbl: TWTables, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` Jacobi iterations of the (S*NTT, ML) theta-major field;
    returns new (dist, cen), the inputs untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/titer.cu`
    (float32 or float64): one launch function that enqueues three kernels
    an iteration and one more on the current stream (`titer.launches`
    counts its calls); a grid whose kernels would not fit an H100 block
    raises ValueError (`titer_launch_plan`).  A CPU tensor goes to
    `titer_reference`.  Any other device raises.
    """
    _check_titer_args(st, dist, cen, tbl)
    if dist.device.type == "cpu":
        return titer_reference(st, dist, cen, tbl, iters)
    if dist.device.type != "cuda":
        raise ValueError(f"titer runs on cuda or cpu, not {dist.device}")
    kernels.require_float("titer", dist.dtype)
    tensors = (dist, cen) + tuple(tbl)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("titer takes contiguous tensors")
    Mp, ML, NTT, nt, maxdm = st
    titer_launch_plan(st, dist.element_size())
    S = dist.shape[0] // NTT
    ring_statics, n_ring, chain_statics, chain_rep, n_chain = _scan_plan(st)
    out = torch.empty_like(dist)
    scratch = torch.empty_like(dist)
    cen_out = torch.empty_like(cen)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    rc = _titer_lib().titer_launch(
        dist.data_ptr(), cen.data_ptr(), tbl.wrows.data_ptr(),
        tbl.ring_f.data_ptr(), tbl.ring_b.data_ptr(), tbl.cfl.data_ptr(),
        tbl.cbl.data_ptr(), tbl.fan_w.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), cen_out.data_ptr(),
        S, ML, NTT, nt, maxdm, len(ring_statics), n_ring,
        len(chain_statics), chain_rep, n_chain, int(iters),
        int(dist.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"titer kernel launch failed: CUDA error {rc}")
    titer.launches += 1
    return out, cen_out


titer.launches = 0


# ----------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------


class TWState(NamedTuple):
    dist: torch.Tensor    # (S*NTT, ML)
    dcen: torch.Tensor    # (S,)
    changed: bool
    it: int


def _solve_twrapped(src_m, src_c, src_cen, tbl: TWTables, tol,
                    st: TWStatic, max_iters: int, sweeps: int,
                    S: int) -> TWState:
    """Full solve of a source block from (S,) source descriptors: zero at
    each source's slot on its theta row and that row's duplicates, or at
    the centre for centre sources; `titer` calls of `sweeps` iterations
    until no distance improves by more than `tol`."""
    dev = tbl.wrows.device
    dtype = tbl.wrows.dtype
    Mp, ML, NTT, nt, maxdm = st
    t_r = (torch.arange(S * NTT, device=dev) % NTT)[:, None]
    c_r = torch.as_tensor(np.repeat(src_c, NTT), device=dev)[:, None]
    m_r = torch.as_tensor(np.repeat(src_m, NTT), device=dev)[:, None]
    s_r = torch.as_tensor(np.repeat(src_cen, NTT), device=dev)[:, None]
    lane = torch.arange(ML, device=dev)[None, :]
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    dist = torch.where((t_r % nt == c_r) & (lane == m_r) & ~s_r, zero, inf)
    cen = torch.where(torch.as_tensor(np.asarray(src_cen), device=dev),
                      zero, inf)
    state = TWState(dist, cen, True, 0)
    while state.changed and state.it < max_iters:
        d, c = titer(st, state.dist, state.dcen, tbl, sweeps)
        changed = bool(((d < state.dist - tol).any()
                        | (c < state.dcen - tol).any()).item())
        state = TWState(d, c, changed, state.it + sweeps)
    return state


def device_twrapped_tables(ws: TWStencil, device) -> TWTables:
    """The stencil's cost tables on `device`, cached in its dcache."""
    key = ("twrapped_device", str(device))
    if key not in ws.dcache:
        ws.dcache[key] = TWTables(*(
            torch.tensor(a, device=device)
            for a in (ws.wrows, ws.ring_f, ws.ring_b, ws.cfl, ws.cbl,
                      ws.fan_w)))
    return ws.dcache[key]


def solve_circulant_twrapped(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    sweeps_per_call: int = 4,
    vertical_closure: int = 0,
    band_closure: int = 0,
    batch: int = 1,
    receivers=None,
    device_out: bool = False,
    device="cuda",
    _packed: TWStencil = None,
) -> Tuple[np.ndarray, int]:
    """Theta-major full-iteration solve on `device`: sources in chunks of
    `batch` NTT-row blocks, optional on-device receiver extraction.
    Returns ((n_sources, n_out) host array, iterations); device_out=True
    returns the rows as a tensor on the device.  Check
    `supports_twrapped(cg)`; ops/diag_wrapped.py and ops/diag_circulant.py
    take the other grids."""
    if not supports_twrapped(cg):
        raise ValueError("theta-major kernel unsupported for this ntheta; "
                         "use solve_circulant_wrapped/diag")
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=dtype, vertical_closure=vertical_closure,
        band_closure=band_closure)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    S = max(1, min(batch, len(sources)))
    st = TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)
    tbl = device_twrapped_tables(ws, device)
    tol = torch.tensor(config.tol_value(), dtype=tbl.wrows.dtype,
                       device=device)
    n_out, ext = _extract_cached(ws.dcache, cmap, receivers, device)

    def dispatch(chunk):
        is_cen = chunk == cmap.center
        src_m = np.where(is_cen, 0, cmap.m_of[chunk]).astype(np.int64)
        src_c = np.where(is_cen, 0, cmap.c_of[chunk]).astype(np.int64)
        state = _solve_twrapped(src_m, src_c, is_cen, tbl, tol, st,
                                config.max_iters, sweeps_per_call, S)
        return _textract(state.dist.view(S, ws.NTT, ws.ML), state.dcen,
                         state.it, *ext)

    return _pipelined_chunk_solve(sources, S, n_out, dtype, dispatch,
                                  device_out=device_out)
