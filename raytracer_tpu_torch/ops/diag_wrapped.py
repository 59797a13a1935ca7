"""Slot-major full-iteration Jacobi engine ('wrapped'), PyTorch port.

Counterpart of `raytracer_tpu/ops/diag_wrapped.py`, plus the shared
helpers of the batched circulant solvers (chain spans, min-plus window
costs, the vertical band closure, the chunked-solve protocol and the
node-extraction index arrays) that 'twrapped' and the sweep also use.

The distance field is stored (Mp slot rows, S*NTL theta lanes): source
block b holds NTL lanes, lane l holding theta (l mod nt), so every lane
is real data and lanes [nt, NTL) duplicate thetas 0..dup-1 (dup =
NTL - nt).  One Jacobi iteration is

    ring scan (theta, lanes) -> chain scan (slots, rows)
        -> band sweep over the (dm, dc) diagonals, grouped by rho =
           dm mod 8 -> duplicate-lane merge -> centre fan

and `witer` runs `iters` of them per call: on a CUDA tensor as the
hand-written kernel `csrc/witer.cu` (one launch function that enqueues
three kernels an iteration; the band reads per-row tap lists,
`wrapped_tap_lists`), on a CPU tensor as its plain twin
`witer_reference`, which follows the Pallas body op for op.  Theta
shifts that cross a block's lane edge (the |dc| "defect" lanes) read
+inf and are recovered by the duplicate merge, so the fixpoint is exact.
The solve calls `witer` until no distance improves by more than
`SolverConfig.tol`, counting `sweeps_per_call` iterations per call as
the JAX package does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from .circulant import CirculantGraph, _DC_RANGE, resolve_device
from .diag_circulant import (BAND_LANE_HALO, BAND_LANES, BAND_ROWS,
                             BLOCK_SMEM, LANES, SUB, TapLists, _block_taps,
                             _round_up, band_block_taps, band_tile,
                             decompose_diagonals, row_tap_lists)

RING_REPEAT = 16   # fixed span of the ring scan (statics cover 1..15)
CHAIN_REPEAT = 32  # repeat span of the chain scan (statics cover 1..31)
UNROLL = 4         # each rho group is padded to a multiple of this with
                   # no-op diagonals (offset 0, +inf weight), as the TPU
                   # kernel's band loop takes UNROLL diagonals per trip


def _pow2_below(n: int):
    out, s = [], 1
    while s < n:
        out.append(s)
        s *= 2
    return tuple(out)


def _chain_spans(Mp: int):
    """Chain-scan spans for a slot axis of Mp rows: doubling statics plus
    a repeat span (the last element), all < Mp."""
    spans = tuple(s for s in _pow2_below(CHAIN_REPEAT) + (CHAIN_REPEAT,)
                  if s < Mp)
    return spans if spans else (1,)


def _window_costs(c1: np.ndarray, need) -> np.ndarray:
    """(len(need), Mp) min-plus window sums of the per-hop chain cost c1,
    built by doubling; +inf boundary entries make wrap reads self-masking.
    `need` must be powers of two in increasing order."""
    cur = c1.astype(np.float64).copy()
    span = 1
    out = []
    while True:
        if span in need:
            out.append(cur.copy())
        if span >= max(need):
            break
        shifted = np.full_like(cur, np.inf)
        shifted[span:] = cur[:-span]
        cur = cur + shifted
        span *= 2
    assert len(out) == len(need)
    return np.stack(out)


def _compose_vertical(dms, dcs, wmat, pad, levels: int):
    """Append min-plus squares of the dc=0 sub-band (truncated to |dm| <=
    pad) as extra diagonals.

    Ray paths spend ~half their hops descending vertically with |dm| in
    the 8..14 range (layer strides) and almost never repeat a hop type,
    so the chain scan (dm=+-1 only) cannot compose them; each vertical
    hop otherwise costs one full band sweep.  A composed diagonal
    (dm1+dm2, 0) with weight w1[m] + w2[m+dm1] is a real 2-hop path cost,
    so relaxing with it preserves the exact fixpoint while collapsing
    vertical runs of up to 2^levels hops into one sweep.
    """
    Mp = wmat.shape[1]
    vert = {}
    for d in np.flatnonzero(dcs == 0):
        vert[int(dms[d])] = wmat[d]
    base_keys = set(zip(dms.tolist(), dcs.tolist()))
    cur = dict(vert)
    cur[0] = np.minimum(cur.get(0, np.inf), np.zeros(Mp))  # identity
    add_dm, add_w = [], []
    for _ in range(levels):
        nxt = {}
        for dm1, w1 in cur.items():
            for dm2, w2 in cur.items():
                dm = dm1 + dm2
                if abs(dm) > pad:
                    continue
                w2s = np.full(Mp, np.inf)
                if dm1 >= 0:
                    w2s[: Mp - dm1] = w2[dm1:]
                else:
                    w2s[-dm1:] = w2[: Mp + dm1]
                cand = w1 + w2s
                nxt[dm] = np.minimum(nxt[dm], cand) if dm in nxt else cand
        cur = nxt
    for dm, w in cur.items():
        if dm == 0 or not np.isfinite(w).any():
            continue
        if (dm, 0) in base_keys:
            d = int(np.flatnonzero((dms == dm) & (dcs == 0))[0])
            wmat[d] = np.minimum(wmat[d], w)
        else:
            add_dm.append(dm)
            add_w.append(w)
    if add_dm:
        dms = np.concatenate([dms, np.asarray(add_dm, dms.dtype)])
        dcs = np.concatenate([dcs, np.zeros(len(add_dm), dcs.dtype)])
        wmat = np.concatenate([wmat, np.stack(add_w)])
    return dms, dcs, wmat


def _pipelined_chunk_solve(sources, S: int, n_out: int, dtype, dispatch,
                           device_out: bool = False):
    """Chunked-solve protocol of the batched solvers: pad the last chunk
    by repeating its final source, run `dispatch(chunk) -> (S, n_out+1)`
    (iteration count in the last column) for every chunk, then copy the
    results to the host in a second pass.

    device_out=True leaves the distance rows on the device (one tensor)
    and returns only the iteration count to the host."""
    pending = []
    for lo in range(0, len(sources), S):
        chunk = sources[lo:lo + S]
        n_real = len(chunk)
        if n_real < S:
            chunk = np.concatenate([chunk, np.full(S - n_real, chunk[-1])])
        pending.append((lo, n_real, dispatch(chunk)))
    if device_out:
        rows = [vals_it[:n_real, :-1] for _, n_real, vals_it in pending]
        dist = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
        its = torch.stack([v[0, -1] for _, _, v in pending]).cpu().numpy()
        return dist, int(its.max())
    out = np.empty((len(sources), n_out), dtype=dtype)
    iters = 0
    for lo, n_real, vals_it in pending:
        arr = vals_it.cpu().numpy()
        out[lo:lo + n_real] = arr[:n_real, :-1]
        # chunks converge at different counts; report the slowest
        iters = max(iters, int(arr[0, -1]))
    return out, iters


_EXTRACT_CACHE_MAX = 8  # receiver sets kept per stencil (oldest evicted)


def _extract_cached(dcache: dict, cmap, receivers, device):
    """(n_out, (m, c, center, valid) device tensors), cached per receiver
    set and device in the stencil's dcache with a bounded number of
    entries."""
    rkey = (None if receivers is None
            else np.asarray(receivers, dtype=np.int64).tobytes())
    key = ("extract", rkey, str(device))
    if key not in dcache:
        ext = [k for k in dcache if isinstance(k, tuple) and k[0] == "extract"]
        if len(ext) >= _EXTRACT_CACHE_MAX:
            del dcache[ext[0]]
        m_idx, c_idx, center_mask, valid = _node_extract_arrays(cmap, receivers)
        dcache[key] = (len(m_idx), tuple(
            torch.as_tensor(a.astype(np.int64) if a.dtype != bool else a,
                            device=device)
            for a in (m_idx, c_idx, center_mask, valid)))
    return dcache[key]


def _node_extract_arrays(cmap, receivers=None):
    """Index arrays mapping nodes (all, or a receiver subset) to their
    (slot, column) position, for on-device extraction."""
    if receivers is None:
        sel = np.arange(len(cmap.m_of), dtype=np.int64)
    else:
        sel = np.asarray(receivers, dtype=np.int64).ravel()
    m = cmap.m_of[sel]
    c = cmap.c_of[sel]
    valid = m >= 0
    if cmap.center >= 0:
        center_mask = sel == cmap.center
    else:
        center_mask = np.zeros(len(sel), dtype=bool)
    m_idx = np.where(valid, m, 0).astype(np.int32)
    c_idx = np.where(valid, c, 0).astype(np.int32)
    return m_idx, c_idx, center_mask, valid


# ----------------------------------------------------------------------
# the wrapped-lane stencil
# ----------------------------------------------------------------------


class WrappedStencil(NamedTuple):
    """Rho-grouped diagonal stencil + scan tables for the full-iteration
    wrapped-lane kernel (the JAX package's fields).

    offs       : (D,) int32 - 8-aligned flat row offset into the TPU
                 kernel's 5-page dc scratch: (dc+2) * rows5 + pad2 + dm - rho
    wp         : (G, Mp, 128) lane-packed weights in GROUPED diagonal
                 order (diagonal j's weights live in wp[j//128, :, j%128])
    wpT        : (Dp8, Mp128) row-major weights, row j = grouped diagonal j
    dcache     : per-stencil cache of device tensors (tables, extraction)
    rho_starts : 9 static ints - group r covers [starts[r], starts[r+1])
    ring_f/b   : (Mp, 1) per-slot ring hop cost (theta -/+ direction)
    cfl/cbl    : (L, Mp, 1) chain window costs, spans 1,2,4,..,CHAIN_REPEAT
    fan_w      : (Mp, 1) centre<->slot weights (+inf off the fan)
    pad2       : row padding (pad + 8)
    """

    offs: np.ndarray
    wp: np.ndarray
    wpT: np.ndarray
    dcache: dict
    rho_starts: Tuple[int, ...]
    ring_f: np.ndarray
    ring_b: np.ndarray
    cfl: np.ndarray
    cbl: np.ndarray
    fan_w: np.ndarray
    pad2: int
    D: int
    Mp: int
    M: int
    nt: int
    NTL: int


def supports_wrapped(cg: CirculantGraph) -> bool:
    """The duplicate-merge needs a defect-free twin for every defect lane:
    either no wrap defects at all (nt divides NTL) or at least _DC_RANGE
    duplicated thetas."""
    nt = cg.ntheta
    NTL = _round_up(nt, LANES)
    dup = NTL - nt
    return nt >= SUB and (dup == 0 or dup >= _DC_RANGE)


def pack_wrapped_stencil(cg: CirculantGraph, dtype=np.float32,
                         vertical_closure: int = 0) -> WrappedStencil:
    dec = decompose_diagonals(cg)
    dms, dcs, wmat = dec.dms, dec.dcs, dec.wmat.copy()
    D, Mp, nt, NTL = dec.D, dec.Mp, dec.nt, dec.NTL
    if vertical_closure:
        dms, dcs, wmat = _compose_vertical(dms, dcs, wmat, dec.pad,
                                           vertical_closure)
    pad2 = dec.pad + SUB
    rows5 = Mp + 2 * pad2

    rho = np.mod(dms, SUB)
    raw_offs = ((dcs + _DC_RANGE) * rows5 + pad2 + dms - rho).astype(np.int32)

    # group by rho, padding each group to a multiple of UNROLL with dummy
    # diagonals (offset 0, +inf weight column -> exact no-ops)
    offs_g, w_cols, starts = [], [], [0]
    for r in range(SUB):
        sel = np.flatnonzero(rho == r)
        n_pad = _round_up(len(sel), UNROLL)
        o = np.zeros(n_pad, dtype=np.int32)
        o[: len(sel)] = raw_offs[sel]
        offs_g.append(o)
        w_cols.append(sel)
        starts.append(starts[-1] + n_pad)
    offs = np.concatenate(offs_g)
    rho_starts = tuple(starts)
    Dp = rho_starts[-1]
    assert offs.min() >= 0 and np.all(offs % SUB == 0)
    assert np.all(offs + Mp + SUB <= 5 * rows5)

    G = _round_up(Dp, LANES) // LANES
    wp = np.full((G, Mp, LANES), np.inf)
    wpT = np.full((_round_up(Dp, SUB), _round_up(Mp, LANES)), np.inf)
    for r in range(SUB):
        for k, src_idx in enumerate(w_cols[r]):
            j = rho_starts[r] + k
            wp[j // LANES, :, j % LANES] = wmat[src_idx]
            wpT[j, :Mp] = wmat[src_idx]

    def _diag_vec(dm0: int, dc0: int) -> np.ndarray:
        hit = (dms == dm0) & (dcs == dc0)
        out = np.full(Mp, np.inf)
        if hit.any():
            out[:] = wmat[int(np.flatnonzero(hit)[0])]
        return out

    chain_f = _diag_vec(-1, 0)
    chain_f[0] = np.inf
    chain_b = _diag_vec(+1, 0)
    chain_b[-1] = np.inf
    spans = _chain_spans(Mp)
    cfl = _window_costs(chain_f, spans)[:, :, None]
    cbl = _window_costs(chain_b[::-1], spans)[:, ::-1, None]

    fan_w = np.full((Mp, 1), np.inf)
    fan_w[cg.fan_slots, 0] = cg.fan_w

    return WrappedStencil(
        offs=offs, wp=wp.astype(dtype), wpT=wpT.astype(dtype),
        dcache={}, rho_starts=rho_starts,
        ring_f=_diag_vec(0, -1)[:, None].astype(dtype),
        ring_b=_diag_vec(0, +1)[:, None].astype(dtype),
        cfl=cfl.astype(dtype), cbl=cbl.astype(dtype),
        fan_w=fan_w.astype(dtype),
        pad2=pad2, D=Dp, Mp=Mp, M=dec.M, nt=nt, NTL=NTL,
    )


# ----------------------------------------------------------------------
# T full iterations: CUDA kernel wrapper + plain twin
# ----------------------------------------------------------------------


class WStatic(NamedTuple):
    """Static geometry of the slot-major kernel (the JAX `ws_static`)."""

    rho_starts: Tuple[int, ...]
    Mp: int
    NTL: int
    pad2: int
    nt: int


class WTables(NamedTuple):
    """The kernel's tables as tensors on one device.  `offs` and `wpT` are
    the TPU kernel's form of the diagonals (read by the twin); tap_ptr,
    tap_dmdc and tap_w the CUDA kernel's (`wrapped_tap_lists`: the same
    diagonals' finite weights, listed per row)."""

    offs: torch.Tensor      # (Dp,) int32
    wpT: torch.Tensor       # (Dp8, Mp128)
    ring_f: torch.Tensor    # (Mp, 1)
    ring_b: torch.Tensor    # (Mp, 1)
    cfl: torch.Tensor       # (L, Mp, 1)
    cbl: torch.Tensor       # (L, Mp, 1)
    fan_w: torch.Tensor     # (Mp, 1)
    tap_ptr: torch.Tensor   # (Mp+1,) int32
    tap_dmdc: torch.Tensor  # (E,) int32
    tap_w: torch.Tensor     # (E,)


def wrapped_taps(ws: WrappedStencil) -> np.ndarray:
    """(Dp, 2) int32 (dm, dc) of each grouped diagonal, decoded from its
    offset into the TPU kernel's 5-page scratch (the no-op padding
    diagonals decode to some (dm, dc) and keep their +inf weights)."""
    rows5 = ws.Mp + 2 * ws.pad2
    rho = np.zeros(ws.D, dtype=np.int64)
    for r in range(SUB):
        rho[ws.rho_starts[r]:ws.rho_starts[r + 1]] = r
    offs = ws.offs.astype(np.int64)
    dc = offs // rows5 - _DC_RANGE
    dm = offs % rows5 - ws.pad2 + rho
    return np.stack([dm, dc], axis=1).astype(np.int32)


def wrapped_tap_lists(ws: WrappedStencil) -> TapLists:
    """Per-row lists of the grouped diagonals' finite weights (the
    diagonals' (dm, dc) from `wrapped_taps`), by row, then diagonal: at
    most Dp entries a row, as csrc/witer.cu's band reads them."""
    return row_tap_lists(wrapped_taps(ws), ws.wpT[:ws.D, :ws.Mp],
                         ws.pad2 - SUB)


def witer_launch_plan(st: WStatic, itemsize: int, block_taps: int):
    """(band lanes a block, taps staged in shared memory): the band tile
    csrc/witer.cu's launch function takes for this geometry and dtype
    (`band_tile`, the halo the stencil's row padding).  Raises ValueError where one
    of the launch's kernels would need more than an H100 block may have
    (BLOCK_SMEM bytes of shared memory, 32 warps); the kernel refuses
    such a launch too."""
    rho_starts, Mp, NTL, pad2, nt = st
    if NTL > 32 * 32 * (4 if NTL % 256 else 8):
        raise ValueError(f"the witer kernel's ring takes rows of at most "
                         f"8192 lanes (4096 if not a multiple of 256), "
                         f"not {NTL}")
    chain_nw = -(-Mp // 1024)
    chain = (2 * chain_nw * 32 + _round_up(Mp * (4 if chain_nw == 1 else 1),
                                           2)) * itemsize
    if chain_nw > 32 or chain > BLOCK_SMEM:
        raise ValueError(f"the witer kernel's chain holds a column of "
                         f"{Mp} slots in one block: more than 32 warps or "
                         f"{BLOCK_SMEM // 1024} KB of shared memory")
    return band_tile(pad2 - SUB, itemsize, block_taps,
                     "the witer kernel's band window")


def _ring_plan(NTL: int):
    """(ring statics, n_ring): the TPU kernel's ring-scan span schedule."""
    return _pow2_below(RING_REPEAT), -(-(NTL - RING_REPEAT) // RING_REPEAT)


def _chain_plan(Mp: int):
    """(chain statics, repeat span, n_chain)."""
    chain_all = _chain_spans(Mp)
    chain_statics, chain_rep = chain_all[:-1], chain_all[-1]
    return chain_statics, chain_rep, max(0, -(-(Mp - chain_rep) // chain_rep))


def _witer_scans(st: WStatic, tbl: WTables, NTLT: int, dtype, dev):
    """The ring and chain scans of one iteration of the (Mp, NTLT) field,
    op for op the TPU kernel's (shared by both plain versions)."""
    rho_starts, Mp, NTL, pad2, nt = st
    ring_statics, n_ring = _ring_plan(NTL)
    chain_statics, chain_rep, n_chain = _chain_plan(Mp)
    lane_full = (torch.arange(NTLT, device=dev) % NTL)[None, :]
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    rf, rb = tbl.ring_f, tbl.ring_b
    cfl, cbl = tbl.cfl, tbl.cbl

    def ring_scan(v):
        # forward: lane l improves from lane l-s (theta - s) at cost s*c
        for s in ring_statics:
            cand = torch.roll(v, s, dims=1) + (s * rf)
            v = torch.minimum(v, torch.where(lane_full < s, inf, cand))
        costF = RING_REPEAT * rf
        for _ in range(n_ring):
            cand = torch.roll(v, RING_REPEAT, dims=1) + costF
            v = torch.minimum(v, torch.where(lane_full < RING_REPEAT, inf,
                                             cand))
        for s in ring_statics:
            cand = torch.roll(v, NTLT - s, dims=1) + (s * rb)
            v = torch.minimum(v, torch.where(lane_full >= NTL - s, inf, cand))
        costB = RING_REPEAT * rb
        for _ in range(n_ring):
            cand = torch.roll(v, NTLT - RING_REPEAT, dims=1) + costB
            v = torch.minimum(v, torch.where(lane_full >= NTL - RING_REPEAT,
                                             inf, cand))
        return v

    def chain_scan(v):
        # window costs carry +inf at boundary rows -> wrap reads are
        # self-masking, no row masks needed
        for k, s in enumerate(chain_statics):
            v = torch.minimum(v, torch.roll(v, s, dims=0) + cfl[k])
        L = len(chain_statics)
        for _ in range(n_chain):
            v = torch.minimum(v, torch.roll(v, chain_rep, dims=0) + cfl[L])
        for k, s in enumerate(chain_statics):
            v = torch.minimum(v, torch.roll(v, Mp - s, dims=0) + cbl[k])
        for _ in range(n_chain):
            v = torch.minimum(v, torch.roll(v, Mp - chain_rep, dims=0)
                              + cbl[L])
        return v

    return ring_scan, chain_scan


def witer_reference(st: WStatic, dist: torch.Tensor, cen: torch.Tensor,
                    tbl: WTables, iters: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of `witer`: `iters` full iterations of the
    (Mp, S*NTL) field, op for op the TPU kernel's body
    (`_make_iter_kernel` of the JAX package, weights read as rows of
    wpT).  cen (S,) holds each source block's centre distance.  Returns
    new (dist, cen)."""
    rho_starts, Mp, NTL, pad2, nt = st
    NTLT = dist.shape[1]
    S = NTLT // NTL
    rows5 = Mp + 2 * pad2
    dup = NTL - nt
    dev, dtype = dist.device, dist.dtype
    ring_scan, chain_scan = _witer_scans(st, tbl, NTLT, dtype, dev)
    lane_full = (torch.arange(NTLT, device=dev) % NTL)[None, :]
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    fan = tbl.fan_w
    offs = tbl.offs.tolist()
    wcols = tbl.wpT[:, :Mp, None]   # row j as an (Mp, 1) column

    def band_sweep(cur):
        # 5 theta-rolled dc pages with +inf row padding; defect lanes
        # (reads crossing the NTL wrap) masked to +inf
        q = torch.full((5 * rows5, NTLT), float("inf"), dtype=dtype,
                       device=dev)
        for u5, dc in enumerate(range(-_DC_RANGE, _DC_RANGE + 1)):
            if dc == 0:
                r = cur
            elif dup == 0 and S > 1:
                # exact wrap must stay in-block
                r = torch.roll(cur.view(Mp, S, NTL), -dc, dims=2
                               ).reshape(Mp, NTLT)
            else:
                r = torch.roll(cur, (-dc) % NTLT, dims=1)
                if dup:
                    if dc > 0:
                        r = torch.where(lane_full >= NTL - dc, inf, r)
                    elif dc < 0:
                        r = torch.where(lane_full < -dc, inf, r)
            q[u5 * rows5 + pad2:u5 * rows5 + pad2 + Mp] = r
        acc = cur
        for rho in range(SUB):
            for j in range(rho_starts[rho], rho_starts[rho + 1]):
                # the TPU's (Mp+8)-row slice rolled by -rho, first Mp rows
                o = offs[j] + rho
                acc = torch.minimum(acc, q[o:o + Mp] + wcols[j])
        return acc

    def merge_dup(acc):
        if not dup:
            return acc
        fwd = torch.where(lane_full < dup,
                          torch.roll(acc, (-nt) % NTLT, dims=1), inf)
        bwd = torch.where(lane_full >= nt, torch.roll(acc, nt, dims=1), inf)
        return torch.minimum(acc, torch.minimum(fwd, bwd))

    v = dist
    for _ in range(iters):
        v = chain_scan(ring_scan(v))
        v = merge_dup(band_sweep(v)).view(Mp, S, NTL)
        # per-source-block centre fan
        cen = torch.minimum(cen, (v + fan[:, :, None]).amin(dim=(0, 2)))
        v = torch.minimum(v, cen[None, :, None] + fan[:, :, None]
                          ).reshape(Mp, NTLT)
    return v, cen


def witer_tiles_reference(st: WStatic, dist: torch.Tensor, cen: torch.Tensor,
                          tbl: WTables, iters: int,
                          lanes: int = BAND_LANES
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/witer.cu's band in plain torch ops: the same floats as
    `witer_reference` by another route.  Each tile of BAND_ROWS rows x
    `lanes` lanes of a source block (BAND_LANES or 32, the kernel's two
    tiles) reads a flat window of BAND_ROWS +
    2 * halo rows (halo = pad2 - 8; rows outside [0, Mp) +inf) by
    lanes + 8 (the BAND_LANE_HALO lanes past either edge of the
    block +inf when dup > 0, the block's wrapped lanes when dup == 0),
    and each row's tap list (`tap_ptr`, `tap_dmdc`, `tap_w`) at the
    offset dm * width + dc from the row's own point.  The centre takes
    its minimum from the band's output before the duplicate merge, which
    runs with the fan at the start of the next pass, as in the kernel.
    The ring and chain scans are `witer_reference`'s."""
    rho_starts, Mp, NTL, pad2, nt = st
    NTLT = dist.shape[1]
    S = NTLT // NTL
    dup = NTL - nt
    R, H, LH = BAND_ROWS, pad2 - SUB, BAND_LANE_HALO
    WW = lanes + 2 * LH
    dev, dtype = dist.device, dist.dtype
    ring_scan, chain_scan = _witer_scans(st, tbl, NTLT, dtype, dev)
    inf = float("inf")
    fan = tbl.fan_w[:, 0]
    n_rt = -(-Mp // R)
    # every tap's row, window-row offset and tap offset
    cnt = (tbl.tap_ptr[1:] - tbl.tap_ptr[:-1]).long()
    m_e = torch.repeat_interleave(torch.arange(Mp, device=dev), cnt)
    code = tbl.tap_dmdc.long()
    dm_e = code >> 16
    dc_e = ((code & 0xFFFF) ^ 0x8000) - 0x8000
    off_e = dm_e * WW + dc_e
    centre_e = (H + m_e % R) * WW + LH                    # the row's lane 0
    tile_e = m_e // R
    rows_w = (torch.arange(n_rt, device=dev)[:, None] * R - H
              + torch.arange(R + 2 * H, device=dev)[None, :])  # (n_rt, R+2H)
    row_ok = (rows_w >= 0) & (rows_w < Mp)
    lane_j = torch.arange(lanes, device=dev)

    def band(x):
        """(Mp, NTLT) band output, unmerged."""
        y = torch.empty_like(x)
        for b in range(S):
            xb = x[:, b * NTL:(b + 1) * NTL]
            for l0 in range(0, NTL, lanes):
                lp = torch.arange(l0 - LH, l0 + lanes + LH, device=dev)
                lane_ok = (lp >= 0) & (lp < NTL)
                if dup == 0:
                    lp, lane_ok = lp % NTL, torch.ones_like(lane_ok)
                src = xb[rows_w.clamp(0, Mp - 1)][:, :, lp.clamp(0, NTL - 1)]
                ok = row_ok[:, :, None] & lane_ok[None, None, :]
                win = torch.where(ok, src, inf).reshape(-1)     # flat tiles
                at = tile_e * ((R + 2 * H) * WW) + centre_e + off_e
                cand = win[at[:, None] + lane_j[None, :]] + tbl.tap_w[:, None]
                acc = xb[:, l0:l0 + lanes].clone()
                acc.scatter_reduce_(0, m_e[:, None].expand(-1, lanes), cand,
                                    "amin")
                y[:, b * NTL + l0:b * NTL + l0 + lanes] = acc
        return y

    def merge_and_fan(y, c):
        y3 = y.view(Mp, S, NTL)
        if dup:
            fwd = torch.full_like(y3, inf)
            bwd = torch.full_like(y3, inf)
            fwd[:, :, :dup] = y3[:, :, nt:]
            bwd[:, :, nt:] = y3[:, :, :dup]
            y3 = torch.minimum(y3, torch.minimum(fwd, bwd))
        return torch.minimum(y3, c[None, :, None] + fan[:, None, None]
                             ).reshape(Mp, NTLT)

    v = dist
    for it in range(iters):
        if it:
            v = merge_and_fan(v, cen)
        y = band(chain_scan(ring_scan(v)))
        # each row with a finite fan weight folds min(y + fan) into cen
        fin = torch.isfinite(fan)
        part = (y.view(Mp, S, NTL)[fin] + fan[fin][:, None, None])
        cen = torch.minimum(cen, part.amin(dim=(0, 2)) if part.numel()
                            else cen)
        v = y
    return (merge_and_fan(v, cen) if iters else v.clone()), cen.clone()


def _check_witer_args(st: WStatic, dist: torch.Tensor, cen: torch.Tensor,
                      tbl: WTables):
    rho_starts, Mp, NTL, pad2, nt = st
    if dist.dim() != 2 or dist.shape[0] != Mp or dist.shape[1] % NTL:
        raise ValueError(f"dist must be ({Mp}, S*{NTL}), got "
                         f"{tuple(dist.shape)}")
    S = dist.shape[1] // NTL
    if tuple(cen.shape) != (S,):
        raise ValueError(f"cen must be ({S},), got {tuple(cen.shape)}")
    Dp = rho_starts[-1]
    L = len(_chain_spans(Mp))
    E = tbl.tap_w.shape[0]
    want = {"offs": (Dp,),
            "wpT": (_round_up(Dp, SUB), _round_up(Mp, LANES)),
            "ring_f": (Mp, 1), "ring_b": (Mp, 1), "cfl": (L, Mp, 1),
            "cbl": (L, Mp, 1), "fan_w": (Mp, 1), "tap_ptr": (Mp + 1,),
            "tap_dmdc": (E,), "tap_w": (E,)}
    for name, shape in want.items():
        t = getattr(tbl, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dist.device:
            raise ValueError(f"witer tensors on {t.device} and {dist.device}")
    for t in (cen, tbl.wpT, tbl.ring_f, tbl.ring_b, tbl.cfl, tbl.cbl,
              tbl.fan_w, tbl.tap_w):
        if t.dtype != dist.dtype:
            raise TypeError(f"witer tensors of {t.dtype} and {dist.dtype}")


def _witer_lib() -> ctypes.CDLL:
    lib = kernels.load("witer")
    fn = lib.witer_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
    return lib


def witer(st: WStatic, dist: torch.Tensor, cen: torch.Tensor,
          tbl: WTables, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` full iterations of the (Mp, S*NTL) slot-major field;
    returns new (dist, cen), the inputs untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/witer.cu`
    (float32 or float64): one launch function that enqueues three
    kernels an iteration and one more on the current stream
    (`witer.launches` counts its calls); a grid whose kernels would not
    fit an H100 block raises ValueError (`witer_launch_plan`).  A CPU
    tensor goes to `witer_reference`.  Any other device raises.
    """
    _check_witer_args(st, dist, cen, tbl)
    if dist.device.type == "cpu":
        return witer_reference(st, dist, cen, tbl, iters)
    if dist.device.type != "cuda":
        raise ValueError(f"witer runs on cuda or cpu, not {dist.device}")
    kernels.require_float("witer", dist.dtype)
    if tbl.tap_ptr.dtype != torch.int32 or tbl.tap_dmdc.dtype != torch.int32:
        raise TypeError("the witer kernel takes int32 tap lists")
    tensors = (dist, cen) + tuple(tbl)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("witer takes contiguous tensors")
    rho_starts, Mp, NTL, pad2, nt = st
    block_taps = _block_taps(tbl.tap_ptr)
    witer_launch_plan(st, dist.element_size(), block_taps)
    S = dist.shape[1] // NTL
    _, n_ring = _ring_plan(NTL)
    chain_statics, chain_rep, n_chain = _chain_plan(Mp)
    out = torch.empty_like(dist)
    scratch = torch.empty_like(dist)
    cen_out = torch.empty_like(cen)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    rc = _witer_lib().witer_launch(
        dist.data_ptr(), cen.data_ptr(), tbl.tap_ptr.data_ptr(),
        tbl.tap_dmdc.data_ptr(), tbl.tap_w.data_ptr(),
        tbl.ring_f.data_ptr(), tbl.ring_b.data_ptr(), tbl.cfl.data_ptr(),
        tbl.cbl.data_ptr(), tbl.fan_w.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), cen_out.data_ptr(), S, Mp, NTL, nt, pad2 - SUB,
        block_taps, n_ring, len(chain_statics), chain_rep,
        n_chain, int(iters), int(dist.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"witer kernel launch failed: CUDA error {rc}")
    witer.launches += 1
    return out, cen_out


witer.launches = 0


# ----------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------


class WrappedState(NamedTuple):
    dist: torch.Tensor    # (Mp, S*NTL)
    dcen: torch.Tensor    # (S,)
    changed: bool
    it: int


def _solve_wrapped(dist0: torch.Tensor, cen0: torch.Tensor, tbl: WTables,
                   tol: torch.Tensor, st: WStatic, max_iters: int,
                   sweeps: int) -> WrappedState:
    """`witer` calls of `sweeps` iterations until no distance improves by
    more than `tol` (one host read of the flag per call)."""
    state = WrappedState(dist0, cen0, True, 0)
    while state.changed and state.it < max_iters:
        d, c = witer(st, state.dist, state.dcen, tbl, sweeps)
        changed = bool(((d < state.dist - tol).any()
                        | (c < state.dcen - tol).any()).item())
        state = WrappedState(d, c, changed, state.it + sweeps)
    return state


def _wextract(dist2d: torch.Tensor, cen: torch.Tensor, it: int, m_idx,
              c_idx, center_mask, valid, S: int, NTL: int) -> torch.Tensor:
    """(S, k+1) node-ordered values gathered on the device from the
    wrapped layout, the iteration count in the last column - one tensor,
    one copy to the host."""
    width = dist2d.shape[1]
    flat = dist2d.reshape(-1)
    base = m_idx * width + c_idx
    inf = torch.tensor(float("inf"), dtype=dist2d.dtype, device=dist2d.device)
    rows = []
    for b in range(S):
        g = torch.where(valid, flat[base + b * NTL], inf)
        rows.append(torch.where(center_mask, cen[b], g))
    vals = torch.stack(rows)
    itcol = torch.full((S, 1), float(it), dtype=dist2d.dtype,
                       device=dist2d.device)
    return torch.cat([vals, itcol], dim=1)


def check_chain_wrap(ws: WrappedStencil):
    """Raise unless every chain window cost that a wrapping roll meets is
    +inf (cfl[k][m] for m < span k, cbl[k][m] for m >= Mp - span k): the
    CUDA kernel reads +inf past the slot axis's ends instead of wrapping,
    which gives the same floats only then."""
    for k, span in enumerate(_chain_spans(ws.Mp)):
        if np.isfinite(ws.cfl[k, :span]).any() or \
                np.isfinite(ws.cbl[k, ws.Mp - span:]).any():
            raise ValueError(f"chain window costs of span {span} are finite "
                             f"where the scan wraps")


def device_wrapped_tables(ws: WrappedStencil, device) -> WTables:
    """The stencil's tables on `device`, cached in its dcache."""
    key = ("wrapped_device", str(device))
    if key not in ws.dcache:
        check_chain_wrap(ws)
        ws.dcache[key] = WTables(*(
            torch.tensor(a, device=device)
            for a in (ws.offs, ws.wpT, ws.ring_f, ws.ring_b, ws.cfl, ws.cbl,
                      ws.fan_w, *wrapped_tap_lists(ws))))
    return ws.dcache[key]


def solve_circulant_wrapped(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    sweeps_per_call: int = 4,
    vertical_closure: int = 0,
    batch: int = 1,
    receivers=None,
    weight_mode: str = "reduce",
    pre_roll: bool = False,
    device_out: bool = False,
    device="cuda",
    _packed: WrappedStencil = None,
) -> Tuple[np.ndarray, int]:
    """Solve source(s) with the full-iteration wrapped-lane kernel on
    `device`.

    Returns ((n_sources, n_out) host array, iterations); each iteration
    is one complete scans+sweep+fan pass, `sweeps_per_call` of them per
    kernel call.  `batch` > 1 solves that many sources per call, side by
    side as NTL-lane blocks (the last chunk repeats its final source to
    fill).  With `receivers` (node ids), only those columns are
    extracted on the device; device_out=True returns the rows as a
    tensor on the device.  `weight_mode` ('reduce' or 'transpose') and
    `pre_roll` chose VMEM layouts of the TPU kernel that give the same
    floats; they are accepted for parity with the JAX package and the
    port has one layout for all of them.  Check `supports_wrapped(cg)`
    before calling; solve_circulant_diag takes the other grids.
    """
    if not supports_wrapped(cg):
        raise ValueError("wrapped-lane kernel unsupported for this ntheta; "
                         "use solve_circulant_diag")
    if weight_mode not in ("reduce", "transpose"):
        raise ValueError(f"weight_mode must be 'reduce' or 'transpose', "
                         f"got {weight_mode!r}")
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ws = _packed if _packed is not None else pack_wrapped_stencil(
        cg, dtype=dtype, vertical_closure=vertical_closure)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    nt, Mp, NTL = ws.nt, ws.Mp, ws.NTL
    S = max(1, min(batch, len(sources)))
    st = WStatic(ws.rho_starts, Mp, NTL, ws.pad2, nt)
    tbl = device_wrapped_tables(ws, device)
    tdtype = tbl.wpT.dtype
    tol = torch.tensor(config.tol_value(), dtype=tdtype, device=device)
    n_out, ext = _extract_cached(ws.dcache, cmap, receivers, device)

    def dispatch(chunk):
        dist0 = torch.full((Mp, S * NTL), float("inf"), dtype=tdtype,
                           device=device)
        cen0 = torch.full((S,), float("inf"), dtype=tdtype, device=device)
        for b, src in enumerate(chunk):
            if src == cmap.center:
                cen0[b] = 0.0
            else:
                m, c = int(cmap.m_of[src]), int(cmap.c_of[src])
                # all duplicate lanes of theta c within block b
                dist0[m, b * NTL + c:(b + 1) * NTL:nt] = 0.0
        state = _solve_wrapped(dist0, cen0, tbl, tol, st, config.max_iters,
                               sweeps_per_call)
        return _wextract(state.dist, state.dcen, state.it, *ext, S, NTL)

    return _pipelined_chunk_solve(sources, S, n_out, dtype, dispatch,
                                  device_out=device_out)
