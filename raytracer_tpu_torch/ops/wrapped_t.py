"""Theta-major stencil tables (host NumPy) and receiver extraction.

A copy of the table packing of `raytracer_tpu/ops/wrapped_t.py`: the
sweep solver takes its fan row, its geometry (Mp, ML, nt) and its table
cache from a closure-free `TWStencil`.  The Jacobi kernel that consumes
the rest of these tables (the 'twrapped' method) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .circulant import CirculantGraph, _DC_RANGE
from .diag_circulant import LANES, SUB, _round_up, decompose_diagonals
from .diag_wrapped import _chain_spans, _window_costs

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


def supports_twrapped(cg: CirculantGraph) -> bool:
    """Same wrap condition as the slot-major kernel, on the 8-row cover:
    every defect row needs a defect-free twin."""
    nt = cg.ntheta
    NTT = _round_up(nt, SUB)
    dup = NTT - nt
    return nt >= SUB and (dup == 0 or dup >= _DC_RANGE)


def pack_twrapped_stencil(cg: CirculantGraph, dtype=np.float32,
                          band_closure: int = 0) -> TWStencil:
    """Theta-major stencil tables; the sweep solver packs it with
    band_closure=0 and keeps its own tables in `dcache`."""
    dec = decompose_diagonals(cg)
    dms, dcs, wmat = dec.dms, dec.dcs, dec.wmat.copy()
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
    S, nt, ML = dist.shape
    flat = dist.reshape(S, nt * ML)
    g = flat[:, c_idx * ML + m_idx]                      # (S, k)
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    g = torch.where(valid[None, :], g, inf)
    vals = torch.where(center_mask[None, :], cen[:, None], g)
    itcol = torch.full((S, 1), float(it), dtype=dist.dtype,
                       device=dist.device)
    return torch.cat([vals, itcol], dim=1)
