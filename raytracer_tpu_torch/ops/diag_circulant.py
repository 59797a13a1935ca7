"""(dm, dc)-diagonal decomposition of the circulant stencil (host NumPy).

A copy of `raytracer_tpu/ops/diag_circulant.py`'s decomposition.  Writing
each stencil edge as (m_dst -> m_dst + dm at column offset dc), the
stencil is band-limited (|dm| <= ~48, |dc| <= 2) with at most one entry
per (m_dst, dm, dc) triple, so the whole relaxation decomposes into D
"diagonals", each a shifted whole-array add+min.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .circulant import CirculantGraph, _DC_RANGE

LANES = 128
SUB = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DiagDecomposition(NamedTuple):
    """Raw (dm, dc)-diagonal decomposition of a circulant stencil."""

    dms: np.ndarray    # (D,) row offsets
    dcs: np.ndarray    # (D,) theta-column offsets, |dc| <= _DC_RANGE
    wmat: np.ndarray   # (D, Mp) per-diagonal weights, +inf where absent
    pad: int           # multiple of 8, >= max |dm|
    D: int
    Mp: int
    M: int
    nt: int
    NTL: int


def decompose_diagonals(cg: CirculantGraph) -> DiagDecomposition:
    """Decompose the verified circulant stencil into (dm, dc) diagonals."""
    M, K = cg.src_flat.shape
    nt = cg.ntheta
    Mp = _round_up(M, SUB)
    NTL = _round_up(nt, LANES)

    flat = cg.src_flat.astype(np.int64)
    w = cg.w.astype(np.float64)
    valid = np.isfinite(w)
    dc = flat // M - _DC_RANGE
    m_src = flat % M
    m_dst = np.broadcast_to(np.arange(M)[:, None], (M, K))
    dm = m_src - m_dst

    rr, kk = np.nonzero(valid)
    dm_e, dc_e, md_e, w_e = dm[rr, kk], dc[rr, kk], m_dst[rr, kk], w[rr, kk]

    pad = _round_up(int(np.abs(dm_e).max()), SUB)

    # unique diagonals, sorted (dc, dm) for determinism
    keys = dc_e * (4 * pad) + dm_e
    uniq, inv = np.unique(keys, return_inverse=True)
    D = len(uniq)
    dcs = np.round(uniq / (4 * pad)).astype(np.int64)
    dms = uniq - dcs * (4 * pad)
    assert np.all((dcs >= -_DC_RANGE) & (dcs <= _DC_RANGE))
    assert np.all(np.abs(dms) <= pad)

    # at most one entry per (m_dst, diagonal) - guaranteed because an edge's
    # (m_src, dc) pair is unique per m_dst in the packed ELL; verify anyway
    wmat = np.full((D, Mp), np.inf)
    if len(rr):
        wmat[inv, md_e] = w_e
        counts = np.zeros((D, Mp), dtype=np.int32)
        np.add.at(counts, (inv, md_e), 1)
        if counts.max() > 1:
            raise ValueError("stencil has duplicate (m, dm, dc) entries")
    return DiagDecomposition(dms=dms, dcs=dcs, wmat=wmat, pad=pad,
                             D=D, Mp=Mp, M=M, nt=nt, NTL=NTL)
