"""Shared helpers of the batched circulant solvers.

A copy of the host table helpers of `raytracer_tpu/ops/diag_wrapped.py`
(chain spans, min-plus window costs, the vertical band closure) plus the
chunked-solve protocol and the node-extraction index arrays, with the
device arrays as torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

CHAIN_REPEAT = 32  # repeat span of the chain scan (statics cover 1..31)


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
