"""Diagonal-band relaxation of the circulant stencil ('diag' engine).

Counterpart of `raytracer_tpu/ops/diag_circulant.py`.  Writing each
stencil edge as (m_dst -> m_dst + dm at column offset dc), the stencil
is band-limited (|dm| <= ~56, |dc| <= 2) with at most one entry per
(m_dst, dm, dc) triple, so one relaxation sweep decomposes into D
"diagonals", each a shifted whole-array add+min:

    out[m, c] = min(dist[m, c], min_d dist[m + dm_d, (c + dc_d) mod nt]
                                      + w_d[m])

on the (Mp slot rows, NTL theta lanes) field, lanes [nt, NTL) held at
+inf.  `diag_sweep` runs one sweep: on a CUDA tensor as the
hand-written kernel `csrc/diag.cu`, which reads the field itself; on a
CPU tensor as its plain twin `diag_sweep_reference`, which follows the
Pallas kernel op for op over the TPU's 40-copy source stack
(`_build_source_stack`).  The ring (theta) and chain (slot) min-plus
scans that accelerate the solve were plain XLA ops in the JAX package
and are plain torch ops here (`_ring_scan`, `_chain_scan`), in the same
order of floating-point operations.  `solve_circulant_diag` runs the
sources one after another, one sweep per iteration, until no distance
improves by more than `SolverConfig.tol`.

The host decomposition and packing are NumPy, copies of the JAX
package's.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from .circulant import CirculantGraph, _DC_RANGE, resolve_device

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


@dataclasses.dataclass(frozen=True)
class DiagStencil:
    """Diagonal decomposition of the circulant stencil, packed for the
    TPU kernel's 40-copy source stack (the JAX package's fields).

    u_idx : (D,) int32 - index into the source stack (dc + 2) * 8 + (dm mod 8)
    offs  : (D,) int32 - 8-aligned flat row offset of the diagonal's slice
    wp    : (G, Mp, 128) lane-packed per-diagonal weights (+inf absent);
            diagonal d lives in wp[d // 128, :, d % 128]
    ring_f/ring_b : (Mp, 1) per-slot ring hop cost into (m, c) from
            (m, c-1) / (m, c+1) (+inf where the ring is broken)
    chain_f/chain_b : (Mp,) per-slot chain cost into slot m from m-1 / m+1
    fan_w : (Mp, 1) centre<->slot weights (+inf off the fan)
    pad   : row padding (multiple of 8, >= max |dm|)
    """

    u_idx: np.ndarray
    offs: np.ndarray
    wp: np.ndarray
    ring_f: np.ndarray
    ring_b: np.ndarray
    chain_f: np.ndarray
    chain_b: np.ndarray
    fan_w: np.ndarray
    pad: int
    D: int
    Mp: int
    M: int
    ntheta: int
    NTL: int


def pack_diag_stencil(cg: CirculantGraph, dtype=np.float32) -> DiagStencil:
    """Pack the diagonal decomposition for the 40-copy source-stack kernel."""
    dec = decompose_diagonals(cg)
    dms, dcs, wmat = dec.dms, dec.dcs, dec.wmat
    pad, D, Mp, M, nt, NTL = dec.pad, dec.D, dec.Mp, dec.M, dec.nt, dec.NTL

    rho = np.mod(dms, SUB)
    rows_r = Mp + 2 * pad - SUB
    u_idx = ((dcs + _DC_RANGE) * SUB + rho).astype(np.int32)
    # flat row offset into the concatenated 2-D source stack
    offs = (u_idx.astype(np.int64) * rows_r + (pad + dms - rho)).astype(np.int32)
    assert offs.min() >= 0 and np.all(offs % SUB == 0)

    G = _round_up(D, LANES) // LANES
    wp = np.full((G, Mp, LANES), np.inf)
    d_ids = np.arange(D)
    wp[d_ids // LANES, :, d_ids % LANES] = wmat

    def _diag_vec(dm0: int, dc0: int) -> np.ndarray:
        hit = (dms == dm0) & (dcs == dc0)
        out = np.full(Mp, np.inf)
        if hit.any():
            out[:] = wmat[int(np.flatnonzero(hit)[0])]
        return out

    ring_f = _diag_vec(0, -1)[:, None]
    ring_b = _diag_vec(0, +1)[:, None]
    chain_f = _diag_vec(-1, 0)
    chain_b = _diag_vec(+1, 0)

    fan_w = np.full((Mp, 1), np.inf)
    fan_w[cg.fan_slots, 0] = cg.fan_w

    return DiagStencil(
        u_idx=u_idx, offs=offs, wp=wp.astype(dtype),
        ring_f=ring_f.astype(dtype), ring_b=ring_b.astype(dtype),
        chain_f=chain_f.astype(dtype), chain_b=chain_b.astype(dtype),
        fan_w=fan_w.astype(dtype),
        pad=pad, D=D, Mp=Mp, M=M, ntheta=nt, NTL=NTL,
    )


# ----------------------------------------------------------------------
# one relaxation sweep: CUDA kernel wrapper + plain twin
# ----------------------------------------------------------------------


class DiagStatic(NamedTuple):
    """Static geometry of the sweep (the JAX `ds_meta`)."""

    D: int
    Mp: int
    NTL: int
    pad: int
    nt: int


class DiagTables(NamedTuple):
    """The sweep's tables as tensors on one device: `offs` and `wp` in
    the TPU kernel's form (read by the twin), `taps` and `wT` in the
    CUDA kernel's (the same diagonals and weights)."""

    offs: torch.Tensor   # (D,) int32 flat source-stack offsets
    wp: torch.Tensor     # (G, Mp, 128) lane-packed weights
    taps: torch.Tensor   # (D, 2) int32 (dm, dc) of each diagonal
    wT: torch.Tensor     # (D, Mp) weights, row d = diagonal d


def diag_taps(ds: DiagStencil) -> np.ndarray:
    """(D, 2) int32 (dm, dc) of each diagonal, decoded from the TPU
    kernel's stack index and offset."""
    rows_r = ds.Mp + 2 * ds.pad - SUB
    u = ds.u_idx.astype(np.int64)
    rho = u % SUB
    dc = u // SUB - _DC_RANGE
    dm = ds.offs.astype(np.int64) - u * rows_r - ds.pad + rho
    return np.stack([dm, dc], axis=1).astype(np.int32)


def device_diag_tables(ds: DiagStencil, device) -> DiagTables:
    d_ids = np.arange(ds.D)
    wT = np.ascontiguousarray(ds.wp[d_ids // LANES, :, d_ids % LANES])
    return DiagTables(*(torch.tensor(a, device=device)
                        for a in (ds.offs, ds.wp, diag_taps(ds), wT)))


def _build_source_stack(dist: torch.Tensor, nt: int, pad: int) -> torch.Tensor:
    """(40 * rows_r, NTL) concatenation of theta-rolled, row-shifted
    copies, as the TPU kernel reads them.

    Copy u = (dc + 2) * 8 + rho occupies rows [u * rows_r, (u+1) * rows_r)
    with rows_r = Mp + 2*pad - 8; the flat slice [offs, offs + Mp) with
    offs = u * rows_r + pad + dm - rho (rho = dm mod 8, hence 8-aligned)
    equals dist[m + dm, c + dc] (rows outside [0, M) read +inf padding;
    lanes nt.. stay +inf).
    """
    Mp, NTL = dist.shape
    body = dist[:, :nt]
    rows_r = Mp + 2 * pad - SUB
    cops = []
    rowpad = torch.full((pad, NTL), float("inf"), dtype=dist.dtype,
                        device=dist.device)
    lanepad = torch.full((Mp, NTL - nt), float("inf"), dtype=dist.dtype,
                         device=dist.device)
    for dci in range(-_DC_RANGE, _DC_RANGE + 1):
        r = torch.roll(body, -dci, dims=1)
        if NTL != nt:
            r = torch.cat([r, lanepad], dim=1)
        q = torch.cat([rowpad, r, rowpad], dim=0)  # (Mp + 2*pad, NTL)
        for rho in range(SUB):
            cops.append(q[rho:rho + rows_r])
    return torch.cat(cops, dim=0)


def diag_sweep_reference(st: DiagStatic, dist: torch.Tensor,
                         tbl: DiagTables) -> torch.Tensor:
    """Plain PyTorch twin of `diag_sweep`, op for op the Pallas kernel
    (`_make_diag_kernel` of the JAX package) over the 40-copy stack."""
    D, Mp, NTL, pad, nt = st
    rows_r = Mp + 2 * pad - SUB
    stack = _build_source_stack(dist, nt, pad)
    # the dc=0, rho=0 copy at offset `pad` is the unshifted old distance
    base = _DC_RANGE * SUB * rows_r + pad
    acc = stack[base:base + Mp]
    for d, o in enumerate(tbl.offs.tolist()):
        wcol = tbl.wp[d // LANES, :, d % LANES][:, None]
        acc = torch.minimum(acc, stack[o:o + Mp] + wcol)
    return acc


def _check_diag_args(st: DiagStatic, dist: torch.Tensor, tbl: DiagTables):
    D, Mp, NTL, pad, nt = st
    if tuple(dist.shape) != (Mp, NTL):
        raise ValueError(f"dist must be ({Mp}, {NTL}), got {tuple(dist.shape)}")
    G = _round_up(D, LANES) // LANES
    want = {"offs": (D,), "wp": (G, Mp, LANES), "taps": (D, 2),
            "wT": (D, Mp)}
    for name, shape in want.items():
        t = getattr(tbl, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dist.device:
            raise ValueError(f"diag_sweep tensors on {t.device} and "
                             f"{dist.device}")
    for t in (tbl.wp, tbl.wT):
        if t.dtype != dist.dtype:
            raise TypeError(f"diag_sweep tensors of {t.dtype} and {dist.dtype}")


def _diag_lib() -> ctypes.CDLL:
    lib = kernels.load("diag")
    fn = lib.diag_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    return lib


def diag_sweep(st: DiagStatic, dist: torch.Tensor,
               tbl: DiagTables) -> torch.Tensor:
    """One relaxation sweep of the (Mp, NTL) field; returns a new field,
    lanes [nt, NTL) at +inf, the input untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/diag.cu`
    (`diag_sweep.launches` counts its launches); a CPU tensor goes to
    `diag_sweep_reference`.  Any other device raises.
    """
    _check_diag_args(st, dist, tbl)
    if dist.device.type == "cpu":
        return diag_sweep_reference(st, dist, tbl)
    if dist.device.type != "cuda":
        raise ValueError(f"diag_sweep runs on cuda or cpu, not {dist.device}")
    kernels.require_float32("diag", dist.dtype)
    if tbl.taps.dtype != torch.int32:
        raise TypeError("the diag kernel takes int32 taps")
    if not all(t.is_contiguous() for t in (dist, tbl.taps, tbl.wT)):
        raise ValueError("diag_sweep takes contiguous tensors")
    D, Mp, NTL, pad, nt = st
    out = torch.empty_like(dist)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    rc = _diag_lib().diag_launch(dist.data_ptr(), tbl.taps.data_ptr(),
                                 tbl.wT.data_ptr(), out.data_ptr(), D, Mp,
                                 NTL, nt, stream)
    if rc != 0:
        raise RuntimeError(f"diag kernel launch failed: CUDA error {rc}")
    diag_sweep.launches += 1
    return out


diag_sweep.launches = 0


# ----------------------------------------------------------------------
# scan accelerators (plain torch ops, theta on lanes / slots on rows)
# ----------------------------------------------------------------------


def _ring_scan(dist: torch.Tensor, ring_f: torch.Tensor,
               ring_b: torch.Tensor, nt: int) -> torch.Tensor:
    """Exact circular min-plus relaxation along every theta ring.

    Uniform per-hop cost along each ring (rotational symmetry), so the
    circular scan has a closed form in cumulative minima, in the JAX
    package's order of operations.  dist (Mp, NTL)."""
    body = dist[:, :nt]
    j = torch.arange(nt, dtype=dist.dtype, device=dist.device)[None, :]

    def one_direction(b, c):
        base = b - j * c
        pref = torch.cummin(base, dim=1).values
        suff = torch.flip(torch.cummin(torch.flip(base, dims=[1]), dim=1)
                          .values, dims=[1])
        inner = pref + j * c
        wrap = suff + float(nt) * c + j * c
        return torch.minimum(inner, wrap)

    out = body
    for rw, flip in ((ring_f, False), (ring_b, True)):
        finite = torch.isfinite(rw)
        c = torch.where(finite, rw, torch.zeros((), dtype=rw.dtype,
                                                device=rw.device))
        b = torch.flip(body, dims=[1]) if flip else body
        res = one_direction(b, c)
        if flip:
            res = torch.flip(res, dims=[1])
        out = torch.minimum(out, torch.where(finite, res, body))
    if dist.shape[1] != nt:
        out = torch.cat([out, dist[:, nt:]], dim=1)
    return out


def _sum_min_scan(s: torch.Tensor, m: torch.Tensor):
    """Inclusive scan along dim 0 of (sum, min) pairs under
    combine(a, b) = (sa + sb, min(ma + sb, mb)), by the recursion of
    `jax.lax.associative_scan` (pairs, recurse on the odd half, fix up
    the even half, interleave), so the f32 sums round as JAX's do."""
    n = m.shape[0]
    if n < 2:
        return s, m
    rs = s[0:n - 1:2] + s[1::2]
    rm = torch.minimum(m[0:n - 1:2] + s[1::2], m[1::2])
    os_, om = _sum_min_scan(rs, rm)
    a_s, a_m = (os_[:-1], om[:-1]) if n % 2 == 0 else (os_, om)
    es = torch.cat([s[:1], a_s + s[2::2]])
    em = torch.cat([m[:1], torch.minimum(a_m + s[2::2], m[2::2])])
    out_s = torch.empty((n,) + tuple(s.shape[1:]), dtype=s.dtype,
                        device=s.device)
    out_m = torch.empty_like(m)
    out_s[0::2], out_s[1::2] = es, os_
    out_m[0::2], out_m[1::2] = em, om
    return out_s, out_m


def _chain_scan(dist: torch.Tensor, chain_f: torch.Tensor,
                chain_b: torch.Tensor) -> torch.Tensor:
    """Linear min-plus scan along the slot (row) axis, both directions.

    cost_f[i] = weight of the same-column edge (i-1 -> i); +inf breaks the
    chain exactly (inf propagates through the (sum, min) combine).  The
    sum component depends on the row only, so it is scanned as an
    (Mp, 1) column: the same floats as the JAX package's broadcast one.
    """
    inf = float("inf")
    cf = chain_f.clone()
    cf[0] = inf
    cb = torch.flip(chain_b, dims=[0]).clone()
    cb[0] = inf
    out = dist
    for cost, flip in ((cf[:, None], False), (cb[:, None], True)):
        x = torch.flip(dist, dims=[0]) if flip else dist
        _, scanned = _sum_min_scan(cost, x)
        if flip:
            scanned = torch.flip(scanned, dims=[0])
        out = torch.minimum(out, scanned)
    return out


# ----------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------


class DiagState(NamedTuple):
    dist: torch.Tensor    # (Mp, NTL)
    dcen: torch.Tensor    # ()
    changed: bool
    it: int


class DiagScanTables(NamedTuple):
    """The scans' and the fan's tables on one device."""

    ring_f: torch.Tensor     # (Mp, 1)
    ring_b: torch.Tensor     # (Mp, 1)
    chain_f: torch.Tensor    # (Mp,)
    chain_b: torch.Tensor    # (Mp,)
    fan_w: torch.Tensor      # (Mp, 1)
    lane_mask: torch.Tensor  # (1, NTL): 0 on theta lanes, +inf beyond


def _solve_diag(dist0: torch.Tensor, dcen0: torch.Tensor, tbl: DiagTables,
                sc: DiagScanTables, tol: torch.Tensor, st: DiagStatic,
                max_iters: int, scan_every: int) -> DiagState:
    """One source's solve: (scans every `scan_every` iterations) + one
    `diag_sweep` + the centre fan per iteration, until no distance
    improves by more than `tol` (one host read of the flag per
    iteration)."""
    nt = st.nt

    def scans(x):
        return _chain_scan(_ring_scan(x, sc.ring_f, sc.ring_b, nt),
                           sc.chain_f, sc.chain_b)

    s = DiagState(dist0, dcen0, True, 0)
    while s.changed and s.it < max_iters:
        d = s.dist
        if scan_every == 1 or (scan_every > 1 and s.it % scan_every == 0):
            d = scans(d)
        d = diag_sweep(st, d, tbl)
        # centre fan exchange; lane_mask keeps theta padding at +inf
        dcen = torch.minimum(s.dcen, (d + sc.fan_w).min())
        d = torch.minimum(d, dcen + sc.fan_w + sc.lane_mask)
        changed = bool(((d < s.dist - tol).any()
                        | (dcen < s.dcen - tol)).item())
        s = DiagState(d, dcen, changed, s.it + 1)
    return s


def device_diag_scan_tables(ds: DiagStencil, device) -> DiagScanTables:
    lane_mask = np.zeros((1, ds.NTL), dtype=ds.wp.dtype)
    lane_mask[0, ds.ntheta:] = np.inf
    return DiagScanTables(*(torch.tensor(a, device=device) for a in (
        ds.ring_f, ds.ring_b, ds.chain_f, ds.chain_b, ds.fan_w, lane_mask)))


def solve_circulant_diag(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    scan_every: int = 1,
    device="cuda",
    _packed: Optional[DiagStencil] = None,
    _dcache: Optional[dict] = None,
) -> Tuple[np.ndarray, int]:
    """Solve source(s) with the diagonal-band sweep on `device`; returns
    (dist (S, n) host array, iterations of the last source).

    Sources run one after another, as in the JAX package.  `scan_every`
    runs the ring and chain scans every that many iterations (1: every
    iteration, 0: never).  Pass a dict as `_dcache` to upload the tables
    once per device.
    """
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ds = _packed if _packed is not None else pack_diag_stencil(cg, dtype=dtype)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    nt, Mp, NTL = ds.ntheta, ds.Mp, ds.NTL
    if _dcache is None:
        _dcache = {}
    key = ("diag", id(ds), str(device))
    if key not in _dcache:  # holds ds, so its id is not reused
        _dcache[key] = (ds, device_diag_tables(ds, device),
                        device_diag_scan_tables(ds, device))
    _, tbl, sc = _dcache[key]
    st = DiagStatic(ds.D, Mp, NTL, ds.pad, nt)
    tdtype = tbl.wp.dtype
    tol = torch.tensor(config.tol_value(), dtype=tdtype, device=device)
    inf = float("inf")

    out = np.empty((len(sources), cg.n), dtype=dtype)
    iters = 0
    valid = cmap.m_of >= 0
    for si, src in enumerate(sources):
        dist0 = torch.full((Mp, NTL), inf, dtype=tdtype, device=device)
        if src == cmap.center:
            dcen0 = torch.zeros((), dtype=tdtype, device=device)
        else:
            dcen0 = torch.full((), inf, dtype=tdtype, device=device)
            dist0[int(cmap.m_of[src]), int(cmap.c_of[src])] = 0.0
        s = _solve_diag(dist0, dcen0, tbl, sc, tol, st, config.max_iters,
                        scan_every)
        dist2d = s.dist.cpu().numpy()
        out[si, valid] = dist2d[cmap.m_of[valid], cmap.c_of[valid]]
        if cmap.center >= 0:
            out[si, cmap.center] = float(s.dcen)
        iters = s.it
    return out, iters
