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
hand-written kernel `csrc/diag.cu`, which reads the field itself through
per-row lists of the finite taps; on a CPU tensor as its plain twin
`diag_sweep_reference`, which follows the Pallas kernel op for op over
the TPU's 40-copy source stack (`_build_source_stack`).  The ring
(theta) and chain (slot) min-plus scans that accelerate the solve were
plain XLA ops in the JAX package; here `ring_scan` and `chain_scan` run
them as the CUDA kernels of `csrc/diag_scans.cuh` and, on the CPU, as
their plain twins `_ring_scan` and `_chain_scan`, torch ops in the same
order of floating-point operations.  `diag_step` runs one iteration of
the solve (the scans, the sweep, the centre fan and the changed test) in
one launch call on the card, so `solve_circulant_diag` reads the host
once an iteration; it runs the sources one after another until no
distance improves by more than `SolverConfig.tol`.

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
# per-row tap lists (csrc/diag.cu and csrc/witer.cu read their band so)
# ----------------------------------------------------------------------

# the band tile of csrc/diag.cu and csrc/witer.cu: BAND_ROWS slot rows x
# BAND_LANES lanes a block, or 32 lanes where the window and the block's
# taps do not fit in BLOCK_SMEM bytes, BAND_LANE_HALO window lanes each
# side (kRows, 32 * kLpt, kLaneHalo and kSmemBudget there; `band_tile`
# makes the kernels' choice)
BAND_ROWS = 8
BAND_LANES = 64
BAND_LANE_HALO = 4
BLOCK_SMEM = 227 * 1024


class TapLists(NamedTuple):
    """A band's finite taps listed per row (`row_tap_lists`).  Row m's
    entries are [ptr[m], ptr[m+1]); an entry is a diagonal (dm, dc) whose
    weight w for row m is finite and whose source row m + dm lies in
    [0, Mp) (any other tap reads +inf)."""

    ptr: np.ndarray    # (Mp+1,) int32
    dmdc: np.ndarray   # (E,) int32, dm << 16 | (dc & 0xffff)
    w: np.ndarray      # (E,) the stencil's dtype


def row_tap_lists(taps: np.ndarray, W: np.ndarray, halo: int) -> TapLists:
    """Per-row lists of the diagonals' finite weights, by row, then
    diagonal: taps (D, 2) the diagonals' (dm, dc), W (D, Mp) their
    weights by row.  Raises ValueError where a tap reaches past `halo`
    rows or two theta lanes (a kernel's window holds no more)."""
    Mp = W.shape[1]
    taps = np.asarray(taps, np.int64)
    m, j = np.nonzero(np.isfinite(W).T)             # row-major: by row
    dm, dc = taps[j, 0], taps[j, 1]
    keep = (m + dm >= 0) & (m + dm < Mp)
    m, j, dm, dc = m[keep], j[keep], dm[keep], dc[keep]
    if len(dm) and (np.abs(dm).max() > halo
                    or np.abs(dc).max() > _DC_RANGE):
        raise ValueError("a tap reaches past the stencil's row padding or "
                         "two theta lanes")
    ptr = np.zeros(Mp + 1, np.int64)
    np.cumsum(np.bincount(m, minlength=Mp), out=ptr[1:])
    dmdc = (dm << 16) | (dc & 0xFFFF)
    return TapLists(ptr.astype(np.int32), dmdc.astype(np.int32), W[j, m])


def band_block_taps(tap_ptr: np.ndarray) -> int:
    """The most taps a band block reads: the entries of BAND_ROWS
    consecutive rows from a multiple of BAND_ROWS."""
    ptr = np.asarray(tap_ptr, np.int64)
    m0 = np.arange(0, len(ptr) - 1, BAND_ROWS)
    ends = np.minimum(m0 + BAND_ROWS, len(ptr) - 1)
    return int((ptr[ends] - ptr[m0]).max(initial=0))


def _block_taps(tap_ptr: torch.Tensor) -> int:
    """`band_block_taps` of the tensor, computed once and kept on it
    (again if it is modified in place)."""
    cache = getattr(tap_ptr, "_block_taps", None)
    if cache is None or cache[0] != tap_ptr._version:
        cache = (tap_ptr._version, band_block_taps(tap_ptr.cpu().numpy()))
        tap_ptr._block_taps = cache
    return cache[1]


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
    the TPU kernel's form (read by the twin), the per-row tap lists in
    the CUDA kernel's (`diag_tap_lists`: the same diagonals' finite
    weights)."""

    offs: torch.Tensor      # (D,) int32 flat source-stack offsets
    wp: torch.Tensor        # (G, Mp, 128) lane-packed weights
    tap_ptr: torch.Tensor   # (Mp+1,) int32
    tap_dmdc: torch.Tensor  # (E,) int32, dm << 16 | (dc & 0xffff)
    tap_w: torch.Tensor     # (E,) weights


def diag_taps(ds: DiagStencil) -> np.ndarray:
    """(D, 2) int32 (dm, dc) of each diagonal, decoded from the TPU
    kernel's stack index and offset."""
    rows_r = ds.Mp + 2 * ds.pad - SUB
    u = ds.u_idx.astype(np.int64)
    rho = u % SUB
    dc = u // SUB - _DC_RANGE
    dm = ds.offs.astype(np.int64) - u * rows_r - ds.pad + rho
    return np.stack([dm, dc], axis=1).astype(np.int32)


def diag_tap_lists(ds: DiagStencil) -> TapLists:
    """Per-row lists of the diagonals' finite weights (`row_tap_lists`),
    as csrc/diag.cu reads them: at most D entries a row."""
    d_ids = np.arange(ds.D)
    return row_tap_lists(diag_taps(ds), ds.wp[d_ids // LANES, :, d_ids % LANES],
                         ds.pad)


def device_diag_tables(ds: DiagStencil, device) -> DiagTables:
    return DiagTables(*(torch.tensor(a, device=device)
                        for a in (ds.offs, ds.wp, *diag_tap_lists(ds))))


def band_tile(halo: int, itemsize: int, block_taps: int, what: str):
    """(band lanes a block, taps staged in shared memory): the tile a band
    kernel takes for a window of BAND_ROWS + 2 * halo rows - BAND_LANES
    lanes with the block's taps beside the window, else 32, else the
    taps read from global memory.  Raises ValueError naming `what` where
    even the 32-lane window needs more shared memory than an H100 block
    may have (BLOCK_SMEM bytes); the kernels refuse such a launch too."""
    tap = 8 if itemsize == 4 else 16            # sizeof(Tap<T>) there

    def smem(lanes, taps):
        window = (BAND_ROWS + 2 * halo) * (lanes + 2 * BAND_LANE_HALO)
        return _round_up(window * itemsize, 16) + taps * tap

    for staged in (True, False):
        for lanes in (BAND_LANES, 32):
            if smem(lanes, block_taps if staged else 0) <= BLOCK_SMEM:
                return lanes, staged
    raise ValueError(f"{what} of {BAND_ROWS} + 2 x {halo} rows x 40 lanes "
                     f"needs {smem(32, 0)} bytes of shared memory, more "
                     f"than the {BLOCK_SMEM // 1024} KB an H100 block may "
                     f"have")


def diag_launch_plan(st: DiagStatic, itemsize: int, block_taps: int):
    """(sweep lanes a block, taps staged in shared memory): csrc/diag.cu's
    tile for this geometry and dtype (`band_tile`, the halo the stencil's
    row padding)."""
    return band_tile(st.pad, itemsize, block_taps,
                     "the diag kernel's sweep window")


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


def diag_tiles_reference(st: DiagStatic, dist: torch.Tensor,
                         tbl: DiagTables, lanes: int = BAND_LANES
                         ) -> torch.Tensor:
    """csrc/diag.cu's sweep in plain torch ops: the same floats as
    `diag_sweep_reference` by another route.  Each tile of BAND_ROWS rows
    x `lanes` lanes (BAND_LANES or 32, the kernel's two tiles) reads a
    flat window of BAND_ROWS + 2 * pad rows (rows outside [0, Mp) +inf)
    by lanes + 8, window lane p holding lane p mod nt, and each row's tap
    list (`tap_ptr`, `tap_dmdc`, `tap_w`) at the offset dm * width + dc
    from the row's own point; lanes [nt, NTL) come out +inf."""
    D, Mp, NTL, pad, nt = st
    R, H, LH = BAND_ROWS, pad, BAND_LANE_HALO
    WW = lanes + 2 * LH
    dev = dist.device
    inf = float("inf")
    n_rt = -(-Mp // R)
    cnt = (tbl.tap_ptr[1:] - tbl.tap_ptr[:-1]).long()
    m_e = torch.repeat_interleave(torch.arange(Mp, device=dev), cnt)
    code = tbl.tap_dmdc.long()
    dm_e = code >> 16
    dc_e = ((code & 0xFFFF) ^ 0x8000) - 0x8000
    at_e = ((m_e // R) * ((R + 2 * H) * WW) + (H + m_e % R) * WW + LH
            + dm_e * WW + dc_e)
    rows_w = (torch.arange(n_rt, device=dev)[:, None] * R - H
              + torch.arange(R + 2 * H, device=dev)[None, :])  # (n_rt, R+2H)
    row_ok = (rows_w >= 0) & (rows_w < Mp)
    lane_j = torch.arange(lanes, device=dev)
    y = torch.full_like(dist, inf)
    for l0 in range(0, NTL, lanes):
        lp = torch.arange(l0 - LH, l0 + lanes + LH, device=dev) % nt
        src = dist[rows_w.clamp(0, Mp - 1)][:, :, lp]
        win = torch.where(row_ok[:, :, None], src, inf).reshape(-1)
        cand = win[at_e[:, None] + lane_j[None, :]] + tbl.tap_w[:, None]
        acc = dist[:, l0:l0 + lanes].clone()
        acc.scatter_reduce_(0, m_e[:, None].expand(-1, lanes), cand, "amin")
        real = (l0 + lane_j) < nt
        y[:, l0:l0 + lanes] = torch.where(real[None, :], acc, inf)
    return y


def _check_diag_args(st: DiagStatic, dist: torch.Tensor, tbl: DiagTables):
    D, Mp, NTL, pad, nt = st
    if tuple(dist.shape) != (Mp, NTL):
        raise ValueError(f"dist must be ({Mp}, {NTL}), got {tuple(dist.shape)}")
    G = _round_up(D, LANES) // LANES
    E = tbl.tap_w.shape[0]
    want = {"offs": (D,), "wp": (G, Mp, LANES), "tap_ptr": (Mp + 1,),
            "tap_dmdc": (E,), "tap_w": (E,)}
    for name, shape in want.items():
        t = getattr(tbl, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dist.device:
            raise ValueError(f"diag_sweep tensors on {t.device} and "
                             f"{dist.device}")
    for t in (tbl.wp, tbl.tap_w):
        if t.dtype != dist.dtype:
            raise TypeError(f"diag_sweep tensors of {t.dtype} and {dist.dtype}")


def _diag_lib() -> ctypes.CDLL:
    """csrc/diag.cu's library: diag_launch, ring_scan_launch and
    chain_scan_launch."""
    lib = kernels.load("diag")
    if lib.diag_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn, args in (
                (lib.diag_launch, [P] * 5 + [I] * 6 + [P] * 12 + [I] * 3 + [P]),
                (lib.ring_scan_launch, [P] * 4 + [I] * 5 + [P]),
                (lib.chain_scan_launch, [P] * 4 + [I] * 4 + [P])):
            fn.restype = I
            fn.argtypes = args
    return lib


def _check_cuda(name: str, dist: torch.Tensor, *tensors):
    if dist.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dist.device}")
    if not all(t.is_contiguous() for t in (dist,) + tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _diag_launch(st: DiagStatic, dist: torch.Tensor, tbl: DiagTables,
                 sc=None, old=None, dcen=None, tol=None, scan=False):
    """csrc/diag.cu on the current stream: the sweep alone, or (sc given)
    the sweep, the fan and the changed test, after the ring and chain
    scans with `scan`.  Counts `diag_sweep.launches`, and the scans'
    launches.  Returns (out, dcen', flag) with dcen' and flag None for
    the sweep alone."""
    D, Mp, NTL, pad, nt = st
    if tbl.tap_ptr.dtype != torch.int32 or tbl.tap_dmdc.dtype != torch.int32:
        raise TypeError("the diag kernel takes int32 tap lists")
    block_taps = _block_taps(tbl.tap_ptr)
    item = dist.element_size()
    lanes, staged = diag_launch_plan(st, item, block_taps)
    out = torch.empty_like(dist)
    cen_out = flag = None
    ptrs = [None] * 12
    warps = cols = 0
    if sc is not None:
        cen_out = torch.empty_like(dcen)
        flag = torch.empty((), dtype=torch.int32, device=dist.device)
        part = torch.empty(-(-Mp // BAND_ROWS) * (NTL // lanes),
                           dtype=dist.dtype, device=dist.device)
        ptrs[:7] = [t.data_ptr() for t in (sc.fan_w, old, dcen, cen_out, tol,
                                           part, flag)]
        if scan:
            warps, cols = scan_launch_plan(Mp, NTL, item)
            work = torch.empty((2, Mp, NTL), dtype=dist.dtype,
                               device=dist.device)
            ptrs[7:] = [t.data_ptr() for t in (sc.ring_f, sc.ring_b,
                                               sc.tree_f, sc.tree_b, work)]
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    rc = _diag_lib().diag_launch(
        dist.data_ptr(), tbl.tap_ptr.data_ptr(), tbl.tap_dmdc.data_ptr(),
        tbl.tap_w.data_ptr(), out.data_ptr(), Mp, NTL, nt, pad,
        block_taps if staged else 0, lanes, *ptrs, warps, cols,
        int(dist.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"diag kernel launch failed: CUDA error {rc}")
    diag_sweep.launches += 1
    if scan:
        ring_scan.launches += 1
        chain_scan.launches += 1
    return out, cen_out, flag


def diag_sweep(st: DiagStatic, dist: torch.Tensor,
               tbl: DiagTables) -> torch.Tensor:
    """One relaxation sweep of the (Mp, NTL) field; returns a new field,
    lanes [nt, NTL) at +inf, the input untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/diag.cu` (float32
    or float64; `diag_sweep.launches` counts its launches, the ones
    `diag_step` makes too); a grid whose window would not fit an H100
    block raises ValueError (`diag_launch_plan`).  A CPU tensor goes to
    `diag_sweep_reference`.  Any other device raises.
    """
    _check_diag_args(st, dist, tbl)
    if dist.device.type == "cpu":
        return diag_sweep_reference(st, dist, tbl)
    _check_cuda("diag_sweep", dist, tbl.tap_ptr, tbl.tap_dmdc, tbl.tap_w)
    kernels.require_float("diag", dist.dtype)
    return _diag_launch(st, dist, tbl)[0]


diag_sweep.launches = 0


def diag_step_reference(st: DiagStatic, dist: torch.Tensor, tbl: DiagTables,
                        sc: "DiagScanTables", old: torch.Tensor,
                        dcen: torch.Tensor, tol: torch.Tensor,
                        scan: bool = False):
    """Plain PyTorch twin of `diag_step`: (with `scan`) the ring and chain
    scans, the sweep, then the loop body's centre fan and changed test of
    the JAX package's `_solve_diag_jit` op for op (old: the iteration's
    field before its scans).  Returns (field, centre, changed as a 0-d
    bool tensor)."""
    if scan:
        dist = _chain_scan(_ring_scan(dist, sc.ring_f, sc.ring_b, st.nt),
                           sc.chain_f, sc.chain_b)
    d = diag_sweep_reference(st, dist, tbl)
    # centre fan exchange; lane_mask keeps theta padding at +inf
    c = torch.minimum(dcen, (d + sc.fan_w).min())
    d = torch.minimum(d, c + sc.fan_w + sc.lane_mask)
    changed = (d < old - tol).any() | (c < dcen - tol)
    return d, c, changed


def diag_step(st: DiagStatic, dist: torch.Tensor, tbl: DiagTables,
              sc: "DiagScanTables", old: torch.Tensor, dcen: torch.Tensor,
              tol: torch.Tensor, scan: bool = False):
    """One iteration of the diag engine on the (Mp, NTL) field: (with
    `scan`) the ring and chain scans, one sweep, and the centre fan and
    changed test after it; returns (field, centre, changed flag) on the
    field's device, the inputs untouched.

    A CUDA tensor goes to `csrc/diag.cu` in one call: the scan kernels
    (csrc/diag_scans.cuh), the sweep kernel, which folds each block's
    min(field + fan) into a partial, and a second kernel that applies
    the fan and sets an int32 flag (1: changed), so the caller reads the
    host once an iteration; `diag_sweep.launches`, and with `scan`
    `ring_scan.launches` and `chain_scan.launches`, count the call.  A
    CPU tensor goes to `diag_step_reference` (the flag a bool).
    """
    _check_diag_args(st, dist, tbl)
    _check_scan_args("diag_step", dist, sc)
    for t in (old, dcen, tol):
        if t.device != dist.device or t.dtype != dist.dtype:
            raise TypeError(f"diag_step tensors of {t.dtype} on {t.device} "
                            f"and {dist.dtype} on {dist.device}")
    if dist.device.type == "cpu":
        return diag_step_reference(st, dist, tbl, sc, old, dcen, tol, scan)
    _check_cuda("diag_step", dist, old, dcen, tol, tbl.tap_ptr, tbl.tap_dmdc,
                tbl.tap_w, *sc)
    kernels.require_float("diag", dist.dtype)
    return _diag_launch(st, dist, tbl, sc, old, dcen, tol, scan)


# ----------------------------------------------------------------------
# scan accelerators (theta on lanes / slots on rows): CUDA kernels in
# csrc/diag_scans.cuh (launched through csrc/diag.cu) and their plain
# twins, torch ops in the JAX package's order
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


def _chain_costs(chain_f: torch.Tensor, chain_b: torch.Tensor):
    """The forward and backward per-row costs of the chain scan: cost[i]
    = weight of the edge i-1 -> i in the scan's own row order, +inf at
    its first row (the backward costs are chain_b reversed)."""
    inf = float("inf")
    cf = chain_f.clone()
    cf[0] = inf
    cb = torch.flip(chain_b, dims=[0]).clone()
    cb[0] = inf
    return cf, cb


def _chain_scan(dist: torch.Tensor, chain_f: torch.Tensor,
                chain_b: torch.Tensor) -> torch.Tensor:
    """Linear min-plus scan along the slot (row) axis, both directions.

    cost_f[i] = weight of the same-column edge (i-1 -> i); +inf breaks the
    chain exactly (inf propagates through the (sum, min) combine).  The
    sum component depends on the row only, so it is scanned as an
    (Mp, 1) column: the same floats as the JAX package's broadcast one.
    """
    cf, cb = _chain_costs(chain_f, chain_b)
    out = dist
    for cost, flip in ((cf[:, None], False), (cb[:, None], True)):
        x = torch.flip(dist, dims=[0]) if flip else dist
        _, scanned = _sum_min_scan(cost, x)
        if flip:
            scanned = torch.flip(scanned, dims=[0])
        out = torch.minimum(out, scanned)
    return out


def chain_sum_tree(cost: np.ndarray) -> np.ndarray:
    """The sum component of `_sum_min_scan` on the per-row costs, every
    level l of the recursion that pairs (floor(Mp / 2^l) >= 2 values)
    concatenated in order: level l + 1 is s[0:n-1:2] + s[1::2] of level
    l in the costs' dtype, the recursion's own sums.  csrc/diag_scans.cuh
    reads it in place of scanning the sums on the card."""
    levels, s = [], np.asarray(cost)
    while len(s) >= 2:
        levels.append(s)
        n = len(s)
        s = s[0:n - 1:2] + s[1::2]
    return (np.concatenate(levels) if levels
            else np.zeros(0, np.asarray(cost).dtype))


def chain_tree_reference(dist: torch.Tensor, tree_f: torch.Tensor,
                         tree_b: torch.Tensor) -> torch.Tensor:
    """csrc/diag_scans.cuh's chain scan in plain torch ops: the same floats
    as `_chain_scan` by another route.  The min component alone, level by
    level in place (value i of level l at row (i + 1) * 2^l - 1), up:
    m[p] = min(m[p - 2^l] + s_l[2i+1], m[p]) at p = (2i+2) * 2^l - 1;
    down: m[q] = min(m[q - 2^l] + s_l[2i], m[q]) at q = (2i+1) * 2^l - 1,
    i >= 1; with the sums s_l read from the packed trees
    (`chain_sum_tree`); the backward direction on the reversed rows."""
    Mp = dist.shape[0]
    ns = []
    n = Mp
    while n >= 2:
        ns.append(n)
        n >>= 1
    offs = np.concatenate([[0], np.cumsum(ns)]).astype(np.int64)

    def scan(x, tree):
        a = x.clone()
        for lev, n in enumerate(ns):              # up
            i = torch.arange(n // 2, device=x.device)
            p = ((2 * i + 2) << lev) - 1
            s = tree[offs[lev] + 2 * i + 1][:, None]
            a[p] = torch.minimum(a[p - (1 << lev)] + s, a[p])
        for lev in range(len(ns) - 1, -1, -1):    # down
            n = ns[lev]
            i = torch.arange(1, (n - 1) // 2 + 1, device=x.device)
            q = ((2 * i + 1) << lev) - 1
            s = tree[offs[lev] + 2 * i][:, None]
            a[q] = torch.minimum(a[q - (1 << lev)] + s, a[q])
        return a

    fwd = scan(dist, tree_f)
    bwd = torch.flip(scan(torch.flip(dist, dims=[0]), tree_b), dims=[0])
    return torch.minimum(torch.minimum(dist, fwd), bwd)


# csrc/diag_scans.cuh's blocks: at most RING_WARPS rows a ring block, and
# a chain block's lane columns: 16 bytes of a row, fewer where its tiles
# do not fit
RING_WARPS = 8


def scan_launch_plan(Mp: int, NTL: int, itemsize: int):
    """(ring rows a block, chain lane columns a block) of
    csrc/diag_scans.cuh: a ring row keeps 2 x NTL values in shared memory,
    a chain block both directions' Mp x columns tiles (16 bytes of a row,
    else 2 or 1 columns).  Raises ValueError
    where one row or one column needs more than an H100 block may have
    (BLOCK_SMEM bytes); the kernels refuse such a launch too."""
    row = 2 * NTL * itemsize
    if row > BLOCK_SMEM:
        raise ValueError(f"the diag ring scan keeps 2 x {NTL} lanes of a row "
                         f"in shared memory: more than the "
                         f"{BLOCK_SMEM // 1024} KB an H100 block may have")
    warps = min(RING_WARPS, BLOCK_SMEM // row)
    for cols in (16 // itemsize, 2, 1):
        if NTL % cols == 0 and 2 * Mp * cols * itemsize <= BLOCK_SMEM:
            return warps, cols
    raise ValueError(f"the diag chain scan keeps 2 x {Mp} slots of a lane "
                     f"column in shared memory: more than the "
                     f"{BLOCK_SMEM // 1024} KB an H100 block may have")


class DiagScanTables(NamedTuple):
    """The scans' and the fan's tables on one device."""

    ring_f: torch.Tensor     # (Mp, 1)
    ring_b: torch.Tensor     # (Mp, 1)
    chain_f: torch.Tensor    # (Mp,)
    chain_b: torch.Tensor    # (Mp,)
    fan_w: torch.Tensor      # (Mp, 1)
    lane_mask: torch.Tensor  # (1, NTL): 0 on theta lanes, +inf beyond
    tree_f: torch.Tensor     # chain_sum_tree of the forward costs
    tree_b: torch.Tensor     # chain_sum_tree of the backward costs


def _check_scan_args(name, dist, sc: DiagScanTables):
    Mp = dist.shape[0]
    for t in sc:
        if t.device != dist.device or t.dtype != dist.dtype:
            raise TypeError(f"{name} tensors of {t.dtype} on {t.device} and "
                            f"{dist.dtype} on {dist.device}")
    if dist.dim() != 2 or sc.ring_f.shape != (Mp, 1) \
            or sc.chain_f.shape != (Mp,):
        raise ValueError(f"{name}: dist (Mp, NTL) and tables of Mp rows, got "
                         f"{tuple(dist.shape)} and {tuple(sc.ring_f.shape)}")
    tree = (sum(Mp >> k for k in range(Mp.bit_length()) if Mp >> k >= 2),)
    if sc.tree_f.shape != tree or sc.tree_b.shape != tree:
        raise ValueError(f"{name}: tree_f {tuple(sc.tree_f.shape)} and tree_b "
                         f"{tuple(sc.tree_b.shape)} are no sum trees of {Mp} "
                         f"rows")


def ring_scan(dist: torch.Tensor, sc: DiagScanTables, nt: int
              ) -> torch.Tensor:
    """The ring scan of the (Mp, NTL) field; returns a new field, lanes
    [nt, NTL) copied.  A CUDA tensor goes to the hand-written kernel of
    `csrc/diag_scans.cuh` (`ring_scan.launches` counts its launches); a CPU
    tensor to `_ring_scan`.  Any other device raises."""
    _check_scan_args("ring_scan", dist, sc)
    if dist.device.type == "cpu":
        return _ring_scan(dist, sc.ring_f, sc.ring_b, nt)
    _check_cuda("ring_scan", dist, sc.ring_f, sc.ring_b)
    kernels.require_float("ring_scan", dist.dtype)
    Mp, NTL = dist.shape
    warps, _ = scan_launch_plan(Mp, NTL, dist.element_size())
    out = torch.empty_like(dist)
    rc = _diag_lib().ring_scan_launch(
        dist.data_ptr(), sc.ring_f.data_ptr(), sc.ring_b.data_ptr(),
        out.data_ptr(), Mp, NTL, nt, warps, int(dist.dtype == torch.float64),
        torch.cuda.current_stream(dist.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring_scan kernel launch failed: CUDA error {rc}")
    ring_scan.launches += 1
    return out


ring_scan.launches = 0


def chain_scan(dist: torch.Tensor, sc: DiagScanTables) -> torch.Tensor:
    """The chain scan of the (Mp, NTL) field; returns a new field.  A CUDA
    tensor goes to the hand-written kernel of `csrc/diag_scans.cuh` with
    the packed sum trees (`chain_scan.launches` counts its launches); a CPU
    tensor to `_chain_scan`.  Any other device raises."""
    _check_scan_args("chain_scan", dist, sc)
    if dist.device.type == "cpu":
        return _chain_scan(dist, sc.chain_f, sc.chain_b)
    _check_cuda("chain_scan", dist, sc.tree_f, sc.tree_b)
    kernels.require_float("chain_scan", dist.dtype)
    Mp, NTL = dist.shape
    _, cols = scan_launch_plan(Mp, NTL, dist.element_size())
    out = torch.empty_like(dist)
    rc = _diag_lib().chain_scan_launch(
        dist.data_ptr(), sc.tree_f.data_ptr(), sc.tree_b.data_ptr(),
        out.data_ptr(), Mp, NTL, cols, int(dist.dtype == torch.float64),
        torch.cuda.current_stream(dist.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chain_scan kernel launch failed: CUDA error {rc}")
    chain_scan.launches += 1
    return out


chain_scan.launches = 0


# ----------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------


class DiagState(NamedTuple):
    dist: torch.Tensor    # (Mp, NTL)
    dcen: torch.Tensor    # ()
    changed: bool
    it: int


def _solve_diag(dist0: torch.Tensor, dcen0: torch.Tensor, tbl: DiagTables,
                sc: DiagScanTables, tol: torch.Tensor, st: DiagStatic,
                max_iters: int, scan_every: int) -> DiagState:
    """One source's solve: one `diag_step` per iteration (the scans every
    `scan_every` iterations, the sweep, the centre fan and the changed
    test), until no distance improves by more than `tol` (one host read of
    the flag per iteration)."""
    s = DiagState(dist0, dcen0, True, 0)
    while s.changed and s.it < max_iters:
        scan = scan_every == 1 or (scan_every > 1 and s.it % scan_every == 0)
        d, dcen, changed = diag_step(st, s.dist, tbl, sc, s.dist, s.dcen, tol,
                                     scan)
        s = DiagState(d, dcen, bool(changed.item()), s.it + 1)
    return s


def device_diag_scan_tables(ds: DiagStencil, device) -> DiagScanTables:
    lane_mask = np.zeros((1, ds.NTL), dtype=ds.wp.dtype)
    lane_mask[0, ds.ntheta:] = np.inf
    cf, cb = _chain_costs(torch.from_numpy(ds.chain_f),
                          torch.from_numpy(ds.chain_b))
    return DiagScanTables(*(torch.tensor(a, device=device) for a in (
        ds.ring_f, ds.ring_b, ds.chain_f, ds.chain_b, ds.fan_w, lane_mask,
        chain_sum_tree(cf.numpy()), chain_sum_tree(cb.numpy()))))


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
