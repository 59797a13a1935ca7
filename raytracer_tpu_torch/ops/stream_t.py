"""Streamed theta-major Jacobi engine ('stream'), PyTorch port.

Counterpart of `raytracer_tpu/ops/stream_t.py`, the engine without a
size ceiling.  The distance field lives in device memory at its natural
(S, ntheta, ML) shape - no duplicate theta rows, so the theta wrap is an
exact `torch.roll`.  One iteration is

    ring scan (theta) -> chain scan (slots) -> band sweep -> centre fan

where the ring and chain scans are log-doubling min-plus scans in plain
tensor code, and the band sweep - (2*maxdm+1)*5 add+min taps per point,
the dominant cost - runs as the hand-written CUDA kernel `csrc/band.cu`
through the wrapper `band`, which takes the field and rolls theta in its
index arithmetic (its plain twin `band_reference` takes the TPU kernel's
5 theta-rolled pages and serves CPU tensors).  Iterations repeat
until no distance improves by more than `SolverConfig.tol`.

COARSE-TO-FINE WARM START (`warm_levels`): level l solves a
theta-coarsened circulant with nt/2**l columns whose edges are min-plus
compositions of fine hop pairs with even column step (every coarse
weight is a real fine path cost, see `_coarsen_theta`), then initialises
level l-1 with its field on the matching column parity.  Any upper-bound
initialisation keeps the label-correcting fixpoint, so the result is
exact; the iteration count drops at large ntheta.  Coarse levels stop at
the looser tolerance max(tol, 0.05) s; the finest always runs to `tol`.
The iteration count adds up over all levels.

Host tables are NumPy, copies of the JAX package's, and become tensors
once per device.  The staged solves (`masked_stream_tables`,
`solve_stream_staged`) are not ported yet (ROADMAP A.7).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from .circulant import CirculantGraph, _DC_RANGE, resolve_device
from .diag_circulant import decompose_diagonals
from .diag_wrapped import (_extract_cached, _pipelined_chunk_solve,
                           _window_costs)
from .wrapped_t import (NDC, TWStencil, _compose_band, _textract,
                        pack_tables_from_decomp, pack_twrapped_stencil)

# theta rows per band-sweep block of the TPU kernel; kept so that the
# level geometry (`LevelStatic.TB`) equals the JAX package's
_BLOCK_CHOICES = (512, 256, 128, 64, 32, 16, 8)
_BLOCK_VMEM_BUDGET = 64 * 1024 * 1024


def _pow_spans(cover: int):
    """Power-of-two spans (1, 2, 4, ...) whose doubling scan covers every
    offset in [0, cover): after applying span s to a field covering runs
    of length < s, coverage extends to < 2s."""
    spans, s, total = [], 1, 1
    while total < cover:
        spans.append(s)
        total += s
        s *= 2
    return tuple(spans) if spans else (1,)


class StreamTables(NamedTuple):
    """Tables of one level of the streamed path: NumPy arrays from
    `_stream_tables`, tensors after `_level_to_device`.

    wrows   : (R8, ML) moving-frame weight rows
    ring_f/b: (1, ML) per-slot ring hop costs
    cfp/cbp : (L, ML) forward/backward chain window costs for the
              power-of-two doubling spans
    fan_w   : (1, ML) centre<->slot fan weights
    """

    wrows: object
    ring_f: object
    ring_b: object
    cfp: object
    cbp: object
    fan_w: object


class LevelStatic(NamedTuple):
    """Static geometry of one level (TB is the TPU kernel's theta block;
    the CUDA kernel sweeps all nt rows at once)."""

    Mp: int
    ML: int
    nt: int
    maxdm: int
    chain_spans: Tuple[int, ...]
    TB: int


def _pick_block(nt: int, ML: int, wrows_rows: int, itemsize: int) -> int:
    for tb in _BLOCK_CHOICES:
        need = (2 * NDC * tb * ML + 3 * tb * ML + wrows_rows * ML) * itemsize
        if need <= _BLOCK_VMEM_BUDGET:
            return tb
    return _BLOCK_CHOICES[-1]


def _stream_tables(ws: TWStencil, dtype) -> Tuple[StreamTables, LevelStatic]:
    """Host tables and geometry of the level packed in `ws`, cached in
    its dcache."""
    key = "stream_tables"
    if key in ws.dcache:
        return ws.dcache[key]
    Mp, ML = ws.Mp, ws.ML
    # span-1 window cost IS the per-hop chain cost (cfl[0] by
    # construction in pack_twrapped_stencil)
    chain_f = np.asarray(ws.cfl[0, 0], dtype=np.float64)
    chain_b = np.asarray(ws.cbl[0, 0], dtype=np.float64)
    spans = _pow_spans(Mp)
    cfp = _window_costs(chain_f, spans)
    cbp = _window_costs(chain_b[::-1], spans)[:, ::-1]
    tables = StreamTables(
        wrows=np.asarray(ws.wrows), ring_f=np.asarray(ws.ring_f),
        ring_b=np.asarray(ws.ring_b),
        cfp=np.ascontiguousarray(cfp.astype(dtype)),
        cbp=np.ascontiguousarray(cbp.astype(dtype)),
        fan_w=np.asarray(ws.fan_w))
    static = LevelStatic(
        Mp=Mp, ML=ML, nt=ws.nt, maxdm=ws.maxdm, chain_spans=spans,
        TB=_pick_block(ws.nt, ML, ws.wrows.shape[0], np.dtype(dtype).itemsize),
    )
    ws.dcache[key] = (tables, static)
    return tables, static


def _level_to_device(ws: TWStencil, dtype, device
                     ) -> Tuple[StreamTables, LevelStatic]:
    """`_stream_tables` with the tables as tensors on `device`, cached in
    the stencil's dcache per device."""
    tables, static = _stream_tables(ws, dtype)
    key = ("stream_device", str(device))
    if key not in ws.dcache:
        ws.dcache[key] = StreamTables(*(torch.tensor(a, device=device)
                                        for a in tables))
    return ws.dcache[key], static


def _coarsen_theta(dms, dcs, wmat, pad_dm: int):
    """Theta-coarsen a diagonal decomposition by 2: hops between
    same-parity columns only - single fine hops with even dc plus every
    2-hop composition with even total dc, with dc relabelled in coarse
    column units (fine dc=+-2 -> coarse dc=+-1, composed |dc|<=4 ->
    coarse |dc|<=2).  Slots are NOT coarsened.  Every output weight is a
    real fine path cost (w1[m] + w2[m + dm1] walks hop 1 from slot m
    then hop 2 from its landing slot), so solving the coarse circulant
    yields exact upper bounds on the fine fixpoint at the matching
    columns - the warm-start validity condition.

    The composition is offset-invariant (the stencil is circulant), so
    one coarse stencil serves both even- and odd-parity column sets.
    """
    Mp = wmat.shape[1]
    n_dm = 2 * pad_dm + 1
    B = np.full((n_dm, NDC, Mp), np.inf)
    for d in range(len(dms)):
        i, j = int(dms[d]) + pad_dm, int(dcs[d]) + _DC_RANGE
        B[i, j] = np.minimum(B[i, j], wmat[d])

    NDC4 = 2 * 2 * _DC_RANGE + 1                 # |dc_total| <= 4, fine units
    out = np.full((n_dm, NDC4, Mp), np.inf)
    for dc in range(-_DC_RANGE, _DC_RANGE + 1):  # single even-dc hops
        if dc % 2 == 0:
            out[:, dc + 2 * _DC_RANGE, :] = B[:, dc + _DC_RANGE, :]

    for i1 in range(n_dm):
        dm1 = i1 - pad_dm
        blk1 = B[i1]
        if not np.isfinite(blk1).any():
            continue
        # hop-2 weights read at hop 1's landing slot: m -> m + dm1
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
            i2 = slice(max(0, -dm1), min(n_dm, n_dm - dm1))
            cand = w1[None, None, :] + sh[i2, :]
            tgt = out[i2.start + dm1: i2.stop + dm1,
                      dc1 - _DC_RANGE + 2 * _DC_RANGE:
                      dc1 + _DC_RANGE + 2 * _DC_RANGE + 1]
            np.minimum(tgt, cand, out=tgt)

    dms2, dcs2, rows = [], [], []
    for i in range(n_dm):
        for jt in range(0, NDC4, 2):             # even fine dc totals
            if i == pad_dm and jt == 2 * _DC_RANGE:
                continue                         # identity slot
            if np.isfinite(out[i, jt]).any():
                dms2.append(i - pad_dm)
                dcs2.append(jt // 2 - _DC_RANGE)  # coarse dc units
                rows.append(out[i, jt])
    return (np.asarray(dms2, np.asarray(dms).dtype),
            np.asarray(dcs2, np.asarray(dcs).dtype), np.stack(rows))


def _warm_stencils(ws: TWStencil, cg: CirculantGraph, dtype,
                   band_closure: int, levels: int):
    """Coarse-level stencils 1..L (level l has nt / 2**l columns), cached
    in the fine stencil's dcache.  Stops early when nt goes odd or the
    coarse ring would be trivially small."""
    key = ("warm", int(band_closure), int(levels))
    if key in ws.dcache:
        return ws.dcache[key]
    dec = decompose_diagonals(cg)
    dms, dcs, wmat = dec.dms, dec.dcs, dec.wmat.copy()
    if band_closure:
        dms, dcs, wmat = _compose_band(dms, dcs, wmat, dec.pad, band_closure)
    out = []
    nt = dec.nt
    for _ in range(levels):
        if nt % 2 or nt // 2 < 8:
            break
        dms, dcs, wmat = _coarsen_theta(dms, dcs, wmat, dec.pad)
        nt //= 2
        out.append(pack_tables_from_decomp(
            dms, dcs, wmat, dec.Mp, nt, dec.M,
            cg.fan_slots, cg.fan_w, dtype))
    ws.dcache[key] = out
    return out


# ----------------------------------------------------------------------
# the band sweep: CUDA kernel wrapper + plain twin
# ----------------------------------------------------------------------


def band_reference(stack: torch.Tensor, wrows: torch.Tensor,
                   maxdm: int) -> torch.Tensor:
    """Plain PyTorch twin of `band`, following the TPU kernel's body op
    for op (`_make_band_kernel` of the JAX package): a moving-frame
    accumulator rolled one lane per trip over the 2*maxdm+1 slot
    offsets, each trip taking the 5 pages plus their weight rows.
    stack (5, S, nt, ML) -> (S, nt, ML)."""
    ML = stack.shape[-1]
    n_dm = 2 * maxdm + 1
    cur = stack[_DC_RANGE]
    macc = torch.roll(cur, (ML - maxdm - 1) % ML, dims=-1)
    for t in range(n_dm):
        macc = torch.roll(macc, 1, dims=-1)
        for u5 in range(NDC):
            w = wrows[t * NDC + u5: t * NDC + u5 + 1, :]
            macc = torch.minimum(macc, stack[u5] + w)
    return torch.roll(macc, (ML - maxdm) % ML, dims=-1)


def _band_lib() -> ctypes.CDLL:
    lib = kernels.load("band")
    fn = lib.band_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    return lib


def _band_stack(v: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's input: the 5 theta-rolled pages of v (S, nt, ML),
    page u = v rolled by dc = u-2 rows (exact wrap) -> (5, S, nt, ML)."""
    return torch.stack([torch.roll(v, -dc, dims=1)
                        for dc in range(-_DC_RANGE, _DC_RANGE + 1)])


def band(v: torch.Tensor, wrows: torch.Tensor, maxdm: int) -> torch.Tensor:
    """Band sweep of the field v (S, nt, ML) with wrows (R8, ML), the
    moving-frame weight rows -> (S, nt, ML): what the TPU kernel computes
    on the 5 pages v rolled by dc = -2..2 theta rows.

    A CUDA tensor goes to the hand-written kernel `csrc/band.cu`, which
    rolls theta in its index arithmetic (on the current stream;
    `band.launches` counts its launches); a CPU tensor goes to
    `band_reference` on the stack of rolled pages.  Any other device
    raises.
    """
    if v.dim() != 3:
        raise ValueError(f"v must be (S, nt, ML), got {tuple(v.shape)}")
    ML = v.shape[-1]
    if wrows.dim() != 2 or wrows.shape[1] != ML \
            or wrows.shape[0] < (2 * maxdm + 1) * NDC or not 0 <= maxdm < ML:
        raise ValueError(f"wrows of shape {tuple(wrows.shape)} does not fit "
                         f"maxdm={maxdm} and ML={ML}")
    if v.device != wrows.device or v.dtype != wrows.dtype:
        raise ValueError(f"v ({v.device}, {v.dtype}) and wrows "
                         f"({wrows.device}, {wrows.dtype}) differ")
    if v.device.type == "cpu":
        return band_reference(_band_stack(v), wrows, maxdm)
    if v.device.type != "cuda":
        raise ValueError(f"band runs on cuda or cpu, not {v.device}")
    kernels.require_float32("band", v.dtype)
    if not (v.is_contiguous() and wrows.is_contiguous()):
        raise ValueError("band takes contiguous tensors")
    S, nt, _ = v.shape
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = _band_lib().band_launch(v.data_ptr(), wrows.data_ptr(),
                                 out.data_ptr(), S, nt, ML, maxdm, stream)
    if rc != 0:
        raise RuntimeError(f"band kernel launch failed: CUDA error {rc}")
    band.launches += 1
    return out


band.launches = 0


# ----------------------------------------------------------------------
# the level loop and the solve
# ----------------------------------------------------------------------


class StreamState(NamedTuple):
    dist: torch.Tensor    # (S, nt, ML)
    cen: torch.Tensor     # (S,)
    changed: bool
    it: int


def _run_level(dist0, cen0, it0: int, tbl: StreamTables, st: LevelStatic,
               tol, max_iters: int) -> StreamState:
    """One level's iterations from an explicit initial field, until no
    distance improves by more than `tol` (read once per iteration) or
    the iteration count reaches `max_iters`."""
    Mp, ML, nt, maxdm, chain_spans, TB = st
    wrows, rf, rb, cfp, cbp, fan = tbl

    def ring_scan(v):
        s = 1
        while s < nt:
            v = torch.minimum(v, torch.roll(v, s, dims=1) + s * rf)
            s *= 2
        s = 1
        while s < nt:
            v = torch.minimum(v, torch.roll(v, -s, dims=1) + s * rb)
            s *= 2
        return v

    def chain_scan(v):
        # +inf window-boundary costs make lane-wrap reads self-masking
        for k, s in enumerate(chain_spans):
            v = torch.minimum(v, torch.roll(v, s, dims=2) + cfp[k])
        for k, s in enumerate(chain_spans):
            v = torch.minimum(v, torch.roll(v, -s, dims=2) + cbp[k])
        return v

    v, cen, it, changed = dist0, cen0, it0, True
    while changed and it < max_iters:
        v_old, cen_old = v, cen
        v = band(chain_scan(ring_scan(v)), wrows, maxdm)
        cen = torch.minimum(cen, (v + fan).amin(dim=(1, 2)))
        v = torch.minimum(v, cen[:, None, None] + fan)
        changed = bool(((v < v_old - tol).any()
                        | (cen < cen_old - tol).any()).item())
        it += 1
    return StreamState(v, cen, changed, it)


def _solve_stream(src_m, src_c, src_cen, tbls, tol, tol_coarse,
                  statics: Tuple[LevelStatic, ...], max_iters: int
                  ) -> StreamState:
    """Multi-level streamed solve from (S,) source descriptors.

    tbls/statics: level 0 = finest, last = coarsest (len 1 = cold solve).
    """
    dev = tbls[0].wrows.device
    dtype = tbls[0].wrows.dtype
    L = len(statics) - 1
    src_c = np.asarray(src_c, dtype=np.int64)

    # source column / parity chain down the levels: a coarse column j at
    # level l+1 is fine column 2*j + par_l at level l (the circulant
    # stencil is offset-invariant, so odd-parity sources coarsen onto
    # the odd column set with the same tables)
    cols = [src_c]
    pars = []
    for _ in range(L):
        pars.append(cols[-1] % 2)
        cols.append(cols[-1] // 2)

    S = len(src_c)
    ntL, MLL = statics[L].nt, statics[L].ML
    dist0 = torch.full((S, ntL, MLL), float("inf"), dtype=dtype, device=dev)
    cen0 = torch.full((S,), float("inf"), dtype=dtype, device=dev)
    for b in range(S):
        if src_cen[b]:
            cen0[b] = 0.0
        else:
            dist0[b, int(cols[L][b]), int(src_m[b])] = 0.0

    st = _run_level(dist0, cen0, 0, tbls[L], statics[L],
                    tol if L == 0 else tol_coarse, max_iters)
    for lv in range(L - 1, -1, -1):
        Mp, MLl, ntl = statics[lv].Mp, statics[lv].ML, statics[lv].nt
        up = st.dist[:, torch.arange(ntl, device=dev) // 2, :Mp]
        up = torch.nn.functional.pad(up, (0, MLl - Mp), value=float("inf"))
        col = torch.arange(ntl, device=dev)[None, :, None]
        par = torch.as_tensor(pars[lv], device=dev)[:, None, None]
        fine0 = torch.where(col % 2 == par, up,
                            torch.tensor(float("inf"), dtype=dtype,
                                         device=dev))
        st = _run_level(fine0, st.cen, st.it, tbls[lv], statics[lv],
                        tol if lv == 0 else tol_coarse, max_iters)
    return st


def auto_warm_levels(nt: int) -> int:
    """The JAX package's measured warm-level policy: the coarse chain paid
    off on its TPU in a narrow column-count window around ~1080 and lost
    outside it.  Kept as it is so that both packages take the same
    levels; not re-measured on the GPU."""
    return 1 if 1000 <= nt <= 1200 else 0


def solve_circulant_stream(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    band_closure: int = 0,
    warm_levels: int = None,
    batch: int = 1,
    receivers=None,
    device_out: bool = False,
    device="cuda",
    _packed: TWStencil = None,
) -> Tuple[np.ndarray, int]:
    """Streamed theta-major solve on `device`; API mirrors
    solve_circulant_twrapped (sources in chunks of `batch`, optional
    on-device receiver extraction, device_out for rows left on the
    device).  Works at any grid size.

    warm_levels > 0 runs the coarse-to-fine chain (exact; see module
    docstring); None takes config.warm_levels, and None there takes
    `auto_warm_levels`.
    """
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=dtype, band_closure=band_closure)
    if warm_levels is None:
        warm_levels = config.warm_levels
    if warm_levels is None:
        warm_levels = auto_warm_levels(ws.nt)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    S = max(1, min(batch, len(sources)))

    levels = [ws]
    if warm_levels:
        levels += _warm_stencils(ws, cg, dtype, band_closure, warm_levels)
    tbls, statics = zip(*(_level_to_device(w, dtype, device) for w in levels))
    tdtype = tbls[0].wrows.dtype
    tol = torch.tensor(config.tol_value(), dtype=tdtype, device=device)
    tol_coarse = torch.tensor(max(config.tol_value(), 0.05), dtype=tdtype,
                              device=device)
    n_out, ext = _extract_cached(ws.dcache, cmap, receivers, device)

    def dispatch(chunk):
        is_cen = chunk == cmap.center
        src_m = np.where(is_cen, 0, cmap.m_of[chunk])
        src_c = np.where(is_cen, 0, cmap.c_of[chunk])
        st = _solve_stream(src_m, src_c, is_cen, tbls, tol, tol_coarse,
                           statics, config.max_iters)
        return _textract(st.dist, st.cen, st.it, *ext)

    return _pipelined_chunk_solve(sources, S, n_out, dtype, dispatch,
                                  device_out=device_out)
