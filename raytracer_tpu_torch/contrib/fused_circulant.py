"""The whole circulant solve in one kernel launch ('fused' engine).

Counterpart of `raytracer_tpu/contrib/fused_circulant.py`.  The state is
(T, S*ntp, 128) (slot tiles x source-major theta rows x slot lanes), the
centre one value per source.  Each iteration of the loop

  1. snapshots the state and source 0's centre value;
  2. runs a truncated Hillis-Steele min-plus scan around every theta
     ring (shifts 1..128, the hop cost times the unreduced shift);
  3. runs a truncated min-plus scan along the flat slot axis of every
     row, down then up for each shift 1..64, with jump-cost tables;
  4. relaxes every tile with the lane-gather loop over the 5
     theta-rolled copies (the dc = 0 copy keeps the pad rows);
  5. exchanges with the centre: the new centre from the real rows, then
     every row, pad rows included, from the new centre;
  6. goes on while any value or the centre of source 0 fell.

`fused` runs the loop: on a CUDA tensor as one cooperative launch of the
hand-written kernel `csrc/fused.cu`, which reads the stencil as chunk
tables (`pallas_circulant.relax_chunks`, the relaxation of
`csrc/lane_gather.cuh` that `relax` shares); on a CPU tensor as its
plain twin
`fused_reference`, torch ops in the Pallas kernel's order.  The scans
only relax real graph edges, so truncating them moves the iteration
count, never the fixpoint.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.circulant import CirculantGraph, _DC_RANGE, resolve_device
# the chunk tables and their constants live beside `relax`, which reads
# them too; CHUNK, SLAB, WARPS and ROW_BLOCK stay importable from here
from .pallas_circulant import (CHUNK, LANES, ROW_BLOCK, ROW_PAD,  # noqa: F401
                               SLAB, WARPS, TiledStencil, _gather_min,
                               _round_up, check_tiled_stencil, extract,
                               initial_state, pack_tiled_stencil,
                               relax_chunks)

RING_STEPS = 8    # theta shifts 1..128 columns per iteration
CHAIN_STEPS = 7   # slot shifts 1..64 (within the adjacent lane tile)


def _chain_jump_tables(chain_w: np.ndarray,
                       T: int) -> Tuple[np.ndarray, np.ndarray]:
    """P_dn[k, m] = cost m-2^k -> m; P_up[k, m] = cost m+2^k -> m."""
    m_pad = T * LANES
    cw = chain_w.astype(np.float64)
    p_dn = np.full((CHAIN_STEPS, m_pad), np.inf)
    p_up = np.full((CHAIN_STEPS, m_pad), np.inf)
    # a jump of 2^(k+1) is the jump of 2^k twice
    d1 = np.full(m_pad, np.inf)
    d1[1:] = cw[:-1]           # cost (m-1 -> m)
    u1 = cw.copy()             # cost (m+1 -> m)
    p_dn[0], p_up[0] = d1, u1
    for k in range(1, CHAIN_STEPS):
        s = 1 << (k - 1)
        prev_d = p_dn[k - 1]
        shifted = np.full(m_pad, np.inf)
        shifted[s:] = prev_d[:-s]
        p_dn[k] = shifted + prev_d          # (m-2s -> m-s) + (m-s -> m)
        prev_u = p_up[k - 1]
        shifted = np.full(m_pad, np.inf)
        shifted[:-s] = prev_u[s:]
        p_up[k] = shifted + prev_u
    return p_dn, p_up


def relax_chunks_reference(x: torch.Tensor, tbl: "FusedTables",
                           st: "FusedStatic") -> torch.Tensor:
    """Plain evaluation of the relaxation through the chunk tables, as
    csrc/fused.cu reads them: the (T, S*ntp, 128) state with 2 wrapped
    theta rows above and below each source's real rows, then for every
    chunk the minimum over its rows of source + weight, a real row c
    reading row c + 2 + dc of the haloed copy and a pad row only its own
    row at dc = 0.  Returns the relaxed state (the minimum with x)."""
    T, nt, ntp, S = st
    x4 = x.view(T, S, ntp, LANES)
    halo = torch.cat([x4[:, :, nt - 2:nt], x4[:, :, :nt], x4[:, :, :2],
                      x4[:, :, nt:]], dim=2)            # (T, S, ntp + 4, 128)
    out = x4.clone()
    c = torch.arange(ntp, device=x.device)
    real = c < nt
    for (tg, n), row, idx, w in zip(tbl.ck_info.tolist(), tbl.ck_row,
                                    tbl.ck_idx, tbl.ck_w):
        t, g = divmod(tg & 0xFFFF, LANES // SLAB)
        n &= 0xFFFF
        row, idx, w = row[:n].long(), idx[:n].long(), w[:n]
        src_t, dc = row & 0xFFFF, (row >> 16) - 2
        q = torch.where(real[None, :], c[None, :] + 2 + dc[:, None],
                        c[None, :] + 4)                 # (n, ntp)
        keep = real[None, :] | (dc[:, None] == 0)
        h = halo[src_t]                                 # (n, S, ntp+4, 128)
        rows = torch.gather(h, 2, q[:, None, :, None].expand(-1, S, -1,
                                                             LANES))
        g_ = torch.gather(rows, 3, idx[:, None, None, :].expand(-1, S, ntp,
                                                                -1))
        cand = torch.where(keep[:, None, :, None], g_ + w[:, None, None, :],
                           torch.full((), float("inf"), dtype=x.dtype))
        sl = slice(g * SLAB, (g + 1) * SLAB)
        out[t, :, :, sl] = torch.minimum(out[t, :, :, sl], cand.amin(dim=0))
    return out.reshape(T, S * ntp, LANES)


class FusedTables(NamedTuple):
    """The fused loop's tables on one device: the packed stencil as
    `fused_reference` reads it, and its chunks as the kernel reads them."""

    offs: torch.Tensor     # (T+1,) int32
    u_of: torch.Tensor     # (K_tot,) int32
    idx: torch.Tensor      # (K_tot, 128) int32
    w: torch.Tensor        # (K_tot, 128)
    ring_w: torch.Tensor   # (T, 128)
    pdn: torch.Tensor      # (CHAIN_STEPS, T * 128)
    pup: torch.Tensor      # (CHAIN_STEPS, T * 128)
    fan_w: torch.Tensor    # (T, 128)
    ck_info: torch.Tensor  # RelaxChunks.info
    ck_row: torch.Tensor   # RelaxChunks.row
    ck_idx: torch.Tensor   # RelaxChunks.idx
    ck_w: torch.Tensor     # RelaxChunks.w


def device_fused_tables(ts: TiledStencil, device) -> FusedTables:
    check_tiled_stencil(ts)
    pdn, pup = _chain_jump_tables(ts.chain_w.astype(np.float64), ts.T)
    dtype = ts.w.dtype
    return FusedTables(*(torch.tensor(a, device=device) for a in (
        ts.offs, ts.u_of, ts.idx, ts.w, ts.ring_w, pdn.astype(dtype),
        pup.astype(dtype), ts.fan_w, *relax_chunks(ts))))


class FusedStatic(NamedTuple):
    T: int
    nt: int
    ntp: int
    S: int


def _relax_reference(x: torch.Tensor, tbl: "FusedTables",
                     st: "FusedStatic") -> torch.Tensor:
    """The Pallas kernel's relaxation of the (T, S*ntp, 128) state: its 5
    theta-rolled copies (the dc = 0 copy is the state itself, pad rows and
    all; the others +inf on pad rows) and its min-gather loop."""
    T, nt, ntp, S = st
    x4 = x.view(T, S, ntp, LANES)
    body = x4[:, :, :nt]
    rowpad = torch.full((T, S, ntp - nt, LANES), float("inf"),
                        dtype=x.dtype, device=x.device)
    copies = [x4 if d == 0 else
              torch.cat([torch.roll(body, -d, dims=2), rowpad], dim=2)
              for d in range(-_DC_RANGE, _DC_RANGE + 1)]
    R = torch.stack(copies, dim=0).reshape(5 * T, S * ntp, LANES)
    return _gather_min(R, x, tbl.offs, tbl.u_of, tbl.idx, tbl.w)


def fused_reference(state: torch.Tensor, cen: torch.Tensor,
                    tbl: FusedTables, st: FusedStatic,
                    max_iters: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain PyTorch twin of `fused`: the while loop of the JAX package's
    `_make_fused_kernel` in torch ops, one host read of the flag per
    iteration.  Returns (state, centre (S,), iterations)."""
    T, nt, ntp, S = st
    SR = S * ntp
    inf = float("inf")
    x = state.clone()
    cen = cen.clone()
    cost = tbl.ring_w[:, None, None, :]
    fan = tbl.fan_w[:, None, :]
    it, changed = 0, True
    while changed and it < max_iters:
        old, old_cen0 = x, cen[0]

        # ring scan: circular, uniform cost, Jacobi doubling steps
        x4 = x.view(T, S, ntp, LANES)
        blk = x4[:, :, :nt]
        shift = 1
        for _ in range(RING_STEPS):
            sh = shift % nt
            if sh != 0:  # whole-ring shifts are no-ops
                fwd = torch.roll(blk, -sh, dims=2)    # blk[(c + sh) % nt]
                bwd = torch.roll(blk, sh, dims=2)     # blk[(c - sh) % nt]
                blk = torch.minimum(blk, torch.minimum(fwd, bwd)
                                    + cost * shift)
            shift *= 2
        x = torch.cat([blk, x4[:, :, nt:]], dim=2).reshape(T, SR, LANES)

        # chain scan along the flat slot m = t * 128 + lane of each row
        flat = x.permute(1, 0, 2).reshape(SR, T * LANES)
        for k in range(CHAIN_STEPS):
            s = 1 << k
            pad = torch.full((SR, s), inf, dtype=x.dtype, device=x.device)
            down = torch.cat([pad, flat[:, :-s]], dim=1)       # d[m - s]
            flat = torch.minimum(flat, down + tbl.pdn[k])
            up = torch.cat([flat[:, s:], pad], dim=1)          # d[m + s]
            flat = torch.minimum(flat, up + tbl.pup[k])
        x = flat.reshape(SR, T, LANES).permute(1, 0, 2).contiguous()

        x = _relax_reference(x, tbl, st)

        # centre fan: the new centre from the real rows, then every row
        cand = (x + fan).amin(dim=2).amin(dim=0).view(S, ntp)[:, :nt]
        cen = torch.minimum(cand.amin(dim=1), cen)
        x = torch.minimum(x, cen.repeat_interleave(ntp)[None, :, None] + fan)

        changed = bool(((cen[0] < old_cen0) | (x < old).any()).item())
        it += 1
    return x, cen, it


def _check_fused_args(state, cen, tbl: FusedTables, st: FusedStatic):
    T, nt, ntp, S = st
    if not (3 <= nt <= ntp and ntp % ROW_PAD == 0 and S >= 1):
        raise ValueError(f"need 3 <= nt <= ntp, ntp % {ROW_PAD} == 0 and "
                         f"S >= 1, got {tuple(st)}")
    if tuple(state.shape) != (T, S * ntp, LANES):
        raise ValueError(f"state must be {(T, S * ntp, LANES)}, "
                         f"got {tuple(state.shape)}")
    if tuple(cen.shape) != (S,):
        raise ValueError(f"cen must be ({S},), got {tuple(cen.shape)}")
    K = tbl.idx.shape[0]
    want = {"offs": (T + 1,), "u_of": (K,), "idx": (K, LANES),
            "w": (K, LANES), "ring_w": (T, LANES),
            "pdn": (CHAIN_STEPS, T * LANES), "pup": (CHAIN_STEPS, T * LANES),
            "fan_w": (T, LANES)}
    n = tbl.ck_info.shape[0]
    want.update(ck_info=(n, 2), ck_row=(n, CHUNK), ck_idx=(n, CHUNK, SLAB),
                ck_w=(n, CHUNK, SLAB))
    for name, shape in want.items():
        t = getattr(tbl, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != state.device:
            raise ValueError(f"fused tensors on {t.device} and {state.device}")
    for t in (cen, tbl.w, tbl.ring_w, tbl.pdn, tbl.pup, tbl.fan_w, tbl.ck_w):
        if t.dtype != state.dtype:
            raise TypeError(f"fused tensors of {t.dtype} and {state.dtype}")


def _fused_lib(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """The kernel library (or `lib`, a build of the same interface) with
    the launch function's argument types set."""
    lib = kernels.load("fused") if lib is None else lib
    fn = lib.fused_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    return lib


def _fused_launch(x: torch.Tensor, c: torch.Tensor, tbl: FusedTables,
                  st: FusedStatic, max_iters: int,
                  lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """One launch of the kernel (or of `lib`'s fused_launch) on (x, c) in
    place; returns the iteration count as an int32 device scalar."""
    T, nt, ntp, S = st
    old = torch.empty_like(x)
    src = torch.empty((T, S, ntp + 4, LANES), dtype=x.dtype, device=x.device)
    flags = torch.zeros(2, dtype=torch.int32, device=x.device)
    iters = torch.zeros((), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fused_lib(lib).fused_launch(
        x.data_ptr(), c.data_ptr(), old.data_ptr(), src.data_ptr(),
        tbl.ring_w.data_ptr(), tbl.pdn.data_ptr(), tbl.pup.data_ptr(),
        tbl.fan_w.data_ptr(), tbl.ck_info.data_ptr(), tbl.ck_row.data_ptr(),
        tbl.ck_idx.data_ptr(), tbl.ck_w.data_ptr(), flags.data_ptr(),
        iters.data_ptr(), T, nt, ntp, S, tbl.ck_info.shape[0], max_iters,
        int(x.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"fused kernel launch failed: CUDA error {rc}")
    return iters


def fused(state: torch.Tensor, cen: torch.Tensor, tbl: FusedTables,
          st: FusedStatic,
          max_iters: int) -> Tuple[torch.Tensor, torch.Tensor, object]:
    """Run the whole loop from (state (T, S*ntp, 128), centre (S,));
    returns (state, centre, iterations), the inputs untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/fused.cu`, one
    cooperative launch per call (`fused.launches` counts them), and the
    iteration count comes back as an int32 device scalar that nothing
    reads unless the caller does; a CPU tensor goes to `fused_reference`
    and the count is an int.  Any other device raises.
    """
    _check_fused_args(state, cen, tbl, st)
    if state.device.type == "cpu":
        return fused_reference(state, cen, tbl, st, max_iters)
    if state.device.type != "cuda":
        raise ValueError(f"fused runs on cuda or cpu, not {state.device}")
    kernels.require_float("fused", state.dtype)
    if any(t.dtype != torch.int32 for t in (tbl.offs, tbl.u_of, tbl.idx,
                                            tbl.ck_info, tbl.ck_row,
                                            tbl.ck_idx)):
        raise TypeError("the fused kernel takes int32 offs, u_of, idx and "
                        "chunk tables")
    if not all(t.is_contiguous() for t in (state, cen, *tbl)):
        raise ValueError("fused takes contiguous tensors")
    x = state.clone()
    c = cen.clone()
    iters = _fused_launch(x, c, tbl, st, max_iters)
    fused.launches += 1
    return x, c, iters


fused.launches = 0


def solve_circulant_fused(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
    _packed: Optional[TiledStencil] = None,
    _dcache: Optional[dict] = None,
) -> Tuple[np.ndarray, int]:
    """Solve via the whole-loop kernel on `device` -> (dist (S, n), -1).

    The iteration count stays on the device, as in the JAX package; -1
    is returned in its place.  Pass a dict as `_dcache` to upload the
    tables once per device.
    """
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ts = _packed if _packed is not None else pack_tiled_stencil(cg, dtype)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    S = len(sources)
    nt, T = ts.ntheta, ts.T
    ntp = _round_up(nt, ROW_PAD)
    if _dcache is None:
        _dcache = {}
    key = ("fused", id(ts), str(device))
    if key not in _dcache:  # holds ts, so its id is not reused
        _dcache[key] = (ts, device_fused_tables(ts, device))
    _, tbl = _dcache[key]
    dist0, cen0 = initial_state(cg, sources, T, ntp, dtype)
    state, cen, _ = fused(
        torch.tensor(dist0.reshape(T, S * ntp, LANES), device=device),
        torch.tensor(cen0, device=device), tbl, FusedStatic(T, nt, ntp, S),
        config.max_iters)
    dist4 = state.cpu().numpy().reshape(T, S, ntp, LANES)
    return extract(cg, dist4, cen.cpu().numpy()), -1
