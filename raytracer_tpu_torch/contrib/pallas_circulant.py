"""Lane-gather relaxation of the circulant stencil ('pallas' engine).

Counterpart of `raytracer_tpu/contrib/pallas_circulant.py`.  The distance
state is (T, S, ntp, 128): slot tiles x sources x theta rows (ntheta
padded to a multiple of 8) x slot lanes.  One relaxation sweep is

    out[t, s, c, l] = min(dist[t, s, c, l], min over the stencil rows k of
        tile t of dist[u_k % T, s, (c + dc_k) mod nt, idx[k, l]] + w[k, l])

with dc_k = u_k // T - 2 and pad rows (c >= nt) at +inf.  `relax` runs
one sweep: on a CUDA tensor as the hand-written kernel `csrc/relax.cu`,
which reads the stencil as chunk tables (`relax_chunks`) and rolls theta
while it stages each item's source window; on a CPU tensor as its plain
twin `relax_reference`, which builds the TPU kernel's 5 theta-rolled
copies and runs its min-gather loop.  Around it, as plain torch ops in
the JAX package's order of floating-point operations: the ring scan (an
exact circular min-plus scan along theta in closed form), the slot scan
(a min-plus scan along the radial slot chains) and the centre fan.
`solve_circulant_pallas` batches the sources along the rows and iterates
until no distance improves by more than `SolverConfig.tol`.

The host packer is NumPy, a copy of the JAX package's.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.circulant import CirculantGraph, _DC_RANGE, resolve_device
from ..ops.diag_circulant import _sum_min_scan

LANES = 128
ROW_PAD = 8   # theta rows are padded to a multiple of this


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class TiledStencil:
    """Static-tile grouped stencil for the lane-gather kernel.

    groups[t] = list of (u, offset, count): dst tile t gathers `count`
    k-slots starting at `offset` in idx/w from rolled-source tile u, where
    u = (dc + 2) * T + src_tile.
    idx : (K_tot, 128) int32 lane ids into the source tile
    w   : (K_tot, 128) weights (+inf padding)
    ring_w : (T, 128) same-slot adjacent-column weight (+inf where no ring
             edge exists) for the ring scan
    chain_w: (M_pad,) same-column next-slot (m -> m+1) edge weight (+inf
             where absent) for the slot scan
    fan_w  : (T, 128) centre<->slot weights (+inf off the fan)
    """

    groups: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    idx: np.ndarray
    w: np.ndarray
    offs: np.ndarray    # (T+1,) int32 row range of each dst tile in idx/w
    u_of: np.ndarray    # (K_tot,) int32 rolled-source tile of each row
    ring_w: np.ndarray
    chain_w: np.ndarray
    fan_w: np.ndarray
    T: int
    M: int
    ntheta: int


def pack_tiled_stencil(cg: CirculantGraph, dtype=np.float32) -> TiledStencil:
    """Group the per-slot stencil by (dst tile, rolled-source tile)."""
    M, K = cg.src_flat.shape
    nt = cg.ntheta
    T = _round_up(M, LANES) // LANES

    flat = cg.src_flat.astype(np.int64)
    w = cg.w.astype(np.float64)
    valid = np.isfinite(w)

    dc = flat // M - _DC_RANGE
    m_src = flat % M
    s_tile = m_src // LANES
    s_lane = m_src % LANES
    u = (dc + _DC_RANGE) * T + s_tile

    m_dst = np.repeat(np.arange(M), K).reshape(M, K)
    t_dst = m_dst // LANES
    l_dst = m_dst % LANES

    # ring weights: same-slot neighbour one column over (dc == +1)
    ring_w = np.full((T, LANES), np.inf)
    ring_hit = valid & (dc == 1) & (m_src == m_dst)
    rr, kk = np.nonzero(ring_hit)
    ring_w[rr // LANES, rr % LANES] = w[rr, kk]

    # slot-chain weights: same-column edge to the NEXT slot (m -> m+1)
    chain_w = np.full(_round_up(M, LANES), np.inf)
    chain_hit = valid & (dc == 0) & (m_src == m_dst + 1)
    rr, kk = np.nonzero(chain_hit)
    chain_w[rr] = w[rr, kk]

    fan_w = np.full((T, LANES), np.inf)
    fan_w[cg.fan_slots // LANES, cg.fan_slots % LANES] = cg.fan_w

    idx_rows: List[np.ndarray] = []
    w_rows: List[np.ndarray] = []
    groups: List[List[Tuple[int, int, int]]] = []
    offset = 0
    for t in range(T):
        tmask = valid & (t_dst == t)
        groups_t: List[Tuple[int, int, int]] = []
        for uu in np.unique(u[tmask]):
            gmask = tmask & (u == uu)
            lanes = l_dst[gmask]
            srcl = s_lane[gmask]
            ww = w[gmask]
            cnt = np.bincount(lanes, minlength=LANES)
            kmax = int(cnt.max())
            gidx = np.zeros((kmax, LANES), dtype=np.int32)
            gw = np.full((kmax, LANES), np.inf)
            order = np.argsort(lanes, kind="stable")
            lanes_s, srcl_s, ww_s = lanes[order], srcl[order], ww[order]
            starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
            krow = np.arange(len(lanes_s)) - starts[lanes_s]
            gidx[krow, lanes_s] = srcl_s
            gw[krow, lanes_s] = ww_s
            idx_rows.append(gidx)
            w_rows.append(gw)
            groups_t.append((int(uu), offset, kmax))
            offset += kmax
        groups.append(groups_t)

    idx_all = (np.concatenate(idx_rows) if idx_rows
               else np.zeros((0, LANES), np.int32))
    w_all = np.concatenate(w_rows) if w_rows else np.zeros((0, LANES))
    offs = np.zeros(T + 1, dtype=np.int32)
    u_of = np.zeros(len(idx_all), dtype=np.int32)
    for t, groups_t in enumerate(groups):
        offs[t + 1] = offs[t] + sum(cnt for (_, _, cnt) in groups_t)
        for (uu, off, cnt) in groups_t:
            u_of[off:off + cnt] = uu
    return TiledStencil(
        groups=tuple(tuple(g) for g in groups),
        idx=idx_all.astype(np.int32),
        w=w_all.astype(dtype),
        offs=offs,
        u_of=u_of,
        ring_w=ring_w.astype(dtype),
        chain_w=chain_w.astype(dtype),
        fan_w=fan_w.astype(dtype),
        T=T,
        M=M,
        ntheta=nt,
    )


# the chunk relaxation of csrc/lane_gather.cuh, which csrc/relax.cu and
# csrc/fused.cu share (kChunk, kSlab, kWarps, kRowBlock there): a chunk
# holds at most CHUNK stencil rows of one SLAB-lane slab; a block of WARPS
# warps takes an item of ROW_BLOCK theta rows
CHUNK = 32
SLAB = 32
WARPS = 8
ROW_BLOCK = 64


class RelaxChunks(NamedTuple):
    """The relaxation's stencil rows in chunks (NumPy, from
    `relax_chunks`).  Chunk j holds n_j <= CHUNK rows k of one tile t,
    one 32-lane slab g and one source tile: the rows whose weight is
    finite for some lane of the slab, its z_j rows of dc = 0 first (the
    only ones a pad row takes); a (t, g, source tile)'s rows are cut
    into chunks of sizes that differ by at most one, and the chunks go
    by source tile, longest first.  Rows past n_j hold +inf weights.

    info : (n_chunks, 2) int32, (t * 4 + g | source tile << 16,
           n_j | z_j << 16)
    row  : (n_chunks, CHUNK) int32, source tile | (dc + 2) << 16
    idx  : (n_chunks, CHUNK, SLAB) int32 source lane
    w    : (n_chunks, CHUNK, SLAB) weight
    """

    info: np.ndarray
    row: np.ndarray
    idx: np.ndarray
    w: np.ndarray


def relax_chunks(ts: TiledStencil) -> RelaxChunks:
    """Chunk tables of the packed stencil `ts` for csrc/relax.cu and
    csrc/fused.cu."""
    return _pack_chunks(ts.T, ts.offs, ts.u_of, ts.idx, ts.w)


def _pack_chunks(T, offs, u_of, idx, w) -> RelaxChunks:
    slabs = LANES // SLAB
    if T * slabs > 0xFFFF:  # info packs t * slabs + g in 16 bits
        raise ValueError(f"relax_chunks takes at most {0xFFFF // slabs} "
                         f"tiles, not {T}")
    finite = np.isfinite(w).reshape(-1, slabs, SLAB).any(axis=2)
    src_tile = u_of % T
    info, rows = [], []
    for t in range(T):
        for g in range(slabs):
            ks = offs[t] + np.flatnonzero(finite[offs[t]:offs[t + 1], g])
            for st in np.unique(src_tile[ks]):
                kst = ks[src_tile[ks] == st]
                for part in np.array_split(kst, -(-len(kst) // CHUNK)):
                    dc0 = u_of[part] // T == _DC_RANGE
                    part = np.concatenate([part[dc0], part[~dc0]])
                    info.append((t * slabs + g | int(st) << 16,
                                 len(part) | int(dc0.sum()) << 16))
                    rows.append((g, part))
    # by source tile, so that a kernel block's run of items mostly reads
    # one source window; longest first within it
    order = sorted(range(len(info)),
                   key=lambda j: (info[j][0] >> 16, -(info[j][1] & 0xFFFF)))
    info = [info[j] for j in order]
    rows = [rows[j] for j in order]
    n = len(info)
    ck_row = np.zeros((n, CHUNK), np.int32)
    ck_idx = np.zeros((n, CHUNK, SLAB), np.int32)
    ck_w = np.full((n, CHUNK, SLAB), np.inf, dtype=w.dtype)
    for j, (g, ks) in enumerate(rows):
        u = u_of[ks]
        ck_row[j, :len(ks)] = (u % T) | ((u // T) << 16)
        ck_idx[j, :len(ks)] = idx[ks, g * SLAB:(g + 1) * SLAB]
        ck_w[j, :len(ks)] = w[ks, g * SLAB:(g + 1) * SLAB]
    return RelaxChunks(np.asarray(info, np.int32).reshape(n, 2), ck_row,
                       ck_idx, ck_w)


# ----------------------------------------------------------------------
# one relaxation sweep: CUDA kernel wrapper + plain twin
# ----------------------------------------------------------------------


def _gather_min(R: torch.Tensor, acc0: torch.Tensor, offs: torch.Tensor,
                u_of: torch.Tensor, idx: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's min-gather loop over a (5T, SR, 128) rolled stack:
    out[t] = min(acc0[t], min over k in offs[t]..offs[t+1] of
    R[u_of[k]][:, idx[k]] + w[k]).  Rows k are taken in chunks (min does
    not depend on order)."""
    T, SR, _ = acc0.shape
    bounds = offs.tolist()
    out = []
    for t in range(T):
        acc = acc0[t]
        for k0 in range(bounds[t], bounds[t + 1], 64):
            k1 = min(k0 + 64, bounds[t + 1])
            src = R[u_of[k0:k1].long()]                       # (kc, SR, 128)
            g = torch.gather(src, 2, idx[k0:k1].long()[:, None, :]
                             .expand(-1, SR, -1))
            acc = torch.minimum(acc, (g + w[k0:k1][:, None, :]).amin(dim=0))
        out.append(acc)
    return torch.stack(out)


def relax_reference(dist: torch.Tensor, offs: torch.Tensor,
                    u_of: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                    T: int, nt: int, S: int, ntp: int) -> torch.Tensor:
    """Plain PyTorch twin of `relax`: the 5 theta-rolled copies of
    `_relax_pallas` (pad rows +inf), then `_make_relax_kernel`'s loop."""
    SR = S * ntp
    body = dist[:, :, :nt]
    rolled = [torch.roll(body, -d, dims=2)
              for d in range(-_DC_RANGE, _DC_RANGE + 1)]
    R = torch.stack(rolled, dim=0)                            # (5,T,S,nt,128)
    if ntp != nt:
        pad = torch.full((5, T, S, ntp - nt, LANES), float("inf"),
                         dtype=dist.dtype, device=dist.device)
        R = torch.cat([R, pad], dim=3)
    R = R.reshape(5 * T, SR, LANES)
    out = _gather_min(R, R[_DC_RANGE * T:(_DC_RANGE + 1) * T], offs, u_of,
                      idx, w)
    return out.reshape(T, S, ntp, LANES)


def relax_items_reference(dist: torch.Tensor, chunks, T: int, nt: int,
                          S: int, ntp: int) -> torch.Tensor:
    """csrc/relax.cu's work partition in plain torch ops: the same floats
    as `relax_reference` by another route.  `chunks` = (ck_info, ck_row,
    ck_idx, ck_w) of `relax_chunks`.  The output starts as the input's
    real rows and +inf pad rows; then each item (source, block of
    ROW_BLOCK theta rows, chunk), in the kernel's order, stages its
    ROW_BLOCK + 4 row window of the source tile with the theta wrap done
    in the staging (window row j stands for state row (q0 + j - 2) mod nt
    of the source, q0 the block's first row), reads a real row c's copy
    dc at window row c - q0 + 2 + dc, and takes the minimum of its rows'
    candidates into the output."""
    ck_info, ck_row, ck_idx, ck_w = chunks
    x4 = dist.view(T, S, ntp, LANES)
    out = dist.clone().view(T, S, ntp, LANES)
    out[:, :, nt:] = float("inf")
    nth = ntp + 2 * _DC_RANGE
    h = torch.arange(nth, device=dist.device)
    h_row = torch.where(h < 2, nt - 2 + h, torch.where(
        h < nt + 2, h - 2, torch.where(h < nt + 4, h - nt - 2, h - 4)))
    nrb = -(-ntp // ROW_BLOCK)
    info = ck_info.tolist()
    n_chunks = len(info)
    for item in range(n_chunks * S * nrb):
        rest, ch = divmod(item, n_chunks)
        s, rb = divmod(rest, nrb)
        tg, nz = info[ch]
        t, g = divmod(tg & 0xFFFF, LANES // SLAB)
        n = nz & 0xFFFF
        q0 = rb * ROW_BLOCK
        c = torch.arange(q0, min(q0 + ROW_BLOCK, nt), device=dist.device)
        if n == 0 or len(c) == 0:
            continue
        win = x4[tg >> 16, s][h_row[q0:q0 + ROW_BLOCK + 4]]   # staged window
        dc = (ck_row[ch, :n].long() >> 16) - _DC_RANGE
        q = (c - q0)[None, :] + _DC_RANGE + dc[:, None]        # (n, rows)
        idx = ck_idx[ch, :n].long()
        vals = torch.gather(win[q], 2, idx[:, None, :].expand(-1, len(c), -1))
        cand = (vals + ck_w[ch, :n][:, None, :]).amin(dim=0)
        sl = out[t, s, q0:q0 + len(c), g * SLAB:(g + 1) * SLAB]
        out[t, s, q0:q0 + len(c), g * SLAB:(g + 1) * SLAB] = \
            torch.minimum(sl, cand)
    return out


def _check_relax_args(dist, offs, u_of, idx, w, T, nt, S, ntp):
    if not (3 <= nt <= ntp and ntp % ROW_PAD == 0):
        raise ValueError(f"need 3 <= nt <= ntp and ntp % {ROW_PAD} == 0, "
                         f"got nt={nt}, ntp={ntp}")
    if tuple(dist.shape) != (T, S, ntp, LANES):
        raise ValueError(f"dist must be {(T, S, ntp, LANES)}, "
                         f"got {tuple(dist.shape)}")
    K = idx.shape[0]
    want = {"offs": (offs, (T + 1,)), "u_of": (u_of, (K,)),
            "idx": (idx, (K, LANES)), "w": (w, (K, LANES))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dist.device:
            raise ValueError(f"relax tensors on {t.device} and {dist.device}")
    if w.dtype != dist.dtype:
        raise TypeError(f"relax tensors of {w.dtype} and {dist.dtype}")


def _relax_lib() -> ctypes.CDLL:
    lib = kernels.load("relax")
    fn = lib.relax_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    return lib


def _kernel_chunks(offs: torch.Tensor, u_of: torch.Tensor,
                   idx: torch.Tensor, w: torch.Tensor, T: int):
    """(ck_info, ck_row, ck_idx, ck_w): `relax_chunks`' tables of the
    stencil (offs, u_of, idx, w) on w's device, the form the kernel reads.
    Packed once and kept on `w` (repacked if one of the four tensors is
    another or was modified in place)."""
    key = (T,) + tuple((t.data_ptr(), t._version) for t in (offs, u_of, idx, w))
    cache = getattr(w, "_relax_chunks", None)
    if cache is None or cache[0] != key:
        ck = _pack_chunks(T, *(t.detach().cpu().numpy()
                               for t in (offs, u_of, idx, w)))
        cache = (key, tuple(torch.as_tensor(a, device=w.device).contiguous()
                            for a in ck))
        w._relax_chunks = cache
    return cache[1]


def relax(dist: torch.Tensor, offs: torch.Tensor, u_of: torch.Tensor,
          idx: torch.Tensor, w: torch.Tensor, T: int, nt: int, S: int,
          ntp: int) -> torch.Tensor:
    """One lane-gather relaxation sweep of the (T, S, ntp, 128) state;
    returns a new state with pad rows at +inf, the input untouched.

    A CUDA tensor goes to the hand-written kernel `csrc/relax.cu`
    (`relax.launches` counts its launches), which reads the stencil as
    chunk tables (packed once per stencil, `_kernel_chunks`); a CPU
    tensor goes to `relax_reference`.  Any other device raises.
    """
    _check_relax_args(dist, offs, u_of, idx, w, T, nt, S, ntp)
    if dist.device.type == "cpu":
        return relax_reference(dist, offs, u_of, idx, w, T, nt, S, ntp)
    if dist.device.type != "cuda":
        raise ValueError(f"relax runs on cuda or cpu, not {dist.device}")
    kernels.require_float("relax", dist.dtype)
    if not dist.is_contiguous():
        raise ValueError("relax takes a contiguous state")
    chunks = _kernel_chunks(offs, u_of, idx, w, T)
    out = torch.empty_like(dist)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    rc = _relax_lib().relax_launch(
        dist.data_ptr(), *(t.data_ptr() for t in chunks), out.data_ptr(), T,
        nt, S, ntp, chunks[0].shape[0], int(dist.dtype == torch.float64),
        stream)
    if rc != 0:
        raise RuntimeError(f"relax kernel launch failed: CUDA error {rc}")
    relax.launches += 1
    return out


relax.launches = 0


# ----------------------------------------------------------------------
# scan accelerators (plain torch ops, the JAX package's float order)
# ----------------------------------------------------------------------


def _ring_scan(dist: torch.Tensor, ring_w: torch.Tensor,
               nt: int) -> torch.Tensor:
    """Exact circular min-plus relaxation along every ring (both ways).

    dist (T, S, ntp, 128); ring_w (T, 128) per-slot adjacent-column hop
    cost (+inf where the ring is broken).  With a uniform hop cost c the
    scan has a closed form in cumulative minima of d_j - j c (plus the
    seam-crossing term); broken rings keep their input."""
    body = dist[:, :, :nt]
    finite = torch.isfinite(ring_w)
    c = torch.where(finite, ring_w, torch.zeros((), dtype=ring_w.dtype,
                                                device=ring_w.device))
    c = c[:, None, None, :]
    j = torch.arange(nt, dtype=dist.dtype, device=dist.device)
    j = j[None, None, :, None]
    base = body - j * c

    def one_direction(b):
        pref = torch.cummin(b, dim=2).values
        suff = torch.flip(torch.cummin(torch.flip(b, dims=[2]), dim=2)
                          .values, dims=[2])
        inner = pref + j * c
        wrap = suff + float(nt) * c + j * c
        return torch.minimum(inner, wrap)

    fwd = one_direction(base)
    base_r = torch.flip(body, dims=[2]) - j * c
    bwd = torch.flip(one_direction(base_r), dims=[2])

    out = torch.minimum(body, torch.minimum(fwd, bwd))
    out = torch.where(finite[:, None, None, :], out, body)
    if dist.shape[2] != nt:
        out = torch.cat([out, dist[:, :, nt:]], dim=2)
    return out


def _lane_cumsum(x: np.ndarray) -> np.ndarray:
    """Cumulative sum along the 128 lanes of x (T, 128) in the rounding of
    the JAX package's `jnp.cumsum` on the CPU: XLA evaluates it as
    sequential sums inside blocks of 16 lanes, sequential sums of the
    block totals, and one add of the two."""
    T, L = x.shape
    blk = x.reshape(T, L // 16, 16)
    inner = np.empty_like(blk)
    acc = np.zeros(blk.shape[:2], dtype=x.dtype)
    for i in range(16):
        acc = acc + blk[:, :, i]
        inner[:, :, i] = acc
    pre = np.zeros(blk.shape[:2], dtype=x.dtype)
    tot = np.zeros(T, dtype=x.dtype)
    for b in range(1, L // 16):
        tot = tot + inner[:, b - 1, 15]
        pre[:, b] = tot
    return (inner + pre[:, :, None]).reshape(T, L)


class SlotScanTables(NamedTuple):
    """The slot scan's per-direction tables (functions of chain_w only),
    forward then backward: cost into lane l from lane l-1 (+inf at l = 0),
    the in-tile cost from lane 0 to lane l, and the cost from tile t-1's
    last lane into tile t's lane 0."""

    cost_f: torch.Tensor    # (T, 128)
    cum_f: torch.Tensor     # (T, 128)
    bridge_f: torch.Tensor  # (T,)
    cost_b: torch.Tensor
    cum_b: torch.Tensor
    bridge_b: torch.Tensor


def slot_scan_tables(chain_w: np.ndarray, device) -> SlotScanTables:
    """`_slot_scan`'s tables from the packed chain weights (M_pad,), as
    the JAX package computes them inside its scan."""
    T = chain_w.shape[0] // LANES
    inf = np.asarray(np.inf, chain_w.dtype)
    cw = chain_w.reshape(T, LANES)
    cost_f = np.concatenate([inf[None], chain_w[:-1]]).reshape(T, LANES)
    cost_f[:, 0] = inf
    z = cost_f.copy()
    z[:, 0] = 0.0
    cum_f = _lane_cumsum(z)
    bridge_f = np.concatenate([inf[None], cw[:-1, LANES - 1]])
    flipf = chain_w[::-1].reshape(T, LANES)
    bridge_b = np.concatenate([inf[None], flipf[1:, 0]])
    cost_b = flipf.copy()
    cost_b[:, 0] = inf
    z = flipf.copy()
    z[:, 0] = 0.0
    cum_b = _lane_cumsum(z)
    return SlotScanTables(*(torch.tensor(np.ascontiguousarray(a),
                                         device=device)
                            for a in (cost_f, cum_f, bridge_f, cost_b, cum_b,
                                      bridge_b)))


def _slot_directional(x: torch.Tensor, cost_in: torch.Tensor,
                      bridge: torch.Tensor,
                      cum: torch.Tensor) -> torch.Tensor:
    """Left-to-right min-plus scan along the flat slot axis of x
    (T, S, ntp, 128): `jax.lax.associative_scan` along the lanes of each
    tile, then the sequential carry across tiles."""
    T = x.shape[0]
    _, d1 = _sum_min_scan(cost_in.t()[:, :, None, None],
                          x.permute(3, 0, 1, 2))
    d1 = d1.permute(1, 2, 3, 0)
    tiles = [d1[0]]
    for t in range(1, T):
        carry = tiles[t - 1][:, :, LANES - 1] + bridge[t]           # (S, ntp)
        tiles.append(torch.minimum(d1[t], carry[:, :, None]
                                   + cum[t][None, None, :]))
    return torch.stack(tiles, dim=0)


def _slot_scan(dist: torch.Tensor, sc: SlotScanTables) -> torch.Tensor:
    """Min-plus scan along the slot axis (radial snake chains per column),
    both directions; linear, +inf chain breaks propagate exactly."""
    fwd = _slot_directional(dist, sc.cost_f, sc.bridge_f, sc.cum_f)
    xr = torch.flip(dist, dims=[0, 3])
    bwd = torch.flip(_slot_directional(xr, sc.cost_b, sc.bridge_b, sc.cum_b),
                     dims=[0, 3])
    return torch.minimum(dist, torch.minimum(fwd, bwd))


# ----------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------


class PallasTables(NamedTuple):
    """The sweep's and the fan's tables on one device."""

    offs: torch.Tensor     # (T+1,) int32
    u_of: torch.Tensor     # (K_tot,) int32
    idx: torch.Tensor      # (K_tot, 128) int32
    w: torch.Tensor        # (K_tot, 128)
    ring_w: torch.Tensor   # (T, 128)
    fan_w: torch.Tensor    # (T, 128)


def check_tiled_stencil(ts: TiledStencil):
    """Raise unless the kernels' indices stay in bounds: offs rises from 0
    to K_tot, 0 <= u_of < 5T and 0 <= idx < 128 (the CUDA kernels read
    through them unchecked)."""
    K = ts.idx.shape[0]
    offs = ts.offs.astype(np.int64)
    if (ts.offs.shape != (ts.T + 1,) or offs[0] != 0 or offs[-1] != K
            or np.any(np.diff(offs) < 0)):
        raise ValueError("offs must rise from 0 to K_tot over T+1 entries")
    if ts.u_of.shape != (K,) or ts.w.shape != (K, LANES) or (K and (
            ts.u_of.min() < 0 or ts.u_of.max() >= 5 * ts.T
            or ts.idx.min() < 0 or ts.idx.max() >= LANES)):
        raise ValueError("u_of, idx or w out of range or of the wrong shape")


def device_pallas_tables(ts: TiledStencil, device) -> PallasTables:
    check_tiled_stencil(ts)
    return PallasTables(*(torch.tensor(a, device=device) for a in (
        ts.offs, ts.u_of, ts.idx, ts.w, ts.ring_w, ts.fan_w)))


class PallasState(NamedTuple):
    dist: torch.Tensor    # (T, S, ntp, 128)
    dcen: torch.Tensor    # (S,)
    changed: bool
    it: int


def _solve_pallas(dist0: torch.Tensor, dcen0: torch.Tensor,
                  tbl: PallasTables, sc: SlotScanTables, tol: torch.Tensor,
                  T: int, nt: int, S: int, ntp: int, max_iters: int,
                  ring_every: int) -> PallasState:
    """The loop of the JAX package's `_solve_pallas_jit`: (scans every
    `ring_every` iterations) + one `relax` + the centre fan, until no
    distance improves by more than `tol` (one host read per iteration)."""
    fan = tbl.fan_w[:, None, None, :]
    s = PallasState(dist0, dcen0, True, 0)
    while s.changed and s.it < max_iters:
        d = s.dist
        if ring_every == 1 or (ring_every > 1 and s.it % ring_every == 0):
            d = _slot_scan(_ring_scan(d, tbl.ring_w, nt), sc)
        d = relax(d, tbl.offs, tbl.u_of, tbl.idx, tbl.w, T, nt, S, ntp)
        # centre fan exchange: the new centre from the relaxed field, the
        # field from the OLD centre, as in the JAX package
        dcen = torch.minimum(s.dcen, (d + fan).amin(dim=(0, 2, 3)))
        d = torch.minimum(d, s.dcen[None, :, None, None] + fan)
        changed = bool(((d < s.dist - tol).any()
                        | (dcen < s.dcen - tol).any()).item())
        s = PallasState(d, dcen, changed, s.it + 1)
    return s


def initial_state(cg: CirculantGraph, sources, T: int, ntp: int, dtype):
    """(T, S, ntp, 128) state and (S,) centre values of a source batch:
    0 at each source's slot (or at the centre), +inf elsewhere."""
    cmap = cg.cmap
    dist0 = np.full((T, len(sources), ntp, LANES), np.inf, dtype=dtype)
    dcen0 = np.full((len(sources),), np.inf, dtype=dtype)
    for si, src in enumerate(sources):
        if src == cmap.center:
            dcen0[si] = 0.0
        else:
            c, m = int(cmap.c_of[src]), int(cmap.m_of[src])
            dist0[m // LANES, si, c, m % LANES] = 0.0
    return dist0, dcen0


def extract(cg: CirculantGraph, dist4: np.ndarray,
            dcen: np.ndarray) -> np.ndarray:
    """(S, n) node fields from a (T, S, ntp, 128) state and (S,) centre."""
    cmap = cg.cmap
    out = np.empty((dist4.shape[1], cg.n), dtype=dist4.dtype)
    valid = cmap.m_of >= 0
    m = cmap.m_of[valid]
    c = cmap.c_of[valid]
    out[:, valid] = dist4[m // LANES, :, c, m % LANES].T
    if cmap.center >= 0:
        out[:, cmap.center] = dcen
    return out


def solve_circulant_pallas(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    ring_every: int = 1,
    device="cuda",
    _packed: Optional[TiledStencil] = None,
    _dcache: Optional[dict] = None,
) -> Tuple[np.ndarray, int]:
    """Solve a batch of sources with the lane-gather sweep on `device`;
    returns (dist (S, n) host array, iterations).

    Sources batch along the kernel's row axis.  `ring_every` runs the
    ring and slot scans every that many iterations (1: every iteration,
    0: never).  Pass a dict as `_dcache` to upload the tables once per
    device.
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
    key = ("pallas", id(ts), str(device))
    if key not in _dcache:  # holds ts, so its id is not reused
        _dcache[key] = (ts, device_pallas_tables(ts, device),
                        slot_scan_tables(ts.chain_w, device))
    _, tbl, sc = _dcache[key]
    tdtype = tbl.w.dtype
    dist0, dcen0 = initial_state(cg, sources, T, ntp, dtype)
    s = _solve_pallas(torch.tensor(dist0, device=device),
                      torch.tensor(dcen0, device=device), tbl, sc,
                      torch.tensor(config.tol_value(), dtype=tdtype,
                                   device=device),
                      T, nt, S, ntp, config.max_iters, ring_every)
    return extract(cg, s.dist.cpu().numpy(), s.dcen.cpu().numpy()), s.it
