"""Directional-sweep solver (Gauss-Seidel fast sweeping), PyTorch port.

Counterpart of `raytracer_tpu/ops/sweep_theta.py` on its production
structure (the JAX package's `engine="pallas"`, mode "hclosure").  One
round is

    fan -> down radial sweep -> ring/chain scans -> hierarchical closure
        -> up radial sweep   -> ring/chain scans -> hierarchical closure
        -> seamfix

and rounds repeat until no distance improves by more than
`SolverConfig.tol` (typically 3-4 rounds at any grid size).  The radial
sweeps are the only sequential piece: each runs as the hand-written CUDA
kernel `csrc/rsweep.cu` through the wrapper `rsweep`, whose plain twin
`rsweep_reference` runs for tensors on the CPU; the kernel reads the
taps as `plan_rsweep` packs them (the finite far taps per row, a dense
near table per 8-row block), whose plain evaluation is
`rsweep_packed_reference`.  Everything else is plain tensor code, op for
op the JAX package's arithmetic, so the fields and round counts follow
the JAX solver's.

Host table building (`pack_sweep_tables`, `pack_rsweep_tables`) stays
NumPy, a copy of the JAX package's; the tables become tensors once, on
the solver's device (`tables_to_device`).

The staged solve (`SweepStageSpec`, `solve_sweep_staged`) runs stages
one after another on destination-masked tables (`slot_mask`, `cen_on`),
each stage's rounds the same as above plus the unmasked twin min-merge
after the seamfix; solvers/multiphase.py and solvers/phases.py build
its stages.

Exactness: every candidate is a real path cost (single stencil edges and
min-plus window compositions of them), so iterates decrease monotonically
and are bounded below by the true distances; the radial kernels are
seam-blind where nt < NTL (or at lane-block edges), and `seamfix` applies
the full band stencil to the seam-adjacent columns, so every graph edge
is relaxed at least once per round.
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
from .diag_wrapped import (_extract_cached, _pipelined_chunk_solve,
                           _window_costs)
from .stream_t import (_is_on, _on, _pow_spans, _restart_to_device,
                       _twin_merge)
from .wrapped_t import TWStencil, _textract, pack_twrapped_stencil


class SweepTables(NamedTuple):
    """Tables of the directional-sweep solver: NumPy arrays from
    `pack_sweep_tables`, tensors after `tables_to_device`.  wr_dn/wr_up
    and ring2_f/ring2_b serve the JAX package's other sweep modes; they
    are packed here too so both packages' tables stay equal.

    wg  : 5 arrays (one per dc in -2..+2), each (Dg, ML): weight rows in
          DESTINATION slot coordinates, +inf where the diagonal has no
          edge or m + dm leaves [0, Mp)
    cfp/cbp : (L, ML) chain window costs (pow-2 spans, stream path's)
    fan_w   : (ML,) centre<->slot fan weights, +inf on non-fan slots
    wr_dn/wr_up : (ML, Dr) per-destination-slot scalar weights of the
          dm>0 (down-sweep) / dm<0 (up-sweep) taps, +inf where absent
    ring_f/ring_b : (ML,) per-slot theta ring hop costs (dm=0, dc=-+1)
    ring2_f/ring2_b : (ML,) dm=0, dc=-+2 tap costs
    """

    wg: Tuple[np.ndarray, ...]
    cfp: np.ndarray
    cbp: np.ndarray
    fan_w: np.ndarray    # fan-OUT row (centre -> slots)
    fan_in: np.ndarray   # fan-IN row (slots -> centre)
    wr_dn: np.ndarray
    wr_up: np.ndarray
    ring_f: np.ndarray
    ring_b: np.ndarray
    ring2_f: np.ndarray
    ring2_b: np.ndarray
    # hierarchical horizontal closure windows, one (2, 2*h_cap+1, ML)
    # array per power-of-two column span (see _hclosure_tables)
    wh: Tuple[np.ndarray, ...]


class SweepStatic(NamedTuple):
    Mp: int
    ML: int
    nt: int
    dms: Tuple[Tuple[int, ...], ...]   # per-dc-group dm offsets (static)
    chain_spans: Tuple[int, ...]
    # static (dm, dc) of the down-sweep (dm>0) / up-sweep (dm<0) taps,
    # in the column order of wr_dn / wr_up
    taps_dn: Tuple[Tuple[int, int], ...]
    taps_up: Tuple[Tuple[int, int], ...]
    h_cap: int                          # |dm| cap of the closure windows
    h_spans: Tuple[int, ...]            # column spans 1, 2, 4, ... of wh


_H_CAP = 8   # slot-drift cap of the horizontal closure windows


def _hclosure_tables(dec, nt: int, ML: int, cap: int = _H_CAP, wmat=None):
    """Hierarchical horizontal min-plus windows.

    wh[k][sign, dm + cap, :] = cost of moving EXACTLY 2**k theta columns
    in direction sign (pull convention: dst column c reads column
    c + sign*2**k) with net slot drift dm (|dm| <= cap), minimised over
    all intermediate paths whose partial drifts stay within the cap.
    Every entry is a real path cost (min-plus composition of native
    taps), so applying the windows preserves the SSSP fixpoint; they
    exist purely to collapse long near-horizontal runs (the bottoming
    legs of the rays, net drift ~0 per column) into log-many taps.
    Composition: W_2s[dm, m] = min_{dm1+dm2=dm} W_s[dm1, m]
    + W_s[dm2, m + dm1] - the same slot-shift algebra as _compose_band.
    """
    n_dm = 2 * cap + 1

    def compose(A, B):
        out = np.full_like(A, np.inf)
        Mp = A.shape[1]
        for i1 in range(n_dm):
            dm1 = i1 - cap
            w1 = A[i1]
            if not np.isfinite(w1).any():
                continue
            sh = np.full_like(B, np.inf)
            if dm1 >= 0:
                sh[:, : Mp - dm1] = B[:, dm1:]
            else:
                sh[:, -dm1:] = B[:, : Mp + dm1]
            i2 = slice(max(0, -dm1), min(n_dm, n_dm - dm1))
            cand = w1[None, :] + sh[i2]
            tgt = out[i2.start + dm1: i2.stop + dm1]
            np.minimum(tgt, cand, out=tgt)
        return out

    wmat = dec.wmat if wmat is None else wmat

    def seed(dc0):
        out = np.full((n_dm, dec.Mp), np.inf)
        for d in np.flatnonzero(dec.dcs == dc0):
            dm = int(dec.dms[d])
            if abs(dm) <= cap:
                out[dm + cap] = np.minimum(out[dm + cap], wmat[d])
        return out

    levels, spans = [], []
    cur = {+1: seed(-1), -1: seed(+1)}   # pull: span +1 reads c-1
    nat2 = {+1: seed(-2), -1: seed(+2)}
    span = 1
    while span <= nt // 2:
        pair = np.full((2, n_dm, ML), np.inf)
        pair[0, :, : dec.Mp] = cur[+1]
        pair[1, :, : dec.Mp] = cur[-1]
        levels.append(pair)
        spans.append(span)
        nxt = {s: compose(cur[s], cur[s]) for s in (+1, -1)}
        if span == 1:
            nxt = {s: np.minimum(nxt[s], nat2[s]) for s in (+1, -1)}
        cur = nxt
        span *= 2
    return levels, tuple(spans)


def _masked_wmat(dec, slot_mask):
    """The decomposition's weight rows, +inf at the destination slots
    outside `slot_mask` ((Mp,) bool; None keeps every slot)."""
    if slot_mask is None:
        return dec.wmat
    return np.where(np.asarray(slot_mask)[None, : dec.Mp], dec.wmat, np.inf)


def pack_sweep_tables(ws: TWStencil, cg: CirculantGraph, dtype,
                      slot_mask=None,
                      cen_on: bool = True) -> Tuple[SweepTables, SweepStatic]:
    """Per-dc grouped diagonal rows (cached in the stencil's dcache).

    `ws` must be packed with band_closure=0: the groups are rebuilt from
    the raw decomposition and must describe the same graph as the chain
    window costs taken from the shared stream tables.

    `slot_mask` ((Mp,) bool, optional) builds DESTINATION-MASKED stage
    tables for the staged solves (solvers/multiphase.py,
    solvers/phases.py): masked slots never improve (every cost row is
    +inf at their lanes) but stay readable, the reference's masked
    relaxation.  All compositions (chain windows, ring powers, closure
    windows) inherit the mask at every intermediate hop because each
    hop's destination row is masked at the seed.  `cen_on=False`
    additionally cuts both fan directions.  Masked tables are not cached
    (each stage owns its own).
    """
    key = "sweep_tables"
    if slot_mask is None and key in ws.dcache:
        return ws.dcache[key]
    dec = decompose_diagonals(cg)
    if dec.Mp != ws.Mp:
        raise ValueError(f"stencil has Mp={ws.Mp}, graph {dec.Mp}")
    ML = ws.ML
    wmat = _masked_wmat(dec, slot_mask)
    wg, dms = [], []
    for dc in range(-_DC_RANGE, _DC_RANGE + 1):
        sel = np.flatnonzero(dec.dcs == dc)
        order = np.argsort(dec.dms[sel])
        sel = sel[order]
        rows = np.full((max(len(sel), 1), ML), np.inf)
        if len(sel):
            rows[: len(sel), : dec.Mp] = wmat[sel]
        wg.append(rows.astype(dtype))
        dms.append(tuple(int(d) for d in dec.dms[sel]) or (0,))

    def _r_taps(sign):
        sel = np.flatnonzero(np.sign(dec.dms) == sign)
        # ascending |dm| so the carry row index is monotone
        order = np.lexsort((dec.dcs[sel], np.abs(dec.dms[sel])))
        sel = sel[order]
        w = np.full((ML, max(len(sel), 1)), np.inf)
        if len(sel):
            w[: dec.Mp, : len(sel)] = wmat[sel].T
        taps = tuple((int(dec.dms[d]), int(dec.dcs[d])) for d in sel) \
            or ((sign, 0),)
        return w.astype(dtype), taps

    wr_dn, taps_dn = _r_taps(+1)
    wr_up, taps_up = _r_taps(-1)

    def _dm0_vec(dc0):
        hit = np.flatnonzero((dec.dms == 0) & (dec.dcs == dc0))
        out = np.full(ML, np.inf)
        if len(hit):
            out[: dec.Mp] = wmat[hit[0]]
        return out.astype(dtype)

    # chain window costs from the (possibly masked) dm=+-1, dc=0 hops;
    # window doubling then forbids out-of-level intermediates while the
    # first hop may still read an out-of-level source
    def _chain_vec(dm0):
        hit = np.flatnonzero((dec.dms == dm0) & (dec.dcs == 0))
        out = np.full(ML, np.inf)
        if len(hit):
            out[: dec.Mp] = wmat[hit[0]]
        return out

    chain_f = _chain_vec(-1)
    chain_f[0] = np.inf
    chain_b = _chain_vec(+1)
    chain_b[dec.Mp - 1:] = np.inf
    spans = _pow_spans(dec.Mp)
    cfp = _window_costs(chain_f, spans)
    cbp = _window_costs(chain_b[::-1], spans)[:, ::-1]

    fan = np.asarray(ws.fan_w[0], np.float64)
    fan_out = fan.copy()
    if slot_mask is not None:
        lane_ok = np.zeros(ML, dtype=bool)
        lane_ok[: dec.Mp] = np.asarray(slot_mask)[: dec.Mp]
        fan_out = np.where(lane_ok, fan_out, np.inf)
    if not cen_on:
        fan_out = np.full_like(fan_out, np.inf)
    fan_in = fan if cen_on else np.full_like(fan, np.inf)

    wh_np, h_spans = _hclosure_tables(dec, ws.nt, ML, wmat=wmat)
    tables = SweepTables(
        wg=tuple(wg),
        cfp=cfp.astype(dtype),
        cbp=cbp.astype(dtype),
        fan_w=fan_out.astype(dtype),
        fan_in=fan_in.astype(dtype),
        wr_dn=wr_dn, wr_up=wr_up,
        ring_f=_dm0_vec(-1), ring_b=_dm0_vec(+1),
        ring2_f=_dm0_vec(-2), ring2_b=_dm0_vec(+2),
        wh=tuple(w.astype(dtype) for w in wh_np),
    )
    static = SweepStatic(Mp=ws.Mp, ML=ML, nt=ws.nt, dms=tuple(dms),
                         chain_spans=spans,
                         taps_dn=taps_dn, taps_up=taps_up,
                         h_cap=_H_CAP, h_spans=h_spans)
    if slot_mask is None:
        ws.dcache[key] = (tables, static)
    return tables, static


# ----------------------------------------------------------------------
# radial-sweep tables
# ----------------------------------------------------------------------


class RSweepStatic(NamedTuple):
    """Static geometry of the radial sweeps.

    MT   : field slot rows (round_up(Mp, 8))
    K8   : round_up(maxdm, 8): the +inf pad row count, so every tap's
           source row lies inside the buffer
    NTL  : theta lanes (round_up(nt, 128), then rounded up to a multiple
           of NTB; pad lanes +inf)
    NTB  : theta lanes per lane block.  NTB == NTL unless the field is
           large (see _RSWEEP_SINGLE_BYTES); split blocks are seam-blind
           at BOTH edges and the seamfix re-applies every block
           boundary's band edges exactly, as it does at the theta wrap.
    taps_dn/up : ((dm, dc, w_col), ...) static tap lists
    Ddn/Dup    : weight-table lane counts (round_up(len(taps), 128))
    """

    MT: int
    K8: int
    NTL: int
    NTB: int
    taps_dn: Tuple[Tuple[int, int, int], ...]
    taps_up: Tuple[Tuple[int, int, int], ...]
    Ddn: int
    Dup: int


# Lane-blocking thresholds, the JAX package's (set there by its TPU
# kernel's on-chip memory budget).  The port keeps them so that both
# packages pack identical tables; the CUDA kernel takes either layout.
_RSWEEP_SINGLE_BYTES = 52 * 1024 * 1024
_RSWEEP_WINDOW_BYTES = 24 * 1024 * 1024


def pack_rsweep_tables(ws: TWStencil, cg: CirculantGraph, dtype,
                       slot_mask=None):
    """Weight tables for the radial sweeps, cached in dcache.

    wtab_dn: (MT + K8, Ddn) - row = BUFFER row of the down sweep (field
    rows first, +inf pad rows above), lane = tap.  wtab_up mirrors with
    the pad rows BELOW (field rows at [K8, K8+MT)).  +inf entries make
    out-of-range taps no-ops.  `slot_mask` destination-masks the weight
    rows for staged solves (masked stage tables are not cached).
    """
    key = "rsweep_tables"
    if slot_mask is None and key in ws.dcache:
        return ws.dcache[key]
    dec = decompose_diagonals(cg)
    Mp = dec.Mp
    MT = _round_up(Mp, SUB)
    maxdm = int(np.max(np.abs(dec.dms)))
    K8 = _round_up(max(maxdm, 1), SUB)
    NTL = _round_up(ws.nt, LANES)
    # lane blocking: split theta only when the (MT+K8, NTL) window
    # exceeds the single-block budget; NTL is re-padded to a block
    # multiple
    itemsize = np.dtype(dtype).itemsize
    full_bytes = (MT + K8) * NTL * itemsize
    if full_bytes <= _RSWEEP_SINGLE_BYTES:
        NTB = NTL
    else:
        nb = max(2, -(-full_bytes // _RSWEEP_WINDOW_BYTES))
        NTB = _round_up(-(-NTL // nb), LANES)
        NTL = NTB * (-(-NTL // NTB))
    wmat = _masked_wmat(dec, slot_mask)

    def _pack(sign):
        sel = np.flatnonzero(np.sign(dec.dms) == sign)
        order = np.lexsort((dec.dcs[sel], dec.dms[sel]))
        sel = sel[order]
        D = _round_up(max(len(sel), 1), LANES)
        w = np.full((MT + K8, D), np.inf)
        rows = np.full((len(sel), MT), np.inf)
        rows[:, :Mp] = wmat[sel]
        base = 0 if sign > 0 else K8
        w[base: base + MT, : len(sel)] = rows.T
        taps = tuple((int(dec.dms[d]), int(dec.dcs[d]), i)
                     for i, d in enumerate(sel)) or ((sign, 0, 0),)
        return w.astype(dtype), taps, D

    wtab_dn, taps_dn, Ddn = _pack(+1)
    wtab_up, taps_up, Dup = _pack(-1)
    static = RSweepStatic(MT=MT, K8=K8, NTL=NTL, NTB=NTB, taps_dn=taps_dn,
                          taps_up=taps_up, Ddn=Ddn, Dup=Dup)
    out = ((wtab_dn, wtab_up), static)
    if slot_mask is None:
        ws.dcache[key] = out
    return out

# ----------------------------------------------------------------------
# device tables
# ----------------------------------------------------------------------


def tables_to_device(tbl: SweepTables, device) -> SweepTables:
    """The same tables as tensors on `device` (bits unchanged)."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return SweepTables(
        wg=tuple(t(a) for a in tbl.wg), cfp=t(tbl.cfp), cbp=t(tbl.cbp),
        fan_w=t(tbl.fan_w), fan_in=t(tbl.fan_in),
        wr_dn=t(tbl.wr_dn), wr_up=t(tbl.wr_up),
        ring_f=t(tbl.ring_f), ring_b=t(tbl.ring_b),
        ring2_f=t(tbl.ring2_f), ring2_b=t(tbl.ring2_b),
        wh=tuple(t(a) for a in tbl.wh),
    )


# ----------------------------------------------------------------------
# the radial Gauss-Seidel sweep: CUDA kernel wrapper + plain twin
# ----------------------------------------------------------------------


def _check_rsweep_args(buf: torch.Tensor, wtab: torch.Tensor,
                       rst: RSweepStatic, upward: bool):
    taps = rst.taps_up if upward else rst.taps_dn
    MTK = rst.MT + rst.K8
    if buf.dtype != wtab.dtype:
        raise TypeError(f"rsweep tensors of {buf.dtype} and {wtab.dtype}")
    if buf.dim() != 3 or tuple(buf.shape[1:]) != (MTK, rst.NTL):
        raise ValueError(f"buf must be (S, {MTK}, {rst.NTL}), got "
                         f"{tuple(buf.shape)}")
    if wtab.dim() != 2 or wtab.shape[0] != MTK \
            or wtab.shape[1] <= max(iw for _, _, iw in taps):
        raise ValueError(f"wtab of shape {tuple(wtab.shape)} does not fit "
                         f"{MTK} rows and {len(taps)} taps")
    if rst.NTL % rst.NTB:
        raise ValueError(f"NTL={rst.NTL} is not a multiple of NTB={rst.NTB}")
    if not (buf.is_contiguous() and wtab.is_contiguous()):
        raise ValueError("rsweep takes contiguous tensors")
    if buf.device != wtab.device:
        raise ValueError(f"buf on {buf.device} but wtab on {wtab.device}")


def rsweep_reference(buf: torch.Tensor, wtab: torch.Tensor,
                     rst: RSweepStatic, upward: bool) -> torch.Tensor:
    """Plain PyTorch radial Gauss-Seidel sweep, in place on `buf`.

    buf (S, MT+K8, NTL) in T layout (rows are slots, lanes are theta);
    down: field rows [0, MT) with the +inf pad above, rows visited
    MT-1 .. 0 through the dm > 0 taps; up: field rows [K8, K8+MT) with
    the pad below, rows visited upward through the dm < 0 taps.  For each
    row r: buf[r, c] = min(buf[r, c], min over taps (buf[r+dm, c+dc] +
    wtab[r, iw])), the lane shift a roll within each NTB-wide lane block
    (mod NTL when NTB == NTL, never mod nt: pad lanes are +inf and the
    seamfix repairs the theta seam).  When the lanes are split into
    blocks, lanes whose source crossed a block edge read +inf.  Taps
    are grouped by dc so each row takes one roll per group.
    """
    S, _, NTL = buf.shape
    MT, K8, NTB = rst.MT, rst.K8, rst.NTB
    nb = NTL // NTB
    blocked = NTB < NTL
    dev = buf.device
    inf = torch.tensor(float("inf"), dtype=buf.dtype, device=dev)
    lane = torch.arange(NTB, device=dev)
    groups = {}
    for dm, dc, iw in (rst.taps_up if upward else rst.taps_dn):
        groups.setdefault(dc, []).append((dm, iw))
    plan = []
    for dc, lst in sorted(groups.items()):
        dms = torch.tensor([dm for dm, _ in lst], device=dev)
        w_g = wtab[:, [iw for _, iw in lst]]              # (MT+K8, T_g)
        edge = None
        if blocked and dc:
            edge = (lane >= NTB - dc) if dc > 0 else (lane < -dc)
        plan.append((dc, dms, w_g, edge))
    rows = range(K8, K8 + MT) if upward else range(MT - 1, -1, -1)
    for r in rows:
        cur = buf[:, r, :]
        for dc, dms, w_g, edge in plan:
            src = buf.index_select(1, dms + r)            # (S, T_g, NTL)
            if dc:
                src = torch.roll(src.reshape(S, -1, nb, NTB), -dc, dims=3)
                if edge is not None:
                    src = torch.where(edge, inf, src)
                src = src.reshape(S, -1, NTL)
            cand = (src + w_g[r][None, :, None]).amin(dim=1)
            cur = torch.minimum(cur, cand)
        buf[:, r, :] = cur
    return buf


# ----------------------------------------------------------------------
# the kernel's packed tap lists (host) and their plain evaluation
# ----------------------------------------------------------------------

RSWEEP_BLOCK = 8        # rows per block: the TPU kernel's macro-block
_RSWEEP_INFO = 20       # ints per block in RSweepPlan.binfo
_RSWEEP_NEAR = 248      # floats per block of RSweepPlan.near (7 x 7 x 5, padded)
_RSWEEP_HALO = 4        # lanes each side of a shared-memory ring row
RSWEEP_THREADS = 1024


class RSweepPlan(NamedTuple):
    """The taps of one radial sweep as `csrc/rsweep.cu` reads them.

    The rows are visited in 8-row blocks.  A row's far taps (source row
    outside the row's block: final before the block starts) are packed
    per row, only those whose weight is finite (a +inf weight never wins
    the min), in tap order; blocks follow in sweep order.  The near taps
    (source inside the block) sit in a dense per-block table.

    shared   : the route - True: the field rows a block reads sit in a
               shared-memory ring of K8+16 rows; False: they are read in
               device memory (the ring and tap buffers would exceed
               BLOCK_SMEM)
    threads  : threads per CTA
    far_lanes, near_lanes : lanes of one row per thread in the far pass
               and in the near chain (a warp takes 32 x that many)
    ent_cap  : the most far entries of one block
    smem_bytes : the shared route's dynamic shared memory
    ent   : int32 far taps, (E, 2) in float32: x = ring offset ((r + dm)
            mod (K8+16)) * (NTB + 8) + 4 + dc on the shared route,
            (dm << 3) | (dc + 2) on the global route, then the weight's
            float32 bits; (E, 4) in float64: x, 0, then the weight's low
            and high 32 bits (one 16-byte load a tap in the kernel)
    binfo : (MT/8, 20) int32 per block g (sweep order): start and count
            of its entries, the offset of row b+j's entries from the
            block's start (j = 0..7), then row b+j's count
    near  : (MT/8, 248) per block, in the table's dtype: the weight of the tap from the
            row at sweep position u (0 = visited first) into the row at
            position u + d, lane shift dc, at (u * 7 + d - 1) * 5 + dc + 2;
            +inf where that tap is absent or its weight is +inf
    dm, dc, w : (E,) the far entries' taps and weights, unencoded (read
            by `rsweep_packed_reference` and the tests, not by the kernel)
    """

    shared: bool
    threads: int
    far_lanes: int
    near_lanes: int
    ent_cap: int
    smem_bytes: int
    ent: np.ndarray
    binfo: np.ndarray
    near: np.ndarray
    dm: np.ndarray
    dc: np.ndarray
    w: np.ndarray


def rsweep_lanes(ntb: int) -> Tuple[int, int]:
    """(far_lanes, near_lanes) per thread for NTB lanes: the far pass
    splits 8 rows x NTB lanes over the CTA's 32 warps, 32 x far_lanes
    lanes of one row per warp; the near chain gives each warp one
    32 x near_lanes lane group of a row (1, 2 or 4 lanes a thread)."""
    warps = RSWEEP_THREADS // 32
    far = 4 if RSWEEP_BLOCK * ntb // 128 >= warps // 2 else (
        2 if RSWEEP_BLOCK * ntb // 64 >= warps // 2 else 1)
    near = next((n for n in (1, 2) if ntb // (32 * n) <= warps), 4)
    return far, near


def rsweep_smem_bytes(rst: RSweepStatic, ent_cap: int,
                      itemsize: int = 4) -> int:
    """Shared memory of the ring route: K8+16 rows of NTB + 8 lanes, two
    buffers of ent_cap far entries (8 bytes each in float32, 16 in
    float64), two near tables and two info rows; `itemsize` is the
    field's (4 or 8)."""
    return (itemsize * (rst.K8 + 2 * RSWEEP_BLOCK)
            * (rst.NTB + 2 * _RSWEEP_HALO)
            + 2 * 2 * itemsize * ent_cap + 2 * itemsize * _RSWEEP_NEAR
            + 2 * 4 * _RSWEEP_INFO)


def rsweep_block_rows(rst: RSweepStatic, upward: bool) -> np.ndarray:
    """First buffer row of each 8-row block, in sweep order."""
    nblk = rst.MT // RSWEEP_BLOCK
    g = np.arange(nblk)
    if upward:
        return rst.K8 + RSWEEP_BLOCK * g
    return rst.MT - RSWEEP_BLOCK - RSWEEP_BLOCK * g


def _sweep_position(j, upward: bool):
    """Sweep position (0 = visited first) of local row j of a block."""
    return j if upward else RSWEEP_BLOCK - 1 - j


def plan_rsweep(wtab: np.ndarray, rst: RSweepStatic,
                upward: bool) -> RSweepPlan:
    """Pack the finite taps of `wtab` ((MT+K8, D) float32 or float64,
    host) for the kernel, and choose its route from the shapes and the
    dtype (the float64 ring takes twice the bytes)."""
    wtab = np.asarray(wtab)
    if wtab.dtype not in (np.float32, np.float64):
        raise TypeError(f"rsweep packs float32 or float64 tables, not "
                        f"{wtab.dtype}")
    item = wtab.dtype.itemsize
    taps = rst.taps_up if upward else rst.taps_dn
    B = RSWEEP_BLOCK
    if max(abs(dc) for _, dc, _ in taps) > 2:
        raise ValueError("rsweep takes lane shifts |dc| <= 2")
    t_dm = np.array([dm for dm, _, _ in taps], np.int64)
    t_dc = np.array([dc for _, dc, _ in taps], np.int64)
    t_iw = np.array([iw for _, _, iw in taps], np.int64)
    starts = rsweep_block_rows(rst, upward)
    nblk = len(starts)
    rows = (starts[:, None] + np.arange(B)[None, :]).ravel()   # visit blocks
    W = wtab[rows][:, t_iw]                                    # (N, T)
    blk = np.repeat(starts, B)
    src = rows[:, None] + t_dm[None, :]
    near = (src >= blk[:, None]) & (src < blk[:, None] + B)
    fin = np.isfinite(W)
    # far taps: finite, packed per row in tap order
    ri, ti = np.nonzero(fin & ~near)
    N = len(rows)
    count = np.bincount(ri, minlength=N)
    row_start = np.concatenate([[0], np.cumsum(count)])
    binfo = np.zeros((nblk, _RSWEEP_INFO), np.int32)
    b_start = row_start[:-1:B]
    binfo[:, 0] = b_start
    binfo[:, 1] = count.reshape(nblk, B).sum(axis=1)
    binfo[:, 2:2 + B] = row_start[:-1].reshape(nblk, B) - b_start[:, None]
    binfo[:, 2 + B:2 + 2 * B] = count.reshape(nblk, B)
    # near taps: dense (u, d, dc) per block, +inf where absent
    near_t = np.full((nblk, _RSWEEP_NEAR), np.inf, wtab.dtype)
    rn, tn = np.nonzero(near)
    j_dst = rows[rn] - blk[rn]
    u_dst = _sweep_position(j_dst, upward)
    u_src = _sweep_position(j_dst + t_dm[tn], upward)
    d = u_dst - u_src
    if (d < 1).any():
        raise ValueError("a near tap does not point back in sweep order")
    near_t[rn // B, (u_src * (B - 1) + d - 1) * 5 + t_dc[tn] + 2] = W[rn, tn]
    ent_cap = max(1, int(binfo[:, 1].max(initial=0)))
    smem = rsweep_smem_bytes(rst, ent_cap, item)
    shared = smem <= BLOCK_SMEM
    dm, dc = t_dm[ti], t_dc[ti]
    if shared:
        R, stride = rst.K8 + 2 * B, rst.NTB + 2 * _RSWEEP_HALO
        x = ((rows[ri] + dm) % R) * stride + _RSWEEP_HALO + dc
    else:
        x = dm * 8 + (dc + 2)
    w = W[ri, ti]
    bits = w.view(np.int32).reshape(len(w), item // 4).astype(np.int64)
    cols = [x[:, None]] + ([np.zeros((len(w), 1), np.int64)]
                           if item == 8 else []) + [bits]
    ent = np.concatenate(cols, axis=1)
    far_l, near_l = rsweep_lanes(rst.NTB)
    return RSweepPlan(shared=shared, threads=RSWEEP_THREADS,
                      far_lanes=far_l, near_lanes=near_l, ent_cap=ent_cap,
                      smem_bytes=smem, ent=ent.astype(np.int32), binfo=binfo,
                      near=near_t, dm=dm.astype(np.int32),
                      dc=dc.astype(np.int32), w=w)


def rsweep_packed_reference(buf: torch.Tensor, plan: RSweepPlan,
                            rst: RSweepStatic, upward: bool) -> torch.Tensor:
    """Plain PyTorch evaluation of the packed form, in place on `buf`, in
    the kernel's order: per block, the far taps of its 8 rows, then the
    near table row by row in sweep order.  Same floats as
    `rsweep_reference` (each candidate is one add, min is order-free and
    a dropped or +inf weight never wins)."""
    S, _, NTL = buf.shape
    NTB, B = rst.NTB, RSWEEP_BLOCK
    nb = NTL // NTB
    dev = buf.device
    lane = torch.arange(NTB, device=dev)
    dm_all = torch.as_tensor(plan.dm.astype(np.int64), device=dev)
    dc_all = torch.as_tensor(plan.dc.astype(np.int64), device=dev)
    w_all = torch.as_tensor(plan.w, device=dev)
    near = torch.as_tensor(plan.near, device=dev)

    def relax(r, rows, dc, w):
        """buf[:, r] = min(buf[:, r], buf[:, rows[e], lane + dc[e]] + w[e])."""
        if len(rows) == 0:
            return
        src = buf.index_select(1, rows).reshape(S, len(rows), nb, NTB)
        sl = lane[None, :] + dc[:, None]                     # (E, NTB)
        cand = torch.gather(src, 3, (sl % NTB)[None, :, None, :].expand(
            S, len(rows), nb, NTB))
        if NTB < NTL:
            bad = (sl < 0) | (sl >= NTB)
            cand = torch.where(bad[None, :, None, :], float("inf"), cand)
        cand = (cand + w[:, None, None]).amin(dim=1)
        buf[:, r, :] = torch.minimum(buf[:, r, :], cand.reshape(S, NTL))

    dcs = torch.arange(-2, 3, device=dev)
    for g, b in enumerate(rsweep_block_rows(rst, upward).tolist()):
        info = plan.binfo[g]
        for j in range(B):
            lo = int(info[0] + info[2 + j])
            hi = lo + int(info[2 + B + j])
            relax(b + j, b + j + dm_all[lo:hi], dc_all[lo:hi], w_all[lo:hi])
        for u in range(1, B):
            j = _sweep_position(u, upward)
            for us in range(u):
                k = (us * (B - 1) + u - us - 1) * 5
                src = torch.full((5,), b + _sweep_position(us, upward),
                                 device=dev)
                relax(b + j, src, dcs, near[g, k:k + 5])
    return buf


def _kernel_tables(wtab: torch.Tensor, rst: RSweepStatic, upward: bool):
    """(plan, ent, binfo, near) of `wtab` for the kernel, the three
    arrays on wtab's device.  Packed once per (layout, direction) and kept on the
    tensor itself (repacked if it is modified in place)."""
    cache = getattr(wtab, "_rsweep_plans", None)
    if cache is None or cache[0] != wtab._version:
        cache = (wtab._version, {})
        wtab._rsweep_plans = cache
    key = (rst, upward)
    if key not in cache[1]:
        with profiling.setup_span("build.sweep_tables"):
            plan = plan_rsweep(wtab.detach().cpu().numpy(), rst, upward)
            cache[1][key] = (plan,) + tuple(
                torch.as_tensor(a, device=wtab.device).contiguous()
                for a in (plan.ent, plan.binfo, plan.near))
    return cache[1][key]


def _rsweep_lib() -> ctypes.CDLL:
    lib = kernels.load("rsweep")
    fn = lib.rsweep_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
    return lib


def rsweep(buf: torch.Tensor, wtab: torch.Tensor, rst: RSweepStatic,
           upward: bool) -> torch.Tensor:
    """Radial Gauss-Seidel sweep of the (S, MT+K8, NTL) T-layout field,
    in place (the JAX kernel donates its field: input_output_aliases
    {1: 0}); returns `buf`.

    A CUDA tensor goes to the hand-written kernel `csrc/rsweep.cu`
    (launched on the current stream; `rsweep.launches` counts the
    launches) with the finite taps of `wtab` packed by `plan_rsweep`
    (once per table, `_kernel_tables`); a CPU tensor goes to
    `rsweep_reference`.  Any other device raises.  The call is the span
    `sweep.rsweep`.
    """
    with profiling.span("sweep.rsweep", buf.device):
        _check_rsweep_args(buf, wtab, rst, upward)
        if buf.device.type == "cpu":
            return rsweep_reference(buf, wtab, rst, upward)
        if buf.device.type != "cuda":
            raise ValueError(f"rsweep runs on cuda or cpu, not {buf.device}")
        kernels.require_float("rsweep", buf.dtype)
        if buf.data_ptr() % 16:
            raise ValueError("rsweep takes a 16-byte aligned buffer")
        plan, ent, binfo, near = _kernel_tables(wtab, rst, upward)
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = _rsweep_lib().rsweep_launch(
            buf.data_ptr(), ent.data_ptr(), binfo.data_ptr(),
            near.data_ptr(), buf.shape[0],
            rst.MT, rst.K8, rst.NTL, rst.NTB, int(upward), int(plan.shared),
            plan.ent_cap, plan.threads, plan.far_lanes, plan.near_lanes,
            int(buf.dtype == torch.float64), stream)
        if rc != 0:
            raise RuntimeError(
                f"rsweep kernel launch failed: CUDA error {rc}")
        rsweep.launches += 1
        return buf


rsweep.launches = 0


# ----------------------------------------------------------------------
# the xla engine's sweeps: the theta-column sweep (CUDA kernel wrapper +
# plain twin) and the plain radial sweep
# ----------------------------------------------------------------------


def _col_relax(cur, w0, d0, cfp, cbp, chain_spans):
    """In-column relaxation: dc=0 taps (Gauss-Seidel) + chain scans."""
    for i, dm in enumerate(d0):
        cur = torch.minimum(cur, torch.roll(cur, -dm, dims=-1) + w0[i])
    for k, s in enumerate(chain_spans):
        cur = torch.minimum(cur, torch.roll(cur, s, dims=-1) + cfp[k])
    for k, s in enumerate(chain_spans):
        cur = torch.minimum(cur, torch.roll(cur, -s, dims=-1) + cbp[k])
    return cur


def _tap_groups(tbl: SweepTables, st: SweepStatic, reverse: bool):
    """(g1_w, g1_d, g2_w, g2_d, w0, d0): the weight rows and slot offsets
    of the dc = -1, -2 taps (forward) or +1, +2 (reverse), and of dc = 0."""
    g = _DC_RANGE  # index of dc=0 in the group tuples
    s1, s2 = (g + 1, g + 2) if reverse else (g - 1, g - 2)
    return (tbl.wg[s1], st.dms[s1], tbl.wg[s2], st.dms[s2], tbl.wg[g],
            st.dms[g])


def _sweep(v, tbl: SweepTables, st: SweepStatic, reverse: bool,
           col_relax: bool = True, carry_init=None):
    """One directional Gauss-Seidel sweep over theta columns, plain
    PyTorch: the JAX package's `_sweep` (a `lax.scan` there, a loop over
    the columns here), and the twin of `tsweep`.

    v: (S, nt, ML).  Forward applies the dc=-1,-2 taps (source column
    already updated this sweep); backward the dc=+1,+2 taps.
    col_relax=False drops the in-column work (the "kernel" modes: full
    field ring/chain scans run between sweeps instead).  carry_init
    optionally injects the two predecessor columns the scan starts from
    -- ((S, ML) at distance 1, (S, ML) at distance 2) in processing
    order; default is this field's own wrap columns (plain Gauss-Seidel
    staleness).  The theta-sharded solver passes its neighbour block's
    halo columns here (parallel/theta_shard.py).  The taps from the two
    previous columns are taken as one gather and one minimum over the
    taps: the same floats as the JAX package's tap-by-tap minima (one
    add a candidate, the minimum is exact).
    """
    g1_w, g1_d, g2_w, g2_d, w0, d0 = _tap_groups(tbl, st, reverse)
    ML = v.shape[-1]
    lane = torch.arange(ML, device=v.device)
    idx1 = (lane[None, :] + torch.tensor(g1_d, device=v.device)[:, None]) % ML
    idx2 = (lane[None, :] + torch.tensor(g2_d, device=v.device)[:, None]) % ML
    xs = v.transpose(0, 1)                              # (nt, S, ML)
    if reverse:
        xs = torch.flip(xs, dims=[0])
    if carry_init is None:
        carry_init = (xs[-1], xs[-2])
    p1, p2 = carry_init
    ys = []
    for x in xs:
        cur = torch.minimum(x, (p1[:, idx1] + g1_w).amin(dim=1))
        cur = torch.minimum(cur, (p2[:, idx2] + g2_w).amin(dim=1))
        if col_relax:
            cur = _col_relax(cur, w0, d0, tbl.cfp, tbl.cbp, st.chain_spans)
        ys.append(cur)
        p1, p2 = cur, p1
    ys = torch.stack(ys)
    if reverse:
        ys = torch.flip(ys, dims=[0])
    return ys.transpose(0, 1).contiguous()


# The kernel's block: at most TSWEEP_THREADS threads, holding the fewest
# lanes a thread (of TSWEEP_LPT) that cover the column.
TSWEEP_THREADS = 1024
TSWEEP_LPT = (1, 2, 4, 8, 16)


class TSweepPlan(NamedTuple):
    """One tsweep launch: `offs` the int32 offsets (the n1 + n2 step-1
    offsets as they are, then with col_relax the n0 + 2L in-column
    offsets reduced mod ML: d0, then -s, then +s for the chain spans),
    `halo` lanes each side of the p1 / p2 columns (the largest step-1
    offset), `lpt` lanes a thread, `threads` a block and `smem` bytes of
    shared memory a block; `route` "shared" (the columns in shared
    memory, lanes in registers) or "global" (the columns in global
    memory, for a column the shared route cannot hold; lpt and smem 0)."""

    offs: np.ndarray
    halo: int
    lpt: int
    threads: int
    smem: int
    route: str = "shared"


def tsweep_offsets(d1, d2, d0, chain_spans, ML: int,
                   col_relax: bool) -> np.ndarray:
    """The kernel's offsets of one column (the same for every column): the
    dc = -+1 and -+2 taps as they are, then, with col_relax, the
    in-column steps reduced mod ML."""
    steps = []
    if col_relax:
        steps = ([int(d) % ML for d in d0]
                 + [(-int(s)) % ML for s in chain_spans]
                 + [int(s) % ML for s in chain_spans])
    return np.asarray([int(d) for d in d1] + [int(d) for d in d2] + steps,
                      np.int32)


def tsweep_smem_bytes(ML: int, itemsize: int, halo: int, rows: int) -> int:
    """Dynamic shared memory of one block: a pointer (8 bytes) and an
    offset (4 bytes) a weight row of a column, the chain's two columns,
    and three columns with `halo` lanes each side (p1, p2 and the
    next)."""
    return 12 * rows + (2 * ML + 3 * (ML + 2 * halo)) * itemsize


def tsweep_plan(ML: int, itemsize: int, d1, d2, d0, chain_spans,
                col_relax: bool) -> TSweepPlan:
    """The launch of one sweep: on the shared route, the fewest lanes a
    thread whose lanes fit TSWEEP_THREADS threads (a multiple of 32),
    where its five columns fit an H100 block's shared memory; else the
    global route (a thread a lane, up to TSWEEP_THREADS, looping).
    Raises ValueError only for tables no route takes: no dc = -+1 or -+2
    tap, or a step-1 offset (the halo) over ML lanes."""
    if not len(d1) and not len(d2):
        raise ValueError("tsweep needs at least one dc = -+1 or -+2 tap")
    offs = tsweep_offsets(d1, d2, d0, chain_spans, ML, col_relax)
    halo = max(abs(int(d)) for d in list(d1) + list(d2))
    if halo > ML:
        raise ValueError(f"a tsweep tap reaches {halo} lanes: over the "
                         f"column's {ML} lanes")
    lpt = next((k for k in TSWEEP_LPT if -(-ML // k) <= TSWEEP_THREADS),
               None)
    smem = tsweep_smem_bytes(ML, itemsize, halo, len(offs))
    if lpt is None or smem > BLOCK_SMEM:
        return TSweepPlan(offs, halo, 0, min(TSWEEP_THREADS,
                                             (ML + 31) // 32 * 32), 0,
                          "global")
    threads = max(32, (-(-ML // lpt) + 31) // 32 * 32)
    return TSweepPlan(offs, halo, lpt, threads, smem)


def _tsweep_offs_on(plan: TSweepPlan, device) -> torch.Tensor:
    """The plan's offsets on `device`, cached by their bytes."""
    key = (plan.offs.tobytes(), str(device))
    t = _TSWEEP_OFFS.get(key)
    if t is None:
        t = torch.from_numpy(plan.offs).to(device)
        _TSWEEP_OFFS[key] = t
    return t


_TSWEEP_OFFS: dict = {}


def _tsweep_lib() -> ctypes.CDLL:
    lib = kernels.load("tsweep")
    fn = lib.tsweep_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])
        g = lib.tsweep_global_launch
        g.restype = ctypes.c_int
        g.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                      + [ctypes.c_void_p])
    return lib


def tsweep(v: torch.Tensor, tbl: SweepTables, static: SweepStatic,
           reverse: bool, col_relax: bool = True,
           carry_init=None) -> torch.Tensor:
    """One directional Gauss-Seidel sweep over the theta columns of the
    (S, nt, ML) field (see `_sweep`); returns a new field.

    A CUDA tensor goes to the hand-written kernel `csrc/tsweep.cu`, one
    block a source marching the columns as `tsweep_plan` lays it out:
    the columns in shared memory, or in global memory for a column too
    wide for that (launched on the current stream; `tsweep.launches`
    counts the launches); a refused launch raises RuntimeError.  A CPU
    tensor goes to `_sweep`.  Any other device raises.
    """
    if v.dim() != 3 or v.shape[1] != static.nt or v.shape[2] != static.ML:
        raise ValueError(f"v must be (S, {static.nt}, {static.ML}), got "
                         f"{tuple(v.shape)}")
    if carry_init is not None:
        carry_init = tuple(carry_init)
        if len(carry_init) != 2 or any(
                tuple(c.shape) != (v.shape[0], static.ML)
                for c in carry_init):
            raise ValueError(f"carry_init must be two ({v.shape[0]}, "
                             f"{static.ML}) columns")
    if v.device.type == "cpu":
        return _sweep(v, tbl, static, reverse, col_relax, carry_init)
    if v.device.type != "cuda":
        raise ValueError(f"tsweep runs on cuda or cpu, not {v.device}")
    kernels.require_float("tsweep", v.dtype)
    g1_w, g1_d, g2_w, g2_d, w0, d0 = _tap_groups(tbl, static, reverse)
    L = len(static.chain_spans)
    tabs = (g1_w, g2_w, w0, tbl.cfp, tbl.cbp)
    rows = (len(g1_d), len(g2_d), len(d0), L, L)
    for a, n in zip(tabs, rows):
        if (a.device != v.device or a.dtype != v.dtype
                or tuple(a.shape) != (n, static.ML) or not a.is_contiguous()):
            raise ValueError(f"a weight table ({a.device}, {a.dtype}, "
                             f"{tuple(a.shape)}) does not fit the field "
                             f"({v.device}, {v.dtype}, {n} x {static.ML})")
    plan = tsweep_plan(static.ML, v.element_size(), g1_d, g2_d, d0,
                       static.chain_spans, col_relax)
    x = v.contiguous()
    if carry_init is not None:
        carry_init = tuple(c.to(v.dtype).contiguous() for c in carry_init)
    out = torch.empty_like(x)
    offs = _tsweep_offs_on(plan, v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    ptrs = (x.data_ptr(), out.data_ptr(),
            0 if carry_init is None else carry_init[0].data_ptr(),
            0 if carry_init is None else carry_init[1].data_ptr(),
            g1_w.data_ptr(), g2_w.data_ptr(), w0.data_ptr(),
            tbl.cfp.data_ptr(), tbl.cbp.data_ptr(), offs.data_ptr())
    dims = (x.shape[0], static.nt, static.ML, len(g1_d), len(g2_d),
            len(d0), L, plan.halo, int(reverse), int(col_relax))
    is_double = int(v.dtype == torch.float64)
    if plan.route == "global":
        scratch = torch.empty((x.shape[0], 2, static.ML), dtype=x.dtype,
                              device=x.device)
        rc = _tsweep_lib().tsweep_global_launch(
            *ptrs, scratch.data_ptr(), *dims, plan.threads, is_double,
            stream)
    else:
        rc = _tsweep_lib().tsweep_launch(
            *ptrs, *dims, plan.lpt, plan.threads, plan.smem, is_double,
            stream)
    if rc != 0:
        raise RuntimeError(f"tsweep kernel launch failed: CUDA error {rc}")
    tsweep.launches += 1
    return out


tsweep.launches = 0


def _sweep_r(v, tbl: SweepTables, st: SweepStatic, upward: bool,
             row_relax: bool = True, seam_blind: bool = False):
    """One radial Gauss-Seidel sweep over slot rows, plain PyTorch (the
    JAX package's `_sweep_r`; its TPU kernel is `rsweep`, which the
    pallas engine runs on the packed tables instead).

    v: (S, nt, ML).  Downward (upward=False) processes slots in
    DESCENDING order: destination row m reads rows m + dm with dm > 0
    (already updated this sweep).  Upward is the mirror (dm < 0 taps,
    ascending order).  Within each row, a full-reach theta ring scan
    (log-doubling with the per-slot ring hop cost) plus the dm=0,
    dc=+-2 taps.  `seam_blind` reads +inf where a theta shift crosses
    the seam (the TPU kernel's non-wrapping lane shift).

    Each row takes all its taps as one gather of the rows and lanes they
    read and one minimum over the taps (the same floats as the JAX
    package's tap-by-tap minima); the ring scan's step costs s * ring_f[m]
    are the same products, taken for all rows at once.
    """
    S, nt, ML = v.shape
    taps = st.taps_up if upward else st.taps_dn
    wr = tbl.wr_up if upward else tbl.wr_dn
    K = max(abs(dm) for dm, _ in taps)
    dev = v.device
    inf = float("inf")
    buf = v.permute(2, 0, 1)                                # (ML, S, nt)
    pad = torch.full((K, S, nt), inf, dtype=v.dtype, device=dev)
    # the reading side: above (higher m) for down, below for up
    buf_p = torch.cat([buf, pad] if not upward else [pad, buf], 0)
    off = 0 if not upward else K                    # row m at buf_p[m + off]
    t_dm = torch.tensor([dm for dm, _ in taps], device=dev)
    t_dc = torch.tensor([dc for _, dc in taps], device=dev)
    col = torch.arange(nt, device=dev)
    src_lane = col[None, :] + t_dc[:, None]                 # (T, nt)
    blind = (src_lane < 0) | (src_lane >= nt)
    src_lane = src_lane % nt
    w_all = wr[:, : len(taps)]
    spans = []
    s = 1
    while s < nt:
        spans.append(s)
        s *= 2
    rf = torch.stack([s * tbl.ring_f for s in spans])       # (n_sp, ML)
    rb = torch.stack([s * tbl.ring_b for s in spans])
    rows = range(ML) if upward else range(ML - 1, -1, -1)
    for m in rows:
        src = buf_p[(m + off + t_dm)[:, None], :, src_lane]    # (T, nt, S)
        if seam_blind:
            src = torch.where(blind[:, :, None], inf, src)
        cand = (src + w_all[m][:, None, None]).amin(dim=0).T  # (S, nt)
        cur = torch.minimum(buf_p[m + off], cand)
        if row_relax:
            for k, s in enumerate(spans):
                cur = torch.minimum(cur,
                                    torch.roll(cur, s, dims=-1) + rf[k, m])
            for k, s in enumerate(spans):
                cur = torch.minimum(cur,
                                    torch.roll(cur, -s, dims=-1) + rb[k, m])
            cur = torch.minimum(cur, torch.roll(cur, 2, dims=-1)
                                + tbl.ring2_f[m])
            cur = torch.minimum(cur, torch.roll(cur, -2, dims=-1)
                                + tbl.ring2_b[m])
        buf_p[m + off] = cur
    out = buf_p[:ML] if not upward else buf_p[K:]
    return out.permute(1, 2, 0).contiguous()


# ----------------------------------------------------------------------
# the round
# ----------------------------------------------------------------------


class SweepState(NamedTuple):
    dist: torch.Tensor    # (S, nt, ML)
    cen: torch.Tensor     # (S,)
    changed: bool
    it: int               # round count


def _ring_chain(v, tbl: SweepTables, static: SweepStatic):
    """Full-field ring (theta) and chain (slot) min-plus doubling scans,
    exact torch.roll wrap (the span `sweep.ring_chain`)."""
    with profiling.span("sweep.ring_chain", v.device):
        nt = static.nt
        s = 1
        while s < nt:
            v = torch.minimum(v, torch.roll(v, s, dims=1) + s * tbl.ring_f)
            s *= 2
        s = 1
        while s < nt:
            v = torch.minimum(v, torch.roll(v, -s, dims=1) + s * tbl.ring_b)
            s *= 2
        for k, sp in enumerate(static.chain_spans):
            v = torch.minimum(v, torch.roll(v, sp, dims=2) + tbl.cfp[k])
        for k, sp in enumerate(static.chain_spans):
            v = torch.minimum(v, torch.roll(v, -sp, dims=2) + tbl.cbp[k])
        return v


def _hscan(v, tbl: SweepTables, static: SweepStatic):
    """Hierarchical horizontal closure: ascending spans so a run of
    length L composes from its binary digits as the field updates level
    by level (Gauss-Seidel between levels; Jacobi across the 2*cap+1
    slot-drift taps within one (level, sign), which read windows of ONE
    +inf-padded copy of the span-rolled field; the span `sweep.hscan`)."""
    with profiling.span("sweep.hscan", v.device):
        cap = static.h_cap
        S, nt, ML = v.shape
        pad = torch.full((S, nt, cap), float("inf"), dtype=v.dtype,
                         device=v.device)
        for k, span in enumerate(static.h_spans):
            for s_i, sgn in enumerate((+1, -1)):
                vp = torch.cat([pad, torch.roll(v, sgn * span, dims=1), pad],
                               dim=2)
                win = vp.unfold(2, ML, 1)   # (S, nt, 2cap+1, ML): dm + cap
                cand = (win + tbl.wh[k][s_i]).amin(dim=2)
                v = torch.minimum(v, cand)
        return v


def _seam_plan(tbl: SweepTables, static: SweepStatic, rst: RSweepStatic,
               device):
    """Index tensors of `seamfix`: per kernel-blind boundary (the theta
    wrap plus, when the radial kernel is lane-blocked, each block edge
    k*NTB) the 8 circular columns around it and the 4 destination
    columns in their middle; per dc group the (Dg, ML) lane index of
    each diagonal's slot shift."""
    nt, ML = static.nt, static.ML
    nb_lanes = rst.NTL // rst.NTB
    bounds = [0] + [k * rst.NTB for k in range(1, nb_lanes)
                    if k * rst.NTB < nt]
    windows = [
        (torch.tensor([(b - 4 + i) % nt for i in range(8)], device=device),
         torch.tensor([(b - 2 + j) % nt for j in range(4)], device=device))
        for b in bounds]
    m = np.arange(ML)
    shifts = [torch.as_tensor((m[None, :] + np.asarray(d)[:, None]) % ML,
                              device=device)
              for d in static.dms]
    # each tensor is a copy from host memory
    profiling.count(profiling.HOST_SYNCS, 2 * len(windows) + len(shifts))
    return windows, shifts


def _seamfix(v, tbl: SweepTables, static: SweepStatic, plan):
    """Apply the FULL band stencil to the seam-adjacent destination
    columns of every boundary (in place on the fresh field `v`);
    sequential per boundary, Jacobi within one."""
    windows, shifts = plan
    for widx, didx in windows:
        W8 = v[:, widx, :]                                  # (S, 8, ML)
        dst = W8[:, 2:6, :]
        for g_i, dc in enumerate(range(-_DC_RANGE, _DC_RANGE + 1)):
            src = W8[:, 2 + dc: 6 + dc, :][:, :, shifts[g_i]]  # (S,4,Dg,ML)
            dst = torch.minimum(dst, (src + tbl.wg[g_i]).amin(dim=2))
        v[:, didx, :] = dst
    return v


def _to_T(v, rst: RSweepStatic, upward: bool):
    """(S, nt, ML) -> (S, MT+K8, NTL) kernel buffer: slots as rows, theta
    as lanes, +inf pad lanes [nt, NTL) and K8 +inf pad rows above the
    field (down) or below it (up); the span `sweep.layout`."""
    with profiling.span("sweep.layout", v.device):
        S, nt, _ = v.shape
        buf = torch.full((S, rst.MT + rst.K8, rst.NTL), float("inf"),
                         dtype=v.dtype, device=v.device)
        off = rst.K8 if upward else 0
        buf[:, off: off + rst.MT, :nt] = v[:, :, : rst.MT].transpose(1, 2)
        return buf


def _from_T(buf, rst: RSweepStatic, nt: int, ML: int, upward: bool):
    """Inverse of `_to_T`: slot pad lanes [MT, ML) come back +inf (the
    span `sweep.layout`)."""
    with profiling.span("sweep.layout", buf.device):
        S = buf.shape[0]
        off = rst.K8 if upward else 0
        v = torch.full((S, nt, ML), float("inf"), dtype=buf.dtype,
                       device=buf.device)
        v[:, :, : rst.MT] = buf[:, off: off + rst.MT, :nt].transpose(1, 2)
        return v


def _fan(v, cen, fan, fan_in):
    """The centre's min over the fan, then its spread back out."""
    cen = torch.minimum(cen, (v + fan_in).amin(dim=(1, 2)))
    return torch.minimum(v, cen[:, None, None] + fan), cen


def _run_sweep_rounds(dist0, cen0, it0: int, tbl: SweepTables, wtab_dn,
                      wtab_up, tol, static: SweepStatic, rst: RSweepStatic,
                      max_iters: int, halo_map=None,
                      plan=None) -> SweepState:
    """Rounds from an explicit initial field until no distance improves
    by more than `tol` (read once per round) or `max_iters` rounds.

    `halo_map` ((K, ML) int64 tensor, optional): the staged solves' twin
    min-merge (`_twin_merge`), once per round after the seamfix,
    improvement-gated against the round-start field.  `plan`: the
    seamfix's index tensors (`_seam_plan`), made here when None.

    Each round is a `sweep.round` span (profiling.span) whose child spans
    tile it: `sweep.fan`, then a radial sweep (`_to_T`, `rsweep` and
    `_from_T`: `sweep.layout`, `sweep.rsweep`, `sweep.layout`) and a
    closure (`_ring_chain`, `_hscan`) down and up, `sweep.seamfix`,
    `sweep.converged`."""
    nt, ML = static.nt, static.ML
    dev = dist0.device
    fan, fan_in = tbl.fan_w, tbl.fan_in
    if plan is None:
        plan = _seam_plan(tbl, static, rst, dev)
    v, cen, it, changed = dist0, cen0, it0, True
    while changed and it < max_iters:
        with profiling.span("sweep.round", dev):
            v0, cen0 = v, cen
            with profiling.span("sweep.fan", dev):
                v, cen = _fan(v, cen, fan, fan_in)
            v = _from_T(rsweep(_to_T(v, rst, False), wtab_dn, rst, False),
                        rst, nt, ML, False)
            v = _hscan(_ring_chain(v, tbl, static), tbl, static)
            v = _from_T(rsweep(_to_T(v, rst, True), wtab_up, rst, True),
                        rst, nt, ML, True)
            v = _hscan(_ring_chain(v, tbl, static), tbl, static)
            with profiling.span("sweep.seamfix", dev):
                v = _seamfix(v, tbl, static, plan)
                if halo_map is not None:
                    v = _twin_merge(v, v0, halo_map)
            with profiling.span("sweep.converged", dev):
                profiling.count(profiling.HOST_SYNCS)
                changed = bool(((v < v0 - tol).any()
                                | (cen < cen0 - tol).any()).item())
        it += 1
    # settle the fan after the last round (a no-op after a no-change
    # round; it matters only when max_iters cut the loop)
    with profiling.span("sweep.fan", dev):
        v, cen = _fan(v, cen, fan, fan_in)
    return SweepState(v, cen, changed, it)


def _solve_sweep(src_m, src_c, src_cen, tbl: SweepTables, wtab_dn,
                 wtab_up, tol, static: SweepStatic, rst: RSweepStatic,
                 max_iters: int) -> SweepState:
    """Full solve of a source block on the tables' device: zero at each
    source's (column, slot), or at the centre for centre sources."""
    dev = wtab_dn.device
    with profiling.span("sweep.chunk_setup", dev):
        dist0, cen0 = _source_field(src_m, src_c, src_cen, static.nt,
                                    static.ML, wtab_dn.dtype, dev)
        plan = _seam_plan(tbl, static, rst, dev)
    return _run_sweep_rounds(dist0, cen0, 0, tbl, wtab_dn, wtab_up, tol,
                             static, rst, max_iters, plan=plan)


# each xla-engine mode's sweep sequence of a round (the fan runs first):
# "theta" = fwd+bwd column sweeps, "r" = down+up radial sweeps, "both" =
# down, fwd, up, bwd; "kernel" and "kernel-r" apply raw taps only in the
# sweeps, with the full-field ring/chain scans between them (kernel-r
# also seam-blind, no column sweeps); "hclosure" is the pallas engine's
# structure with exact wraps everywhere
SWEEP_MODES = {
    "theta": ("fwd", "bwd"),
    "r": ("down", "up"),
    "both": ("down", "fwd", "up", "bwd"),
    "kernel": ("down", "scans", "up", "scans", "fwd", "bwd", "scans"),
    "kernel-r": ("down", "scans", "up", "scans"),
    "hclosure": ("down", "scans", "hscan", "up", "scans", "hscan"),
}


def _source_field(src_m, src_c, src_cen, ntl: int, ML: int, dtype, dev,
                  col0: int = 0):
    """(dist0, cen0) of the theta columns [col0, col0 + ntl): zero at
    each source's (column, slot) that lies there, or at the centre for
    centre sources, +inf elsewhere.  The whole field is col0 = 0, ntl =
    nt; the theta-sharded solve builds its rank's block."""
    S = len(src_m)
    dist0 = torch.full((S, ntl, ML), float("inf"), dtype=dtype, device=dev)
    cen0 = torch.full((S,), float("inf"), dtype=dtype, device=dev)
    for b in range(S):
        # a Python number written into a device tensor is a copy from
        # host memory
        if src_cen[b]:
            profiling.count(profiling.HOST_SYNCS)
            cen0[b] = 0.0
        elif col0 <= int(src_c[b]) < col0 + ntl:
            profiling.count(profiling.HOST_SYNCS)
            dist0[b, int(src_c[b]) - col0, int(src_m[b])] = 0.0
    return dist0, cen0


def _solve_sweep_xla(src_m, src_c, src_cen, tbl: SweepTables, tol,
                     static: SweepStatic, max_iters: int,
                     mode: str = "both") -> SweepState:
    """The JAX package's xla engine (`_solve_sweep_jit`): rounds of
    `mode`'s sweep sequence (SWEEP_MODES) from the source field until no
    distance improves by more than `tol` (one host read a round).  The
    column sweeps go through `tsweep` (the kernel on the card), the
    radial sweeps and scans are plain tensor code."""
    seq = SWEEP_MODES[mode]
    bare = mode.startswith("kernel") or mode == "hclosure"
    blind = mode == "kernel-r"
    dist0, cen0 = _source_field(src_m, src_c, src_cen, static.nt,
                                static.ML, tbl.cfp.dtype, tbl.cfp.device)
    fan, fan_in = tbl.fan_w, tbl.fan_in
    v, cen, it, changed = dist0, cen0, 0, True
    while changed and it < max_iters:
        v0, cen0 = v, cen
        v, cen = _fan(v, cen, fan, fan_in)
        for step in seq:
            if step in ("fwd", "bwd"):
                v = tsweep(v, tbl, static, step == "bwd", col_relax=not bare)
            elif step in ("down", "up"):
                v = _sweep_r(v, tbl, static, step == "up",
                             row_relax=not bare, seam_blind=blind)
            elif step == "hscan":
                v = _hscan(v, tbl, static)
            else:
                v = _ring_chain(v, tbl, static)
        changed = bool(((v < v0 - tol).any()
                        | (cen < cen0 - tol).any()).item())
        it += 1
    # settle the fan after the last round (a no-op after a no-change
    # round; it matters only when max_iters cut the loop)
    v, cen = _fan(v, cen, fan, fan_in)
    return SweepState(v, cen, changed, it)


def device_tables(ws: TWStencil, cg: CirculantGraph, dtype, device):
    """(tables, static, wtab_dn, wtab_up, rst) with the tensors on
    `device`, cached in the stencil's dcache per device."""
    key = ("sweep_device", str(device))
    with profiling.setup_span("build.sweep_tables", key not in ws.dcache):
        tbl, static = pack_sweep_tables(ws, cg, dtype)
        (wdn, wup), rst = pack_rsweep_tables(ws, cg, dtype)
        if key not in ws.dcache:
            ws.dcache[key] = (
                tables_to_device(tbl, device),
                torch.tensor(wdn, device=device),
                torch.tensor(wup, device=device))
            if (torch.device(device).type == "cuda"
                    and wdn.dtype == np.float32):
                # the kernel's packed taps, once per upload
                _kernel_tables(ws.dcache[key][1], rst, False)
                _kernel_tables(ws.dcache[key][2], rst, True)
    tbl_t, wdn_t, wup_t = ws.dcache[key]
    return tbl_t, static, wdn_t, wup_t, rst


def solve_circulant_sweep(
    cg: CirculantGraph,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    batch: int = 1,
    receivers=None,
    device_out: bool = False,
    mode: str = "hclosure",
    engine: str = "xla",
    device="cuda",
    _packed: TWStencil = None,
) -> Tuple[np.ndarray, int]:
    """Directional-sweep solve on `device`.  Sources run in chunks of
    `batch`; returns ((n_sources, n_out) host array, rounds), n_out = all
    nodes or the `receivers`.  `device_out=True` returns the rows as a
    tensor on the device.  The rounds count SWEEP ROUNDS (typically 2-4).

    engine="pallas" is the production structure (radial sweeps on the
    `rsweep` kernel, hclosure rounds with the seamfix; `mode` is not
    read), what `AnnulusSolver(method="sweep")` runs; "xla" is the JAX
    package's pure-jnp engine with exact wraps everywhere, in any of the
    SWEEP_MODES (its column sweeps on the `tsweep` kernel on the card).
    The defaults are the JAX package's; there `interpret` picks the CPU
    route, here `device` does.
    """
    if engine not in ("xla", "pallas"):
        raise ValueError(f"unknown engine {engine!r}: 'xla' or 'pallas'")
    if engine == "xla" and mode not in SWEEP_MODES:
        raise ValueError(f"unknown mode {mode!r}: one of "
                         f"{', '.join(SWEEP_MODES)}")
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=dtype, band_closure=0)
    tbl, static, wdn, wup, rst = device_tables(ws, cg, dtype, device)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    S = max(1, min(batch, len(sources)))
    profiling.count(profiling.HOST_SYNCS)   # tol, a copy from host memory
    tol = torch.tensor(config.tol_value(), dtype=wdn.dtype, device=device)
    n_out, ext = _extract_cached(ws.dcache, cmap, receivers, device)

    def dispatch(chunk):
        is_cen = chunk == cmap.center
        src_m = np.where(is_cen, 0, cmap.m_of[chunk])
        src_c = np.where(is_cen, 0, cmap.c_of[chunk])
        if engine == "pallas":
            st = _solve_sweep(src_m, src_c, is_cen, tbl, wdn, wup, tol,
                              static, rst, config.max_iters)
        else:
            st = _solve_sweep_xla(src_m, src_c, is_cen, tbl, tol, static,
                                  config.max_iters, mode)
        return _textract(st.dist, st.cen, st.it, *ext)

    return _pipelined_chunk_solve(sources, S, n_out, dtype, dispatch,
                                  device_out=device_out)


# ----------------------------------------------------------------------
# the staged solve (the reference's multi-stage and multiphase sweeps)
# ----------------------------------------------------------------------


class SweepStageSpec(NamedTuple):
    """One stage of a staged (multi-level) directional-sweep solve.

    tables/wtab_dn/wtab_up: destination-masked stage tables from
        pack_sweep_tables / pack_rsweep_tables with slot_mask set (may
        also carry stage-specific weights, e.g. multiphase boundary
        velocity swaps); NumPy arrays or tensors on the solve's device
        (`sweep_stage_to_device`: a stage kept across solves uploads and
        plans its rsweep tables once)
    reset_keep: None, or (ML,) bool: before the stage, slots NOT in it
        reset to +inf (the ms boundary restart)
    cen_keep  : centre value survives the reset
    halo_map  : (K, ML) int partner-slot maps for the unmasked twin
        min-merge (identity-padded); None = no halo
    """

    tables: SweepTables
    wtab_dn: object
    wtab_up: object
    reset_keep: object = None
    cen_keep: bool = True
    halo_map: object = None


def sweep_stage_to_device(stage: SweepStageSpec, device) -> SweepStageSpec:
    """The stage with its tables, masks and maps as tensors on `device`
    (the rsweep kernel's plan of a table is packed at its first launch
    and kept on the tensor, `_kernel_tables`)."""
    device = torch.device(device)
    tbl = stage.tables
    if not _is_on(tbl.cfp, device):
        tbl = tables_to_device(tbl, device)
    return stage._replace(
        tables=tbl, wtab_dn=_on(stage.wtab_dn, device),
        wtab_up=_on(stage.wtab_up, device),
        **_restart_to_device(stage, device))


def _solve_sweep_staged(src_m, src_c, src_cen, stages, tol,
                        static: SweepStatic, rst: RSweepStatic,
                        max_iters: int) -> SweepState:
    """Sequential level-masked sweep stages from (S,) source descriptors;
    `it` carries across stages and `max_iters` caps the total."""
    wdn0 = stages[0].wtab_dn
    dev, dtype = wdn0.device, wdn0.dtype
    S = len(src_m)
    inf = float("inf")
    dist = torch.full((S, static.nt, static.ML), inf, dtype=dtype,
                      device=dev)
    cen = torch.full((S,), inf, dtype=dtype, device=dev)
    for b in range(S):
        if src_cen[b]:
            cen[b] = 0.0
        else:
            dist[b, int(src_c[b]), int(src_m[b])] = 0.0
    st = SweepState(dist, cen, True, 0)
    for sp in stages:
        dist, cen = st.dist, st.cen
        if sp.reset_keep is not None:
            dist = torch.where(sp.reset_keep, dist,
                               torch.tensor(inf, dtype=dtype, device=dev))
            if not sp.cen_keep:
                cen = torch.full_like(cen, inf)
        st = _run_sweep_rounds(dist, cen, st.it, sp.tables, sp.wtab_dn,
                               sp.wtab_up, tol, static, rst, max_iters,
                               halo_map=sp.halo_map)
    return st


def solve_sweep_staged(
    cg: CirculantGraph,
    ws: TWStencil,
    stages,
    sources,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    batch: int = 1,
    receivers=None,
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """Run SweepStageSpec stages one after another on `device` (the
    circulant fast path of the reference's bfm_ms / bfm_multiphase layer
    sweeps, ~3-4 rounds a stage).  API mirrors
    ops/stream_t.py::solve_stream_staged; `ws` is the (closure-free)
    stencil whose dcache holds the extraction arrays.  Returns
    ((n_sources, n_out) host array, rounds summed over the stages)."""
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    _, static = pack_sweep_tables(ws, cg, dtype)
    _, rst = pack_rsweep_tables(ws, cg, dtype)
    stages = [sweep_stage_to_device(sp, device) for sp in stages]
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    S = max(1, min(batch, len(sources)))
    tol = torch.tensor(config.tol_value(), dtype=stages[0].wtab_dn.dtype,
                       device=device)
    n_out, ext = _extract_cached(ws.dcache, cmap, receivers, device)

    def dispatch(chunk):
        is_cen = chunk == cmap.center
        src_m = np.where(is_cen, 0, cmap.m_of[chunk])
        src_c = np.where(is_cen, 0, cmap.c_of[chunk])
        st = _solve_sweep_staged(src_m, src_c, is_cen, stages, tol, static,
                                 rst, config.max_iters)
        return _textract(st.dist, st.cen, st.it, *ext)

    return _pipelined_chunk_solve(sources, S, n_out, dtype, dispatch)
