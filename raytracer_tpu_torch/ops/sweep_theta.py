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
    `rsweep_reference`.  Any other device raises.
    """
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
        buf.data_ptr(), ent.data_ptr(), binfo.data_ptr(), near.data_ptr(),
        buf.shape[0],
        rst.MT, rst.K8, rst.NTL, rst.NTB, int(upward), int(plan.shared),
        plan.ent_cap, plan.threads, plan.far_lanes, plan.near_lanes,
        int(buf.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"rsweep kernel launch failed: CUDA error {rc}")
    rsweep.launches += 1
    return buf


rsweep.launches = 0


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
    exact torch.roll wrap."""
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
    +inf-padded copy of the span-rolled field)."""
    cap = static.h_cap
    S, nt, ML = v.shape
    pad = torch.full((S, nt, cap), float("inf"), dtype=v.dtype,
                     device=v.device)
    for k, span in enumerate(static.h_spans):
        for s_i, sgn in enumerate((+1, -1)):
            vp = torch.cat([pad, torch.roll(v, sgn * span, dims=1), pad],
                           dim=2)
            win = vp.unfold(2, ML, 1)      # (S, nt, 2cap+1, ML): dm + cap
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
    field (down) or below it (up)."""
    S, nt, _ = v.shape
    buf = torch.full((S, rst.MT + rst.K8, rst.NTL), float("inf"),
                     dtype=v.dtype, device=v.device)
    off = rst.K8 if upward else 0
    buf[:, off: off + rst.MT, :nt] = v[:, :, : rst.MT].transpose(1, 2)
    return buf


def _from_T(buf, rst: RSweepStatic, nt: int, ML: int, upward: bool):
    """Inverse of `_to_T`: slot pad lanes [MT, ML) come back +inf."""
    S = buf.shape[0]
    off = rst.K8 if upward else 0
    v = torch.full((S, nt, ML), float("inf"), dtype=buf.dtype,
                   device=buf.device)
    v[:, :, : rst.MT] = buf[:, off: off + rst.MT, :nt].transpose(1, 2)
    return v


def _run_sweep_rounds(dist0, cen0, it0: int, tbl: SweepTables, wtab_dn,
                      wtab_up, tol, static: SweepStatic, rst: RSweepStatic,
                      max_iters: int, halo_map=None) -> SweepState:
    """Rounds from an explicit initial field until no distance improves
    by more than `tol` (read once per round) or `max_iters` rounds.

    `halo_map` ((K, ML) int64 tensor, optional): the staged solves' twin
    min-merge (`_twin_merge`), once per round after the seamfix,
    improvement-gated against the round-start field."""
    nt, ML = static.nt, static.ML
    fan, fan_in = tbl.fan_w, tbl.fan_in
    plan = _seam_plan(tbl, static, rst, dist0.device)
    v, cen, it, changed = dist0, cen0, it0, True
    while changed and it < max_iters:
        v0, cen0 = v, cen
        cen = torch.minimum(cen, (v + fan_in).amin(dim=(1, 2)))
        v = torch.minimum(v, cen[:, None, None] + fan)
        v = _from_T(rsweep(_to_T(v, rst, False), wtab_dn, rst, False),
                    rst, nt, ML, False)
        v = _hscan(_ring_chain(v, tbl, static), tbl, static)
        v = _from_T(rsweep(_to_T(v, rst, True), wtab_up, rst, True),
                    rst, nt, ML, True)
        v = _hscan(_ring_chain(v, tbl, static), tbl, static)
        v = _seamfix(v, tbl, static, plan)
        if halo_map is not None:
            v = _twin_merge(v, v0, halo_map)
        changed = bool(((v < v0 - tol).any()
                        | (cen < cen0 - tol).any()).item())
        it += 1
    # settle the fan after the last round (a no-op after a no-change
    # round; it matters only when max_iters cut the loop)
    cen = torch.minimum(cen, (v + fan_in).amin(dim=(1, 2)))
    v = torch.minimum(v, cen[:, None, None] + fan)
    return SweepState(v, cen, changed, it)


def _solve_sweep(src_m, src_c, src_cen, tbl: SweepTables, wtab_dn,
                 wtab_up, tol, static: SweepStatic, rst: RSweepStatic,
                 max_iters: int) -> SweepState:
    """Full solve of a source block on the tables' device: zero at each
    source's (column, slot), or at the centre for centre sources."""
    dev = wtab_dn.device
    dtype = wtab_dn.dtype
    S = len(src_m)
    dist0 = torch.full((S, static.nt, static.ML), float("inf"),
                       dtype=dtype, device=dev)
    cen0 = torch.full((S,), float("inf"), dtype=dtype, device=dev)
    for b in range(S):
        if src_cen[b]:
            cen0[b] = 0.0
        else:
            dist0[b, int(src_c[b]), int(src_m[b])] = 0.0
    return _run_sweep_rounds(dist0, cen0, 0, tbl, wtab_dn, wtab_up, tol,
                             static, rst, max_iters)


def device_tables(ws: TWStencil, cg: CirculantGraph, dtype, device):
    """(tables, static, wtab_dn, wtab_up, rst) with the tensors on
    `device`, cached in the stencil's dcache per device."""
    tbl, static = pack_sweep_tables(ws, cg, dtype)
    (wdn, wup), rst = pack_rsweep_tables(ws, cg, dtype)
    key = ("sweep_device", str(device))
    if key not in ws.dcache:
        ws.dcache[key] = (
            tables_to_device(tbl, device),
            torch.tensor(wdn, device=device),
            torch.tensor(wup, device=device))
        if torch.device(device).type == "cuda" and wdn.dtype == np.float32:
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
    device="cuda",
    _packed: TWStencil = None,
) -> Tuple[np.ndarray, int]:
    """Directional-sweep solve on `device` (the JAX package's pallas
    engine, hclosure structure).  Sources run in chunks of `batch`;
    returns ((n_sources, n_out) host array, rounds), n_out = all nodes
    or the `receivers`.  `device_out=True` returns the rows as a tensor
    on the device.  The rounds count SWEEP ROUNDS (typically 2-4).
    """
    device = resolve_device(device)
    dtype = np.dtype(config.dtype)
    ws = _packed if _packed is not None else pack_twrapped_stencil(
        cg, dtype=dtype, band_closure=0)
    tbl, static, wdn, wup, rst = device_tables(ws, cg, dtype, device)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    cmap = cg.cmap
    S = max(1, min(batch, len(sources)))
    tol = torch.tensor(config.tol_value(), dtype=wdn.dtype, device=device)
    n_out, ext = _extract_cached(ws.dcache, cmap, receivers, device)

    def dispatch(chunk):
        is_cen = chunk == cmap.center
        src_m = np.where(is_cen, 0, cmap.m_of[chunk])
        src_c = np.where(is_cen, 0, cmap.c_of[chunk])
        st = _solve_sweep(src_m, src_c, is_cen, tbl, wdn, wup, tol, static,
                          rst, config.max_iters)
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
