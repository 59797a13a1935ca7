"""Circulant (rotationally-symmetric) annulus graph layout.

The annulus mesh is rotationally symmetric: every theta column has the
same radial node column, the same secondary-node subdivisions, the same
twin doubling and the same edge weights.  The graph is therefore a
block-circulant matrix: node (c, m) connects to (c + dc, m') with a fixed
stencil {(dc, m, m', w)} independent of the column c.

The core-centre node (shared by all columns) is a scalar state with a
per-slot fan weight vector; halo twin links become zero-weight stencil
edges.

Host table building (`column_map`, `build_circulant`) is NumPy, a copy of
`raytracer_tpu/ops/circulant.py`.  The plain Jacobi solve
(`solve_circulant`, the 'circulant' method and the oracle the kernel
engines are tested against) and the predecessor recovery
(`recover_prev_device`) are torch tensor code on the solver's device,
the counterparts of the JAX package's `_solve_circulant_jit` and
`_prev_argmin_jit`.  `PrevRecovery` (host NumPy) recovers the tree on
graphs without a circulant layout, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig

_DC_RANGE = 2  # star-1 element stencils reach at most +-2 theta columns


class ColumnMap(NamedTuple):
    """Node <-> (column, slot) mapping.  The core centre node is special."""

    c_of: np.ndarray      # (n,) theta column of each node (-1 for centre)
    m_of: np.ndarray      # (n,) within-column slot (-1 for centre)
    node_of: np.ndarray   # (M, ntheta) node id per (slot, column)
    center: int           # node id of the core centre
    M: int
    ntheta: int


def column_map(gr) -> ColumnMap:
    """Assign every node a (column, slot) pair.

    Column = floor(theta / dtheta); slot = rank within the column under the
    (r, theta-offset, twin-class) key, which is identical for every column
    by rotational symmetry.  Keys are quantised to kill fp noise.
    """
    nt = gr.ntheta
    if nt < 3:
        raise CirculantError(f"mesh has no theta-column structure (ntheta={nt})")
    dtheta = getattr(gr, "dtheta_val", None) or (2 * np.pi / nt)
    period = getattr(gr, "period", None) or (2 * np.pi)
    center = int(np.flatnonzero((gr.r == 0.0))[0]) if (gr.r == 0.0).any() else -1

    th = np.mod(gr.theta, period)
    c_of = (np.floor(th / dtheta + 1e-6).astype(np.int64)) % nt
    thfrac = th - c_of * dtheta
    cls = gr.twin_class if gr.twin_class is not None else np.zeros(gr.nnods, np.int8)

    key_r = np.round(gr.r, 6)
    key_t = np.round(thfrac, 9)

    ids = np.arange(gr.nnods)
    mask = ids != center
    order = np.lexsort((cls[mask], key_t[mask], key_r[mask], c_of[mask]))
    sorted_ids = ids[mask][order]
    sorted_c = c_of[mask][order]

    counts = np.bincount(sorted_c, minlength=nt)
    if not np.all(counts == counts[0]):
        raise CirculantError(f"column node counts differ: {np.unique(counts)}")
    M = int(counts[0])

    m_of = np.full(gr.nnods, -1, dtype=np.int64)
    # within each column block (sorted by c), slots are 0..M-1 in key order
    m_of[sorted_ids] = np.tile(np.arange(M), nt)
    c_of_full = c_of.copy()
    if center >= 0:
        c_of_full[center] = -1
        m_of[center] = -1

    node_of = np.empty((M, nt), dtype=np.int64)
    node_of[m_of[sorted_ids], sorted_c] = sorted_ids
    return ColumnMap(c_of=c_of_full, m_of=m_of, node_of=node_of, center=center, M=M, ntheta=nt)


class CirculantError(RuntimeError):
    """Raised when the mesh does not satisfy the circulant symmetry."""


@dataclasses.dataclass(frozen=True)
class CirculantGraph:
    """Stencil form of the annulus graph.

    src_flat : (M, K) int32 - flattened source index (dc+2)*M + m_src into
               the stack of 5 lane-rolled copies of the state matrix
    w        : (M, K) weights, +inf padding
    fan_slots: (F,) slots adjacent to the core centre node
    fan_w    : (F,) centre<->slot weights
    cmap     : node <-> (c, m) mapping
    n        : node count of the original graph
    """

    src_flat: np.ndarray
    w: np.ndarray
    fan_slots: np.ndarray
    fan_w: np.ndarray
    cmap: ColumnMap
    n: int

    @property
    def M(self) -> int:
        return self.cmap.M

    @property
    def ntheta(self) -> int:
        return self.cmap.ntheta


def csr_edge_weights(gr, rows: np.ndarray, cols: np.ndarray, U: np.ndarray) -> np.ndarray:
    """Per-edge weight 2*len/(U_tail+U_head) for edge col->row (pull form).

    Scalar U: harmonic mean (src/SSSP/bfm.jl:185); dual (n,2) U: branch-free
    head/tail above/below pick (src/SSSP/bfm.jl:134-146).

    Periodic WEDGE meshes (gr.dtheta set, models/fast_annulus.py) are only
    combinatorially periodic: their seam edges span nearly the whole wedge
    angle in the flat embedding, so the chord of seam-crossing edges
    (|dtheta| > period/2) is recomputed with the source endpoint shifted by
    one period onto the near side - the geometry the corresponding full-
    annulus edge has.
    """
    from ..utils.coords import polar2cartesian

    L = np.sqrt((gr.x[rows] - gr.x[cols]) ** 2 + (gr.z[rows] - gr.z[cols]) ** 2)
    if getattr(gr, "dtheta", None) is not None:
        period = gr.period
        d = gr.theta[rows] - gr.theta[cols]
        flag = np.abs(d) > period / 2
        if flag.any():
            sh = np.where(d[flag] > 0, period, -period)
            xc, zc = polar2cartesian(gr.theta[cols[flag]] + sh, gr.r[cols[flag]])
            L[flag] = np.sqrt((gr.x[rows[flag]] - xc) ** 2
                              + (gr.z[rows[flag]] - zc) ** 2)
    U = np.asarray(U)
    if U.ndim == 1:
        usum = U[rows] + U[cols]
    else:
        head_above = gr.r[rows] > gr.r[cols]  # ray travels upward from col to row
        U_head = np.where(head_above, U[cols, 1], U[cols, 0])
        U_tail = np.where(head_above, U[rows, 0], U[rows, 1])
        usum = U_tail + U_head
    return _safe_weight(L, usum)


def _safe_weight(L, usum):
    """2L/usum with impassable (usum <= 0) media mapped to +inf, avoiding
    0/0 NaN on zero-length twin edges in zero-velocity regions."""
    return np.where(usum > 0, 2.0 * L / np.where(usum > 0, usum, 1.0), np.inf)


class PrevRecovery:
    """Shortest-path-tree predecessor recovery from a converged field, on
    the host (the JAX package's `PrevRecovery`, for graphs without a
    circulant layout).

    prev[i] = argmin_j dist[j] + w(j->i) over i's neighbours (including
    halo twin links with an epsilon weight to break twin-twin ping-pong
    ties).  The edge list and weights depend only on (gr, A, halo, U):
    build once, call per solve.
    """

    def __init__(self, gr, A: sp.csr_matrix, halo: np.ndarray, U: np.ndarray):
        coo = A.tocoo()
        rows = coo.row.astype(np.int64)
        cols = coo.col.astype(np.int64)
        w = csr_edge_weights(gr, rows, cols, U)
        halo = np.asarray(halo)
        if halo.size:
            rows = np.concatenate([rows, halo[:, 1]])
            cols = np.concatenate([cols, halo[:, 0]])
            w = np.concatenate([w, np.full(halo.shape[0], 1e-6)])
        self.rows, self.cols, self.w = rows, cols, w
        self.n = A.shape[0]

    def __call__(self, dist: np.ndarray) -> np.ndarray:
        rows, cols, w = self.rows, self.cols, self.w
        vals = dist[cols] + w
        # tie-break equal-candidate sets (collinear chains of secondary
        # nodes all lie on the same shortest path) toward the LONGEST hop:
        # quantise to 0.1 ms and prefer the larger edge weight in a tie
        vals_q = np.round(vals * 1e4)
        order = np.lexsort((-w, vals_q, rows))
        rows_s, cols_s = rows[order], cols[order]
        first = np.searchsorted(rows_s, np.arange(self.n))
        # rows with no entries point to themselves
        prev = np.arange(self.n, dtype=np.int64)
        has = np.zeros(self.n, dtype=bool)
        has[rows_s] = True
        safe_first = np.clip(first, 0, len(rows_s) - 1)
        cand_prev = cols_s[safe_first]
        return np.where(has & np.isfinite(dist), cand_prev, prev)


def recover_prev(gr, A: sp.csr_matrix, halo: np.ndarray, U: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """One-shot convenience wrapper around PrevRecovery."""
    return PrevRecovery(gr, A, halo, U)(dist)


def build_circulant(
    gr,
    A: sp.csr_matrix,
    halo: np.ndarray,
    U: np.ndarray,
    dtype=np.float32,
    verify: bool = True,
    rtol: float = 1e-5,
) -> CirculantGraph:
    """Extract and verify the circulant stencil from the general graph."""
    cmap = column_map(gr)
    nt, M = cmap.ntheta, cmap.M

    # the geometry is circulant by construction once column_map succeeds;
    # the VELOCITY FIELD is the free input and must itself be rotationally
    # symmetric - check it exactly on every column (O(n), catches lateral
    # anomalies the sampled pattern comparison below could miss)
    if verify:
        Uarr = np.asarray(U)
        Ucols = Uarr[cmap.node_of]            # (M, nt) or (M, nt, 2)
        ref_col = Ucols[:, :1]
        if not np.allclose(Ucols, ref_col, rtol=rtol, atol=1e-12, equal_nan=True):
            raise CirculantError(
                "velocity field is not rotationally symmetric; use the ELL solver"
            )

    # The edge stream can reach billions of entries at 10M+ nodes; on a
    # single host core the old COO materialisation (int64 row/col copies
    # + ~15 full-length passes) dominated first-build latency (40 min at
    # 12.9M nodes).  Work directly on the CSR arrays instead: column
    # counts come from node degrees (O(n)), the reach check runs as a
    # handful of in-place int32 passes, and the per-column patterns are
    # gathered through CSR row slices (O(E/ntheta) each).
    halo = np.asarray(halo)
    A = A.tocsr()
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    deg = np.diff(indptr).astype(np.int64)
    center = cmap.center
    h_dst = halo[:, 1] if halo.size else np.empty(0, np.int64)
    h_src = halo[:, 0] if halo.size else np.empty(0, np.int64)

    # centre edges: the centre's own CSR row, plus every position whose
    # src is the centre (their dst recovered by one searchsorted)
    if center >= 0:
        c0, c1 = int(indptr[center]), int(indptr[center + 1])
        center_src_pos = np.flatnonzero(indices == center)
        center_src_dst = np.searchsorted(indptr, center_src_pos,
                                         side="right") - 1
        center_src_dst = center_src_dst[center_src_dst != center]
    else:
        c0 = c1 = 0
        center_src_pos = np.empty(0, np.int64)
        center_src_dst = np.empty(0, np.int64)

    # cheap global invariants on the full edge stream
    half = nt // 2
    cs32 = cmap.c_of.astype(np.int32)
    dc_stream = cs32[indices]                      # src column per edge
    np.subtract(dc_stream, np.repeat(cs32, deg), out=dc_stream)
    np.mod(dc_stream, nt, out=dc_stream)
    dc_stream[dc_stream > half] -= nt
    if center >= 0:                                # centre edges exempt
        dc_stream[c0:c1] = 0
        dc_stream[center_src_pos] = 0
    np.abs(dc_stream, out=dc_stream)
    maxreach = int(dc_stream.max(initial=0))
    del dc_stream
    if halo.size:
        h_dc = (cmap.c_of[h_src] - cmap.c_of[h_dst]) % nt
        h_dc = np.where(h_dc > half, h_dc - nt, h_dc).astype(np.int64)
        maxreach = max(maxreach, int(np.abs(h_dc).max(initial=0)))
    else:
        h_dc = np.empty(0, np.int64)
    if maxreach > _DC_RANGE:
        raise CirculantError(
            f"stencil reach {maxreach} exceeds +-{_DC_RANGE} columns"
        )
    # incoming-edge count per column from node degrees (O(n)); edges
    # whose SRC is the centre sit in non-centre rows and are subtracted
    node_mask = cmap.c_of >= 0
    per_col = np.bincount(cmap.c_of[node_mask], weights=deg[node_mask],
                          minlength=nt).astype(np.int64)
    if center_src_dst.size:
        per_col -= np.bincount(cmap.c_of[center_src_dst], minlength=nt)
    if halo.size:
        per_col += np.bincount(cmap.c_of[h_dst], minlength=nt)
    if not np.all(per_col == per_col[0]):
        raise CirculantError(f"edge counts differ across columns: {np.unique(per_col)}")
    E = int(per_col[0])

    def _csr_positions(nodes: np.ndarray) -> np.ndarray:
        """Positions of the CSR entries of `nodes` (ascending node id,
        row-major — the COO stream order of those rows)."""
        starts, ends = indptr[nodes], indptr[nodes + 1]
        cnt = (ends - starts).astype(np.int64)
        total = int(cnt.sum())
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        return (np.arange(total, dtype=np.int64)
                + np.repeat(starts - off, cnt)), cnt

    def _column_pattern(c: int):
        """Sorted (m_dst, dc, m_src, w) pattern of column c's incoming
        edges, gathered via CSR row slices; zero-weight halo twin edges
        appended last (the stream order of the old COO construction)."""
        nodes_c = np.sort(cmap.node_of[:, c])
        pos, cnt = _csr_positions(nodes_c)
        rr = np.repeat(nodes_c, cnt)
        ccol = indices[pos].astype(np.int64)
        if center >= 0:
            keep = ccol != center
            rr, ccol = rr[keep], ccol[keep]
        w = csr_edge_weights(gr, rr, ccol, U)
        dc = (cmap.c_of[ccol] - c) % nt
        dc = np.where(dc > half, dc - nt, dc)
        if halo.size:
            hsel = np.flatnonzero(cmap.c_of[h_dst] == c)
            rr = np.concatenate([rr, h_dst[hsel]])
            ccol = np.concatenate([ccol, h_src[hsel]])
            dc = np.concatenate([dc, h_dc[hsel]])
            w = np.concatenate([w, np.zeros(hsel.size)])
        m_dst = cmap.m_of[rr]
        m_src = cmap.m_of[ccol]
        order = np.lexsort((m_src, dc, m_dst))
        return m_dst[order], dc[order], m_src[order], w[order]

    sm_dst, sdc, sm_src, sw = _column_pattern(0)
    if verify:
        # full pattern comparison on sampled columns (the cheap global
        # count/reach checks above already ran on every column)
        for c in {1, nt // 3, nt // 2, nt - 1} - {0}:
            m2, d2, s2, w2 = _column_pattern(c)
            if not (np.array_equal(sm_dst, m2) and np.array_equal(sdc, d2) and np.array_equal(sm_src, s2)):
                raise CirculantError(f"stencil pattern of column {c} differs from column 0")
            if not np.allclose(sw, w2, rtol=rtol, atol=1e-9):
                bad = ~np.isclose(sw, w2, rtol=rtol, atol=1e-9)
                i = int(np.argmax(np.where(bad, np.abs(sw - w2), 0)))
                raise CirculantError(
                    f"stencil weights of column {c} differ from column 0: "
                    f"{int(bad.sum())} entries, worst at (m_dst={sm_dst[i]}, dc={sdc[i]}, "
                    f"m_src={sm_src[i]}): {sw[i]!r} vs {w2[i]!r}"
                )

    # ---- centre fan ----
    if center >= 0:
        pos_center = np.sort(np.concatenate(
            [center_src_pos, np.arange(c0, c1, dtype=np.int64)]))
        fr = np.searchsorted(indptr, pos_center, side="right") - 1
        fc = indices[pos_center].astype(np.int64)
    else:
        fr = fc = np.empty(0, np.int64)
    into_center = fr == center
    fan_other = np.where(into_center, fc, fr)
    fw = csr_edge_weights(gr, fr, fc, U)
    fan_m = cmap.m_of[fan_other]
    fan_c = cmap.c_of[fan_other]
    fan_sets = {}
    for direction, mask in (("in", into_center), ("out", ~into_center)):
        order = np.lexsort((fan_m[mask], fan_c[mask]))
        mm, cc2, ww2 = fan_m[mask][order], fan_c[mask][order], fw[mask][order]
        per_col_f = np.bincount(cc2, minlength=nt)
        if verify and not np.all(per_col_f == per_col_f[0]):
            raise CirculantError("centre fan differs across columns")
        F = per_col_f[0]
        if verify:
            if not np.all(mm.reshape(nt, F) == mm.reshape(nt, F)[0]):
                raise CirculantError("centre fan slots differ across columns")
            if not np.allclose(ww2.reshape(nt, F), ww2.reshape(nt, F)[0], rtol=rtol):
                raise CirculantError("centre fan weights differ across columns")
        fan_sets[direction] = (mm.reshape(nt, F)[0], ww2.reshape(nt, F)[0])
    if verify and not np.array_equal(fan_sets["in"][0], fan_sets["out"][0]):
        raise CirculantError("centre fan in/out slot mismatch")
    fan_slots, fan_w = fan_sets["in"]

    # ---- pack per-dst-slot ELL ----
    deg = np.bincount(sm_dst, minlength=M)
    K = int(deg.max())
    src_flat = np.zeros((M, K), dtype=np.int32)
    wmat = np.full((M, K), np.inf, dtype=np.float64)
    slot_fill = np.zeros(M, dtype=np.int64)
    # entries are sorted by m_dst already
    offs = np.concatenate([[0], np.cumsum(deg)[:-1]])
    k_idx = np.arange(len(sm_dst)) - offs[sm_dst]
    src_flat[sm_dst, k_idx] = (sdc + _DC_RANGE) * M + sm_src
    wmat[sm_dst, k_idx] = sw

    return CirculantGraph(
        src_flat=src_flat,
        w=wmat.astype(dtype),
        fan_slots=fan_slots.astype(np.int32),
        fan_w=fan_w.astype(dtype),
        cmap=cmap,
        n=gr.nnods,
    )


def resolve_device(device) -> torch.device:
    """torch.device of `device`; a CUDA device must exist (no silent
    fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path")
    return dev


# ----------------------------------------------------------------------
# plain Jacobi solve on the circulant layout
# ----------------------------------------------------------------------


class CircState(NamedTuple):
    dist: torch.Tensor     # (M, ntheta)
    dcen: torch.Tensor     # () centre distance
    changed: bool
    it: int


def _circ_step(state: CircState, src_flat, w, fan_slots, fan_w) -> CircState:
    """One Jacobi sweep: every node takes the min over its stencil taps
    of the previous field, and the centre exchanges with its fan."""
    dist, dcen = state.dist, state.dcen
    M, nt = dist.shape

    # stack of lane-rolled copies: R[(dc+2)*M + m, c] = dist[m, c + dc]
    R = torch.cat([torch.roll(dist, -d, dims=1)
                   for d in range(-_DC_RANGE, _DC_RANGE + 1)], dim=0)
    g = R[src_flat]                               # (M, K, nt) row gather
    cand = (g + w[:, :, None]).amin(dim=1)

    if fan_slots.shape[0] > 0:
        fan = dist[fan_slots] + fan_w[:, None]    # (F, nt)
        new_dcen = torch.minimum(dcen, fan.amin())
        # fan slots are distinct (one centre edge per node)
        cand[fan_slots] = torch.minimum(cand[fan_slots],
                                        dcen + fan_w[:, None])
    else:
        new_dcen = dcen

    new_dist = torch.minimum(dist, cand)
    changed = bool(((new_dist < dist).any() | (new_dcen < dcen)).item())
    return CircState(new_dist, new_dcen, changed, state.it + 1)


def solve_circulant(
    cg: CirculantGraph,
    source: int,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    device="cuda",
    _dcache: Optional[dict] = None,
) -> Tuple[np.ndarray, int]:
    """Distance field via the circulant relaxation on `device`; returns
    (dist, iters).

    Relaxes ALL nodes every sweep (no frontier bookkeeping) and stops at
    the first sweep that changes nothing, so the iteration count is the
    hop diameter plus one.  Plain tensor code: the oracle the kernel
    engines are held against.  Pass a dict as `_dcache` to upload the
    stencil once across repeated calls.
    """
    device = resolve_device(device)
    dtype = getattr(torch, np.dtype(config.dtype).name)
    cmap = cg.cmap
    if _dcache is None:
        _dcache = {}
    key = ("circ_tables", str(device), str(dtype))
    if key not in _dcache:
        _dcache[key] = (
            torch.tensor(cg.src_flat.astype(np.int64), device=device),
            torch.tensor(cg.w, dtype=dtype, device=device),
            torch.tensor(cg.fan_slots.astype(np.int64), device=device),
            torch.tensor(cg.fan_w, dtype=dtype, device=device),
        )
    src_flat, w, fan_slots, fan_w = _dcache[key]

    src_is_center = source == cmap.center
    dist = torch.full((cmap.M, cmap.ntheta), float("inf"), dtype=dtype,
                      device=device)
    dcen = torch.tensor(float("inf"), dtype=dtype, device=device)
    if src_is_center:
        dcen = torch.zeros((), dtype=dtype, device=device)
    else:
        dist[int(cmap.m_of[source]), int(cmap.c_of[source])] = 0.0

    st = CircState(dist, dcen, True, 0)
    while st.changed and st.it < config.max_iters:
        st = _circ_step(st, src_flat, w, fan_slots, fan_w)
    dist2d = st.dist.cpu().numpy()
    out = np.empty(cg.n, dtype=dist2d.dtype)
    valid = cmap.m_of >= 0
    out[valid] = dist2d[cmap.m_of[valid], cmap.c_of[valid]]
    if cmap.center >= 0:
        out[cmap.center] = float(st.dcen)
    return out, st.it


# ----------------------------------------------------------------------
# predecessor recovery on the device
# ----------------------------------------------------------------------


def _prev_argmin(dist_nodes: torch.Tensor, src_flat: torch.Tensor,
                 w: torch.Tensor, fan_slots: torch.Tensor,
                 fan_w: torch.Tensor, node_of: torch.Tensor,
                 center: int) -> torch.Tensor:
    """Shortest-path-tree recovery over the circulant stencil.

    prev[i] = argmin_j dist[j] + w(j->i) over i's stencil taps, with the
    JAX package's selection rule kept exactly: the lexicographic argmin
    of (quantised cost, -hop length, predecessor node id).  The cost is
    quantised to 0.1 ms RELATIVE to each destination's cheapest
    candidate (floor of the min), so the key stays exact in float32 at
    any travel time; all-inf destinations use offset 0.
    src_flat/fan_slots/node_of are int64 index tensors on dist's device.
    """
    M, nt = node_of.shape
    dtype = dist_nodes.dtype
    dev = dist_nodes.device
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    dist2d = dist_nodes[node_of]                          # (M, nt)

    R = torch.cat([torch.roll(dist2d, -d, dims=1)
                   for d in range(-_DC_RANGE, _DC_RANGE + 1)], dim=0)
    vals = R[src_flat] + w[:, :, None]                    # (M, K, nt)
    voff = torch.floor(vals.amin(dim=1))                  # (M, nt)
    voff = torch.where(torch.isfinite(voff), voff, zero)
    vq = torch.round((vals - voff[:, None, :]) * 1e4)     # 0.1 ms keys
    min_vq = vq.amin(dim=1)                               # (M, nt)
    tie1 = vq == min_vq[:, None, :]
    del vals, vq
    w_max = torch.where(tie1, w[:, :, None], -inf).amax(dim=1)
    m_srcs = src_flat % M                                 # (M, K)
    dcs = src_flat // M - _DC_RANGE
    c_idx = (torch.arange(nt, device=dev)[None, None, :]
             + dcs[:, :, None]) % nt                      # (M, K, nt)
    pid = node_of[m_srcs[:, :, None], c_idx].to(torch.int32)
    del c_idx
    big = torch.tensor(np.iinfo(np.int32).max, dtype=torch.int32, device=dev)
    psel = torch.where(tie1 & (w[:, :, None] == w_max[:, None, :]), pid, big)
    prev2d = psel.amin(dim=1)                             # (M, nt)
    del psel, pid, tie1

    has_fan = center >= 0 and fan_slots.shape[0] > 0
    if has_fan:
        dcen = dist_nodes[center]
        # same per-destination offsets as min_vq so the comparison keys
        # share a quantisation origin
        cen_vq = torch.round(((dcen + fan_w)[:, None] - voff[fan_slots]) * 1e4)
        mvf = min_vq[fan_slots]                           # (F, nt)
        wbf = w_max[fan_slots]
        fwc = fan_w[:, None]
        pf = prev2d[fan_slots]
        take_cen = ((cen_vq < mvf)
                    | ((cen_vq == mvf) & (fwc > wbf))
                    | ((cen_vq == mvf) & (fwc == wbf) & (center < pf)))
        prev2d[fan_slots] = torch.where(
            take_cen, torch.tensor(center, dtype=torch.int32, device=dev), pf)

    n = dist_nodes.shape[0]
    prev = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ok2d = node_of >= 0
    prev[torch.where(ok2d, node_of, 0).reshape(-1)] = torch.where(
        ok2d, prev2d, torch.tensor(-1, dtype=torch.int32, device=dev)).reshape(-1)

    if has_fan:
        fv = dist2d[fan_slots] + fan_w[:, None]           # (F, nt)
        # offset by the global min before quantising (ties are decided
        # at the min, where the shifted key is exact at any travel time)
        fvoff = torch.floor(fv.amin())
        fvoff = torch.where(torch.isfinite(fvoff), fvoff, zero)
        fvq = torch.round((fv - fvoff) * 1e4)
        fsel = torch.where(fvq == fvq.amin(), fan_w[:, None], -inf)
        flatb = torch.argmax(fsel.reshape(-1))            # first maximum
        fj, fc = flatb // nt, flatb % nt
        prev[center] = node_of[fan_slots[fj], fc].to(torch.int32)

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    return torch.where(torch.isfinite(dist_nodes) & (prev >= 0), prev, idx)


def recover_prev_device(cg: CirculantGraph, dist, device="cuda",
                        _dcache: Optional[dict] = None) -> np.ndarray:
    """Predecessor array from a converged node-ordered distance field,
    computed on `device` over the circulant stencil.  `dist` is a NumPy
    array or a tensor.  Pass a dict as `_dcache` to upload the stencil
    arrays once across repeated calls."""
    device = torch.device(device)
    cmap = cg.cmap
    if _dcache is None:
        _dcache = {}
    key = ("prev_tables", str(device))
    if key not in _dcache:
        _dcache[key] = (
            torch.tensor(cg.src_flat.astype(np.int64), device=device),
            torch.tensor(cg.w, device=device),
            torch.tensor(cg.fan_slots.astype(np.int64), device=device),
            torch.tensor(cg.fan_w, device=device),
            torch.tensor(cmap.node_of.astype(np.int64), device=device),
        )
    sf, w, fs, fw, node_of = _dcache[key]
    dist_t = torch.as_tensor(dist, device=device)
    prev = _prev_argmin(dist_t, sf, w, fs, fw, node_of, int(cmap.center))
    return prev.cpu().numpy().astype(np.int64)
