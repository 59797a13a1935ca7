"""Shortest travel times on the regular 3-D spherical-shell grid.

Counterpart of `raytracer_tpu/solvers/solve3d.py`.  The star-0 nodal
stencil of the structured hexahedral lattice is the fixed 26-point
neighbourhood (dk, dj, di) in {-1,0,1}^3 \\ {0}, so one relaxation sweep
is 26 statically shifted whole-array add+min operations over the dense
(nr, nphi, ntheta) field.  The per-shift edge weights 2L/(U1+U2) are
built on the host in float64 with +inf at the non-periodic box faces
(`_shifted_weights`, a copy of the JAX package's).

Two engines of the JAX package are ported:
- 'pallas', the kernel engine: `sweeps` Jacobi sweeps per call of the
  hand-written CUDA kernel `csrc/sweep3d.cu` (ops/sweep3d.py) on the
  card, or of its plain twin on the CPU, with `source_batch` sources
  sharing one pass of the weights per sweep.  The name is the JAX
  package's, kept for signature parity.
- 'xla', the plain torch sweep (`_sweep`, 26 `torch.roll`s), with the
  six exact min-plus axis scans (`_axis_scan`) every `scan_every`
  iterations.
Both stop once no distance improves by more than `SolverConfig.tol`, and
both reproduce the JAX package's floats and iteration counts.  The
directional-sweep engine 'sweep' and the staged solves are ROADMAP A.8b.

`recover_prev3d` recovers the predecessor tree from a converged field
(neighbour argmin, ties to the first shift), as plain torch on the
device.  Entry points run on the card unless the caller passes
`device="cpu"`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..models.grid3d import Grid3D
from ..ops.circulant import _safe_weight, resolve_device
from ..ops.diag_circulant import _sum_min_scan
from ..ops.sweep3d import Sweep3DPlan, plan_sweep3d, sweep3d_T_batched

# the kernel engine's fast-memory budget of the JAX package (see
# _kernel_vmem_bytes)
VMEM_BUDGET = 100 * 2**20

_NOT_PORTED = ("the 3-D directional-sweep engine 'sweep' (and with it "
               "every stencil wider than star 1 under engine='auto') is "
               "not ported yet: ROADMAP A.8b")


def shifts_star(star: int = 1):
    """The star-`star` lattice stencil: every (dk, dj, di) in
    {-star..star}^3 with gcd 1 (collinear multiples of a shorter shift
    add no new direction).  star=1 is the 26-tap stencil, star=2 has 98
    taps, star=3 290."""
    out = []
    rng = range(-star, star + 1)
    for dk in rng:
        for dj in rng:
            for di in rng:
                if (dk, dj, di) == (0, 0, 0):
                    continue
                if math.gcd(math.gcd(abs(dk), abs(dj)), abs(di)) != 1:
                    continue
                out.append((dk, dj, di))
    return tuple(out)


SHIFTS = shifts_star(1)


def _shifted_weights(gr: Grid3D, U: np.ndarray, dtype=np.float32,
                     shifts=SHIFTS) -> np.ndarray:
    """(n_shifts, n2, n1, n0) per-shift edge weights, +inf across box
    faces, computed in float64 and cast once at the end.

    W[s, k, j, i] = weight of the edge from node (i+di, j+dj, k+dk) into
    node (i, j, k) for shift s = (dk, dj, di).
    """
    n0, n1, n2 = gr.nnods
    shp = (n2, n1, n0)
    X = gr.x.reshape(shp)
    Y = gr.y.reshape(shp)
    Z = gr.z.reshape(shp)
    Ug = np.asarray(U, dtype=np.float64).reshape(shp)

    W = np.full((len(shifts),) + shp, np.inf, dtype=np.float64)
    for s, (dk, dj, di) in enumerate(shifts):
        src = tuple(np.roll(a, (-dk, -dj, -di), axis=(0, 1, 2)) for a in (X, Y, Z, Ug))
        L = np.sqrt((src[0] - X) ** 2 + (src[1] - Y) ** 2 + (src[2] - Z) ** 2)
        w = _safe_weight(L, Ug + src[3])
        # mask wrapped entries (non-periodic box): a shift of +-d along
        # an axis wraps the last/first d planes
        if dk > 0:
            w[n2 - dk:, :, :] = np.inf
        elif dk < 0:
            w[:-dk, :, :] = np.inf
        if dj > 0:
            w[:, n1 - dj:, :] = np.inf
        elif dj < 0:
            w[:, :-dj, :] = np.inf
        if di > 0:
            w[:, :, n0 - di:] = np.inf
        elif di < 0:
            w[:, :, :-di] = np.inf
        W[s] = w
    return W.astype(dtype)


def _scan_costs_of(Wm, shifts=SHIFTS):
    """The axis scans' ((fwd, bwd) per axis) costs: axis 0 = k (r), 1 = j
    (phi), 2 = i (theta); the forward cost entering t from t-1 is the
    weight of shift -1 along that axis."""
    def shift_w(dk, dj, di):
        return Wm[shifts.index((dk, dj, di))]

    return tuple(
        (shift_w(*a), shift_w(*b))
        for a, b in (((-1, 0, 0), (1, 0, 0)), ((0, -1, 0), (0, 1, 0)),
                     ((0, 0, -1), (0, 0, 1))))


def _sweep(dist: torch.Tensor, W: torch.Tensor,
           shifts=SHIFTS) -> torch.Tensor:
    """One Jacobi sweep of the (n2, n1, n0) field."""
    out = dist
    for s, (dk, dj, di) in enumerate(shifts):
        src = torch.roll(dist, shifts=(-dk, -dj, -di), dims=(0, 1, 2))
        out = torch.minimum(out, src + W[s])
    return out


def _axis_scan(dist: torch.Tensor, cost_fwd: torch.Tensor,
               cost_bwd: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact min-plus chain relaxation along `axis`, both directions.

    cost_fwd[..., t, ...] = weight entering position t from t-1 (+inf at
    t=0); cost_bwd = entering t from t+1 (flipped for the reverse scan).
    The scan is `jax.lax.associative_scan`'s recursion over (sum, min)
    pairs (`_sum_min_scan`), so the sums round as the JAX package's.
    """
    out = dist
    for cost, flip in ((cost_fwd, False), (cost_bwd, True)):
        x = torch.flip(dist, dims=[axis]) if flip else dist
        c = torch.flip(cost, dims=[axis]) if flip else cost
        _, scanned = _sum_min_scan(torch.movedim(c, axis, 0),
                                   torch.movedim(x, axis, 0))
        scanned = torch.movedim(scanned, 0, axis)
        if flip:
            scanned = torch.flip(scanned, dims=[axis])
        out = torch.minimum(out, scanned)
    return out


def _scans(d: torch.Tensor, scan_costs) -> torch.Tensor:
    """The six axis scans of one (n2, n1, n0) field."""
    for axis, (cf, cb) in enumerate(scan_costs):
        d = _axis_scan(d, cf, cb, axis)
    return d


class Solve3DState(NamedTuple):
    dist: torch.Tensor
    changed: bool
    it: int


def _solve3d_xla(src: int, W: torch.Tensor, scan_costs, tol: torch.Tensor,
                 max_iters: int, scan_every: int,
                 shifts=SHIFTS) -> Solve3DState:
    """The xla engine for one source: (scans every `scan_every`
    iterations) + one `_sweep` per iteration, one host read of the
    changed flag per iteration."""
    shp = tuple(W.shape[1:])
    dist = torch.full((math.prod(shp),), float("inf"), dtype=W.dtype,
                      device=W.device)
    dist[src] = 0.0
    s = Solve3DState(dist.reshape(shp), True, 0)
    while s.changed and s.it < max_iters:
        d = s.dist
        if scan_every == 1 or (scan_every > 1 and s.it % scan_every == 0):
            d = _scans(d, scan_costs)
        d = _sweep(d, W, shifts)
        changed = bool((d < s.dist - tol).any())
        s = Solve3DState(d, changed, s.it + 1)
    return s


def _solve3d_kernel(srcs: Sequence[int], W4: torch.Tensor, scan_costs,
                    tol: torch.Tensor, statics, max_iters: int,
                    scan_every: int, sweeps: int) -> Solve3DState:
    """The kernel engine for a group of S sources (the JAX package's
    `_solve3d_kernel_jit` at S = 1 and `_solve3d_kernel_batched_jit`
    above it): one `sweep3d_T_batched` call of `sweeps` sweeps per step,
    so `it` advances by `sweeps`; the scans (when enabled) run between
    calls, at the first call boundary at or after each multiple of
    `scan_every`.  The group runs until its last source converges (the
    fixpoint of each source is unchanged).  One host read per call."""
    n1, BR, NB, L0, H8, shape = statics
    n2, _, n0 = shape
    rows = n2 * n1
    S = len(srcs)
    flat = torch.full((S, NB * BR, L0), float("inf"), dtype=W4.dtype,
                      device=W4.device)
    for q, src in enumerate(srcs):
        # flat id layout: theta fastest (models/grid3d.py)
        flat[q, int(src) // n0, int(src) % n0] = 0.0

    def scans(f):
        d = f[:, :rows, :n0].reshape((S,) + shape)
        d = torch.stack([_scans(d[q], scan_costs) for q in range(S)])
        f = f.clone()
        f[:, :rows, :n0] = d.reshape(S, rows, n0)
        return f

    s = Solve3DState(flat, True, 0)
    while s.changed and s.it < max_iters:
        f = s.dist
        if scan_every > 0 and s.it % max(scan_every, sweeps) < sweeps:
            f = scans(f)
        f = sweep3d_T_batched(f, W4, n1, BR, NB, L0, H8, sweeps)
        changed = bool((f < s.dist - tol).any())
        s = Solve3DState(f, changed, s.it + sweeps)
    return Solve3DState(s.dist[:, :rows, :n0].reshape((S,) + shape),
                        s.changed, s.it)


def _gather3d_it(dist: torch.Tensor, it: int, idx: torch.Tensor) -> np.ndarray:
    """(S, n_receivers + 1): receiver values per source with the
    iteration count appended to every row, read to the host at once."""
    S = dist.shape[0]
    vals = dist.reshape(S, -1)[:, idx]
    itcol = torch.full((S, 1), it, dtype=vals.dtype, device=vals.device)
    return torch.cat([vals, itcol], dim=1).cpu().numpy()


def _flat3d_it(dist: torch.Tensor, it: int) -> np.ndarray:
    """(S, nnods + 1): whole fields with the iteration count appended."""
    S = dist.shape[0]
    flat = dist.reshape(S, -1)
    itcol = torch.full((S, 1), it, dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, itcol], dim=1).cpu().numpy()


class Packed3D(NamedTuple):
    W_np: np.ndarray    # host (n_shifts, n2, n1, n0)
    scan_costs: tuple   # host ((fwd, bwd) per axis), views of W_np
    shape: Tuple[int, int, int]
    plan: Optional[Sweep3DPlan]   # the kernel's layout (star 1 only)
    dcache: dict        # lazy device uploads, keyed (layout, device):
                        # 'W' (xla, prev), 'W4' (kernel), 'scan'
    shifts: tuple = SHIFTS


def _packed3d(W: np.ndarray, shape, shifts, block_rows: int = 1024) -> Packed3D:
    plan = plan_sweep3d(W, block_rows) if tuple(shifts) == SHIFTS else None
    return Packed3D(W_np=W, scan_costs=_scan_costs_of(W, shifts),
                    shape=tuple(shape), plan=plan, dcache={},
                    shifts=tuple(shifts))


def prepare3d(gr: Grid3D, U: np.ndarray,
              config: SolverConfig = DEFAULT_SOLVER_CONFIG,
              star: int = 1, device="cuda") -> Packed3D:
    """Host arrays for repeated solve3d calls: the shifted weights, the
    scan costs and (star 1) the kernel's weight layout.  star >= 2 widens
    the stencil (shifts_star); the kernel is star-1 only.  Nothing is
    uploaded here: each solve uploads its engine's layout once per
    device.  `device` is checked here, so that a missing card fails
    before the host build (seconds at 1M nodes)."""
    resolve_device(device)
    shifts = shifts_star(star)
    W = _shifted_weights(gr, U, np.dtype(config.dtype), shifts)
    n0, n1, n2 = gr.nnods
    return _packed3d(W, (n2, n1, n0), shifts)


def _kernel_vmem_bytes(plan, itemsize: int, S: int = 1) -> int:
    """The JAX package's VMEM footprint estimate of its TPU kernel:
    ping-pong scratch (per source) + double-buffered W slab + in/out
    blocks + the 27 slab/tap temporaries per block.  It is a TPU figure,
    kept (with its 100 MiB budget) so that a grid takes the same engine
    and the same source batch in both packages; the CUDA kernel keeps no
    field on chip."""
    G = plan.H8 + plan.NB * plan.BR + plan.H8
    blk = plan.BR * plan.L0
    return itemsize * (S * 2 * G * plan.L0    # ping-pong pages
                       + 2 * 26 * blk         # W4 block, double-buffered
                       + 4 * blk              # din/out blocks, buffered
                       + 27 * blk)            # slab + tap temps


def _auto_source_batch(plan, itemsize: int, nsources: int) -> int:
    """Largest source-group size (<= 8) whose `_kernel_vmem_bytes` fits
    the JAX package's 100 MiB budget (a TPU figure, kept for routing
    parity)."""
    S = min(8, max(1, nsources))
    while S > 1 and _kernel_vmem_bytes(plan, itemsize, S) >= VMEM_BUDGET:
        S -= 1
    return S


def select_engine3d(packed: Packed3D, engine: str, dtype) -> str:
    """The engine `solve3d` runs: 'auto' takes the JAX package's
    accelerator route on every device - the kernel engine 'pallas' for
    the star-1 stencil when `_kernel_vmem_bytes` fits the budget, else
    'xla' for 26 taps, else 'sweep'."""
    if engine == "auto":
        fits = (packed.plan is not None
                and _kernel_vmem_bytes(packed.plan, np.dtype(dtype).itemsize)
                < VMEM_BUDGET)
        engine = "pallas" if fits else (
            "xla" if len(packed.shifts) == 26 else "sweep")
    if engine not in ("pallas", "xla", "sweep"):
        raise ValueError(f"unknown engine {engine!r}: 'auto', 'pallas', "
                         "'xla' or 'sweep'")
    return engine


def _device_key(device: torch.device) -> str:
    """One spelling per card: 'cuda' resolves to 'cuda:<current>'."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _device_layout(packed: Packed3D, name: str, device: torch.device):
    """`name` ('W', 'W4' or 'scan') of `packed` on `device`, uploaded on
    first use and kept in `packed.dcache` (keyed by `_device_key`, so
    'cuda' and 'cuda:0' share one upload)."""
    # NOTE: not dcache.setdefault(key, upload(...)) - setdefault evaluates
    # its default EAGERLY, which would upload the ~109 MB weights on every
    # call and discard them; in the JAX package that exact bug cost 6x on
    # 3-D solves.
    key = (name, _device_key(device))
    if key not in packed.dcache:
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        if name == "W4":
            packed.dcache[key] = up(packed.plan.W4)
        elif name == "W":
            packed.dcache[key] = up(packed.W_np)
        else:
            packed.dcache[key] = tuple((up(cf), up(cb))
                                       for cf, cb in packed.scan_costs)
    return packed.dcache[key]


def solve3d(
    gr: Grid3D,
    U: np.ndarray,
    sources: Sequence[int],
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    scan_every: int = None,
    receivers=None,
    engine: str = "auto",
    sweeps: int = 8,
    source_batch: int = 0,
    interpret: bool = False,
    _packed: Packed3D = None,
    star: int = 1,
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """(S, nnods) travel-time fields on the structured 3-D grid, or with
    `receivers` (node ids) (S, n_receivers) gathered on the device; and
    the iteration count (the most over the sources or groups).

    engine: 'pallas' = the kernel engine (`csrc/sweep3d.cu` on the card,
    its plain twin on the CPU; `sweeps` sweeps per call); 'xla' = the
    plain torch roll sweep; 'auto' = `select_engine3d`, the JAX package's
    accelerator route on every device.  'sweep' raises (ROADMAP A.8b).
    scan_every: axis-scan cadence in iterations (0 = never; None = 0 on
    the kernel engine, 8 on xla).
    source_batch: sources per kernel call (0 = `_auto_source_batch`);
    a group runs until its last source converges, its tail padded with
    its last source.
    interpret: accepted for parity with the JAX package; on a CUDA device
    `interpret=True` raises (it never selects the plain twin).
    """
    dev = torch.device(device)
    if interpret and dev.type == "cuda":
        raise ValueError("interpret=True runs the JAX package's Pallas "
                         "interpreter; the port has none on a CUDA device")
    dev = resolve_device(dev)
    packed = _packed if _packed is not None else prepare3d(
        gr, U, config, star=star, device=dev)
    dtype = np.dtype(config.dtype)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    engine = select_engine3d(packed, engine, dtype)
    if engine == "sweep":
        raise NotImplementedError(_NOT_PORTED)
    if engine == "pallas" and packed.plan is None:
        raise ValueError("engine='pallas' supports the star-1 stencil "
                         "only; use engine='xla' for star>=2")
    if scan_every is None:
        scan_every = 0 if engine == "pallas" else 8
    Wdev = _device_layout(packed, "W4" if engine == "pallas" else "W", dev)
    tol = torch.tensor(config.tol_value(), dtype=Wdev.dtype, device=dev)
    ridx = (None if receivers is None else torch.as_tensor(
        np.asarray(receivers, dtype=np.int64).ravel(), device=dev))
    scan_costs = (_device_layout(packed, "scan", dev) if scan_every > 0
                  else None)

    ncol = gr.nnods_total if ridx is None else len(ridx)
    out = np.empty((len(sources), ncol), dtype=dtype)
    iters = 0
    if engine == "pallas":
        plan = packed.plan
        statics = (plan.n1, plan.BR, plan.NB, plan.L0, plan.H8, packed.shape)
        S = (source_batch if source_batch > 0
             else _auto_source_batch(plan, dtype.itemsize, len(sources)))
        for lo in range(0, len(sources), S):
            grp = sources[lo:lo + S]
            # pad the tail group with its last source
            g_src = np.concatenate([grp, np.full(S - len(grp), grp[-1])])
            st = _solve3d_kernel(g_src.tolist(), Wdev, scan_costs, tol,
                                 statics, config.max_iters, scan_every,
                                 sweeps)
            arr = (_flat3d_it(st.dist, st.it) if ridx is None
                   else _gather3d_it(st.dist, st.it, ridx))
            out[lo:lo + len(grp)] = arr[:len(grp), :-1]
            iters = max(iters, int(arr[0, -1]))
        return out, iters
    for si, src in enumerate(sources):
        st = _solve3d_xla(int(src), Wdev, scan_costs, tol, config.max_iters,
                          scan_every, packed.shifts)
        d = st.dist[None]
        arr = (_flat3d_it(d, st.it) if ridx is None
               else _gather3d_it(d, st.it, ridx))
        out[si] = arr[0, :-1]
        iters = max(iters, int(arr[0, -1]))
    return out, iters


def _neighbour_argmin(dist3: torch.Tensor, W: torch.Tensor, shifts):
    """(best, prev, ids): per node the neighbour attaining
    min_s dist[nbr_s] + W[s] (the fixpoint condition; ties by first
    shift)."""
    shape = tuple(dist3.shape)
    ids = torch.arange(dist3.numel(), dtype=torch.int32,
                       device=dist3.device).reshape(shape)
    best = torch.full(shape, float("inf"), dtype=torch.promote_types(
        dist3.dtype, W.dtype), device=dist3.device)
    prev = ids
    for s, (dk, dj, di) in enumerate(shifts):
        cand = torch.roll(dist3, (-dk, -dj, -di), dims=(0, 1, 2)) + W[s]
        nid = torch.roll(ids, (-dk, -dj, -di), dims=(0, 1, 2))
        take = cand < best
        best = torch.where(take, cand, best)
        prev = torch.where(take, nid, prev)
    return best, prev, ids


def _prev3d(dist3: torch.Tensor, W: torch.Tensor, src: int,
            shifts=SHIFTS) -> torch.Tensor:
    """Predecessor tree from a converged field (neighbour argmin).
    Source and unreachable nodes point to themselves."""
    best, prev, ids = _neighbour_argmin(dist3, W, shifts)
    prev = torch.where(torch.isfinite(best), prev, ids).reshape(-1)
    prev[src] = src
    return prev


def recover_prev3d(gr: Grid3D, U: np.ndarray, dist, sources,
                   config: SolverConfig = DEFAULT_SOLVER_CONFIG,
                   _packed: Packed3D = None, star: int = 1,
                   device="cuda") -> np.ndarray:
    """(S, nnods) int32 predecessor trees for converged solve3d fields,
    one device pass per source (26 static rolls + argmin).  Feed rows to
    `recontruct_path`.  Every chosen edge has w > 0, so backtraces
    strictly descend and end at the source."""
    dev = resolve_device(device)
    packed = _packed if _packed is not None else prepare3d(
        gr, U, config, star=star, device=dev)
    W = _device_layout(packed, "W", dev)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int32))
    d = np.asarray(dist)
    if d.ndim == 1 or d.ndim == 3:
        d = d.reshape((1,) + packed.shape)
    else:
        d = d.reshape((len(sources),) + packed.shape)
    out = [_prev3d(torch.as_tensor(d[i], device=dev), W, int(sources[i]),
                   packed.shifts)
           for i in range(len(sources))]
    return np.stack([p.cpu().numpy() for p in out])
