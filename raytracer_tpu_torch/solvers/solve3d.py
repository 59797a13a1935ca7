"""Shortest travel times on the regular 3-D spherical-shell grid.

Counterpart of `raytracer_tpu/solvers/solve3d.py`.  The star-0 nodal
stencil of the structured hexahedral lattice is the fixed 26-point
neighbourhood (dk, dj, di) in {-1,0,1}^3 \\ {0}, so one relaxation sweep
is 26 statically shifted whole-array add+min operations over the dense
(nr, nphi, ntheta) field.  The per-shift edge weights 2L/(U1+U2) are
built on the host in float64 with +inf at the non-periodic box faces
(`_shifted_weights`, a copy of the JAX package's).

The three engines of the JAX package:
- 'pallas', the kernel engine: `sweeps` Jacobi sweeps per call of the
  hand-written CUDA kernel `csrc/sweep3d.cu` (ops/sweep3d.py) on the
  card, or of its plain twin on the CPU, with `source_batch` sources
  sharing one pass of the weights per sweep.  The name is the JAX
  package's, kept for signature parity.
- 'xla', the plain torch sweep (`_sweep`, 26 `torch.roll`s), with the
  six exact min-plus axis scans (`_axis_scan`) every `scan_every`
  iterations.
- 'sweep', the directional-sweep engine: a round is a down and an up
  plane pass along each axis (`_plane_sweep3d`, one launch of the
  hand-written CUDA kernel `csrc/plane3d.cu` a pass on the card, its
  plain twin on the CPU; ops/plane3d.py); `iters` counts rounds.  Any
  stencil (`shifts_star`); 'auto' takes it for star >= 2.
All stop once no distance improves by more than `SolverConfig.tol`, and
all reproduce the JAX package's floats and iteration counts.

The staged solves run on the sweep engine: `solve3d_reflection` (PcP,
two stages on `mask_region3d`'s masked weights) and `solve3d_converted`
(SKS/PKP, three stages seeded on the twin planes of a forced radius);
`composite_velocity3d` builds the composite model of a converted class.
`refine3d_travel_times` and `converted3d_refined` bend the recovered
paths of a solve and of the staged SKS solve (solvers/refine.py, the
`bend` kernel on the card).
`recover_prev3d` recovers the predecessor tree from a converged field
(neighbour argmin, ties to the first shift), `_prev3d_seeded` that of a
stage field, as plain torch on the device.  Entry points run on the card
unless the caller passes `device="cpu"`.  The JAX package's jitted
functions keep their names without `_jit` (`_solve3d_sweep` for
`_solve3d_sweep_jit`, `_prev3d_seeded` for `_prev3d_seeded_jit`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..models.grid3d import Grid3D
from ..ops.circulant import _safe_weight, resolve_device
from ..ops.plane3d import PlaneLayout3D, _axis_scan, scan_sum_trees
from ..ops.plane3d import plane_sweep3d as _plane_sweep3d
from ..ops.sweep3d import (Sweep3DPlan, mirror_weights, plan_sweep3d,
                           sweep3d_T_batched)

# the kernel engine's fast-memory budget of the JAX package (see
# _kernel_vmem_bytes)
VMEM_BUDGET = 100 * 2**20

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


def _sweep_layout3d(W: torch.Tensor, scan_costs, axis: int) -> PlaneLayout3D:
    """Per-axis plane layout for `_plane_sweep3d`, built once for a set of
    weights: W as (nA, n_shifts, p0, p1) planes plus the four in-plane
    scan-cost plane stacks (nA, p0, p1), and on a CUDA device the
    kernel's sum trees (`scan_sum_trees`).  Each layout is a transposed
    copy of W: 3 x W for the three axes, 3 x 109 MB at star 1 and
    3 x 411 MB at star 2 on a 128x128x64 float32 grid (the trees add
    about 2 x 4 cost stacks an axis, ~100 MB at that grid)."""
    oaxes = [a for a in (0, 1, 2) if a != axis]
    xs_W = torch.movedim(W, 1 + axis, 0).contiguous()
    xs_c = []
    for a in oaxes:
        cf, cb = scan_costs[a]
        xs_c += [torch.movedim(cf, axis, 0).contiguous(),
                 torch.movedim(cb, axis, 0).contiguous()]
    trees = scan_sum_trees(*xs_c) if W.device.type == "cuda" else None
    return PlaneLayout3D(xs_W, *xs_c, trees=trees)


def _sweep_fix(dist0: torch.Tensor, W: torch.Tensor, scan_costs,
               tol: torch.Tensor, max_iters: int, axes=(0, 1, 2),
               shifts=SHIFTS, layouts=None) -> Solve3DState:
    """Directional-sweep rounds from the (S,) + shape field `dist0`: a
    round is a down and an up pass along each of `axes` over the whole
    batch, then the changed test any(d < dist - tol), one host read a
    round; `it` counts rounds.  `layouts` (axis -> `_sweep_layout3d`) are
    built here unless given."""
    if layouts is None:
        layouts = {a: _sweep_layout3d(W, scan_costs, a) for a in axes}
    s = Solve3DState(dist0, True, 0)
    while s.changed and s.it < max_iters:
        d = s.dist
        for a in axes:
            d = _plane_sweep3d(d, layouts[a], a, True, shifts=shifts)
            d = _plane_sweep3d(d, layouts[a], a, False, shifts=shifts)
        changed = bool((d < s.dist - tol).any())
        s = Solve3DState(d, changed, s.it + 1)
    return s


def _solve3d_sweep(srcs, W: torch.Tensor, scan_costs, tol: torch.Tensor,
                   max_iters: int, axes=(0, 1, 2), shifts=SHIFTS,
                   layouts=None) -> Solve3DState:
    """Directional-sweep solve of the flat source ids `srcs` together
    (the batch runs through the kernel's source dimension; the JAX
    package vmaps the round).  Converges in a few rounds where the
    Jacobi engines take O(n0 + n1 + n2) iterations."""
    shp = tuple(W.shape[1:])
    srcs = torch.as_tensor(np.asarray(srcs, dtype=np.int64).ravel(),
                           device=W.device)
    S = len(srcs)
    dist0 = torch.full((S, math.prod(shp)), float("inf"), dtype=W.dtype,
                       device=W.device)
    dist0[torch.arange(S, device=W.device), srcs] = 0.0
    return _sweep_fix(dist0.reshape((S,) + shp), W, scan_costs, tol,
                      max_iters, axes, shifts, layouts)


# the JAX package's name for a solve from an arbitrary (S,) + shape
# initial field (multi-seed restarts: the staged solves' later stages)
_solve3d_sweep_init = _sweep_fix


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
    """`name` ('W', 'W4', 'scan' or 'sweep') of `packed` on `device`,
    uploaded on first use and kept in `packed.dcache` (keyed by
    `_device_key`, so 'cuda' and 'cuda:0' share one upload).  'sweep' is
    the sweep engine's per-axis plane layouts (axis -> `_sweep_layout3d`),
    built from 'W' and 'scan' on the device.  On a CUDA device the upload of
    'W4' also derives the kernel's 13-tap mirrored weights and checks
    them against W4 bit for bit (`ops.sweep3d.mirror_weights`, which
    keeps them on the tensor and raises if the weights are not
    symmetric)."""
    # NOTE: not dcache.setdefault(key, upload(...)) - setdefault evaluates
    # its default EAGERLY, which would upload the ~109 MB weights on every
    # call and discard them; in the JAX package that exact bug cost 6x on
    # 3-D solves.
    key = (name, _device_key(device))
    if key not in packed.dcache:
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        if name == "W4":
            W4 = up(packed.plan.W4)
            if W4.device.type == "cuda":
                mirror_weights(W4, packed.plan.n1)
            packed.dcache[key] = W4
        elif name == "W":
            packed.dcache[key] = up(packed.W_np)
        elif name == "sweep":
            W = _device_layout(packed, "W", device)
            scan = _device_layout(packed, "scan", device)
            packed.dcache[key] = {a: _sweep_layout3d(W, scan, a)
                                  for a in (0, 1, 2)}
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
    plain torch roll sweep; 'sweep' = directional plane passes
    (`csrc/plane3d.cu` on the card, 6 launches a round; `iters` then
    counts rounds); 'auto' = `select_engine3d`, the JAX package's
    accelerator route on every device.
    scan_every: axis-scan cadence in iterations (0 = never; None = 0 on
    the kernel engine, 8 on xla; the sweep engine scans every plane).
    source_batch: sources per kernel call (0 = `_auto_source_batch`) on
    'pallas'; sources a group on 'sweep' (max(1, min(source_batch,
    len(sources)))); a group runs until its last source converges, its
    tail padded with its last source.
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
    if engine == "sweep":
        layouts = _device_layout(packed, "sweep", dev)
        scan = _device_layout(packed, "scan", dev)
        S = max(1, min(source_batch, len(sources)))
        for lo in range(0, len(sources), S):
            grp = sources[lo:lo + S]
            g_src = np.concatenate([grp, np.full(S - len(grp), grp[-1])])
            st = _solve3d_sweep(g_src, Wdev, scan, tol, config.max_iters,
                                (0, 1, 2), packed.shifts, layouts)
            arr = (_flat3d_it(st.dist, st.it) if ridx is None
                   else _gather3d_it(st.dist, st.it, ridx))
            out[lo:lo + len(grp)] = arr[:len(grp), :-1]
            iters = max(iters, int(arr[0, -1]))
        return out, iters
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


def _prev3d_seeded(dist3: torch.Tensor, W: torch.Tensor,
                   shifts=SHIFTS) -> torch.Tensor:
    """Stage-field predecessor tree: like `_prev3d`, but a node whose
    best neighbour candidate cannot explain its own time (its value came
    from seeding - a stage handoff plane, not relaxation) points to
    itself, so backtraces stop at the stage boundary."""
    best, prev, ids = _neighbour_argmin(dist3, W, shifts)
    eps = torch.tensor(1e-3, dtype=dist3.dtype, device=dist3.device)
    explained = torch.isfinite(best) & (best <= dist3 * (1 + 1e-5) + eps)
    return torch.where(explained, prev, ids).reshape(-1)


def mask_region3d(W: np.ndarray, keep: np.ndarray,
                  shifts=SHIFTS) -> np.ndarray:
    """Copy of the (n_shifts, n2, n1, n0) shifted weights with every edge
    touching a node OUTSIDE `keep` (dense (n2, n1, n0) bool) removed: the
    dense-lattice form of the 2-D phase machinery's stage masks (host
    NumPy, a copy of the JAX package's)."""
    Wm = np.array(W, copy=True)
    for s, (dk, dj, di) in enumerate(shifts):
        src_keep = np.roll(keep, (-dk, -dj, -di), axis=(0, 1, 2))
        Wm[s][~keep] = np.inf
        Wm[s][~src_keep] = np.inf
    return Wm


def _staged_weights(gr: Grid3D, U, keep, dtype, shifts, dev):
    """(W, scan costs, sweep layouts) of `U` masked to `keep`, on `dev`."""
    W = torch.from_numpy(mask_region3d(
        _shifted_weights(gr, U, dtype, shifts), keep, shifts)).to(dev)
    scan = _scan_costs_of(W, shifts)
    return W, scan, {a: _sweep_layout3d(W, scan, a) for a in (0, 1, 2)}


def _staged_out(dist: torch.Tensor, receivers) -> np.ndarray:
    S = dist.shape[0]
    out = dist.reshape(S, -1)
    if receivers is not None:
        out = out[:, torch.as_tensor(np.asarray(receivers, dtype=np.int64)
                                     .ravel(), device=dist.device)]
    return out.cpu().numpy()


def solve3d_reflection(
    gr: Grid3D,
    U: np.ndarray,
    sources: Sequence[int],
    r_reflect: float,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    receivers=None,
    star: int = 1,
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """Two-stage topside reflection on the 3-D grid (PcP for the CMB):
    stage A solves the region ABOVE the reflector from the sources;
    stage B restarts from the reflector-level field (every reflector
    node a seed at its stage-A time) and solves the same masked region:
    T_PcP(x) = min_b [T_A(b) + T_B(b -> x)] over reflector nodes b.

    Physically meaningful when `gr` was built with force_radii including
    `r_reflect` (a sharp interface and side-aware velocities via
    `velocity3d`).  Both stages run on the sweep engine with all sources
    in one batch.  Returns ((S, n) times - or (S, n_receivers) - and the
    rounds of both stages summed)."""
    dev = resolve_device(device)
    dtype = np.dtype(config.dtype)
    shifts = shifts_star(star)
    shp3 = (gr.nnods[2], gr.nnods[1], gr.nnods[0])
    keep = (gr.r >= r_reflect - 1e-6).reshape(shp3)
    Wm, scan, layouts = _staged_weights(gr, U, keep, dtype, shifts, dev)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    tol = torch.tensor(config.tol_value(), dtype=Wm.dtype, device=dev)
    stA = _solve3d_sweep(sources, Wm, scan, tol, config.max_iters,
                         (0, 1, 2), shifts, layouts)
    lev = torch.as_tensor((np.abs(gr.r - r_reflect) < 1e-6).reshape(shp3),
                          device=dev)
    d0B = torch.where(lev[None], stA.dist,
                      torch.tensor(float("inf"), dtype=Wm.dtype, device=dev))
    stB = _solve3d_sweep_init(d0B, Wm, scan, tol, config.max_iters,
                              (0, 1, 2), shifts, layouts)
    return _staged_out(stB.dist, receivers), stA.it + stB.it


def solve3d_converted(
    gr: Grid3D,
    U_down: np.ndarray,
    U_core: np.ndarray,
    sources: Sequence[int],
    r_boundary: float,
    U_up: Optional[np.ndarray] = None,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    receivers=None,
    star: int = 1,
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """Three-stage boundary-converted core transit on the 3-D grid (SKS
    class with U_down = U_up = the Vs node field, U_core = Vp; PKP class
    all-Vp).

    `gr` must be twin-doubled at `r_boundary` (`grid3d(force_radii=
    [...])`): the boundary is the topside level at exactly r_boundary
    plus the underside twin one radial level below it.  Stage A solves
    the topside region (levels >= r_boundary) with U_down; the core
    stage seeds the UNDERSIDE twin plane from stage A's topside-plane
    times (the twin-gap traversal ~twin_offset/v is forgiven, as the 2-D
    zero-cost merge forgives it) and solves the region below with
    U_core; stage B seeds the topside plane from the core field's
    underside plane and re-solves the topside region with U_up (default
    U_down, whose weights it reuses).  Nodes outside the topside region
    return +inf in the final field.  Returns the times and the rounds of
    the three stages summed."""
    dtype = np.dtype(config.dtype)
    shifts = shifts_star(star)
    shp3 = (gr.nnods[2], gr.nnods[1], gr.nnods[0])
    r_ax = np.asarray(gr.r_ax)
    k_top = int(np.argmin(np.abs(r_ax - r_boundary)))
    if (abs(r_ax[k_top] - r_boundary) > 1e-6 or k_top == 0
            or abs(r_ax[k_top - 1]
                   - (r_boundary - gr.twin_offset)) > 1e-6):
        raise ValueError(
            "r_boundary must be a twin-doubled forced radius of the "
            "grid (build with grid3d(force_radii=[r_boundary, ...]))")
    dev = resolve_device(device)
    k_under = k_top - 1
    same_up = U_up is None or U_up is U_down

    keep_top = (gr.r >= r_boundary - 1e-6).reshape(shp3)
    keep_core = (gr.r <= r_boundary - 1e-6).reshape(shp3)
    dn = _staged_weights(gr, U_down, keep_top, dtype, shifts, dev)
    core = _staged_weights(gr, U_core, keep_core, dtype, shifts, dev)
    up = dn if same_up else _staged_weights(gr, U_up, keep_top, dtype,
                                            shifts, dev)

    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    tol = torch.tensor(config.tol_value(), dtype=dn[0].dtype, device=dev)
    stA = _solve3d_sweep(sources, *dn[:2], tol, config.max_iters,
                         (0, 1, 2), shifts, dn[2])
    d0K = torch.full_like(stA.dist, float("inf"))
    d0K[:, k_under] = stA.dist[:, k_top]
    stK = _solve3d_sweep_init(d0K, *core[:2], tol, config.max_iters,
                              (0, 1, 2), shifts, core[2])
    d0B = torch.full_like(stK.dist, float("inf"))
    d0B[:, k_top] = torch.minimum(stK.dist[:, k_under], stA.dist[:, k_top])
    stB = _solve3d_sweep_init(d0B, *up[:2], tol, config.max_iters,
                              (0, 1, 2), shifts, up[2])
    return (_staged_out(stB.dist, receivers),
            stA.it + stK.it + stB.it)


def composite_velocity3d(gr: Grid3D, r_boundary: float,
                         V_above, V_below) -> np.ndarray:
    """Node velocities of the COMPOSITE radial model: the `V_above`
    interpolant for r >= r_boundary, `V_below` for r < r_boundary.  A
    boundary-converted phase class (SKS: S mantle legs + P core leg) is
    the Fermat first arrival of the composite model whose speed is Vs
    above the CMB and Vp below it; feed the result to `solve3d` (any
    star)."""
    rr = np.asarray(gr.r, np.float64)
    above = rr >= r_boundary - 1e-9
    return np.where(above, np.asarray(V_above(rr), np.float64),
                    np.asarray(V_below(rr), np.float64))


def refine3d_travel_times(
    gr: Grid3D,
    U: np.ndarray,
    source: int,
    receivers: Sequence[int],
    profile_r: np.ndarray,
    profile_v: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    star: int = 2,
    m: int = 160,
    iters: int = 800,
    lr: float = 3.0,
    engine: str = "sweep",
    _packed: Packed3D = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Bias-free 3-D first arrivals: star-`star` SPM solve + prev
    recovery + batched bending refinement (the 2-D cure of
    solvers/refine.py lifted to the lattice).

    The SPM stage only needs to land the polyline in the right phase
    class (its angular quantisation bias is then removed by the bend),
    so star=2 suffices; the bent time is an upper bound of the
    continuous Fermat minimum of (profile_r, profile_v).  For converted
    phases pass the composite velocities (`composite_velocity3d`) as both
    U and the profile.  The solve, the prev recovery and the bend (the
    `bend` kernel, float64) run on `device`.

    Returns (times, spm_times): the refined and the raw SPM arrival per
    receiver."""
    from .path import recontruct_path
    from .refine import refine_paths_batch

    dev = resolve_device(device)
    packed = _packed if _packed is not None else prepare3d(
        gr, U, config, star=star, device=dev)
    dist, _ = solve3d(gr, U, [source], config, engine=engine,
                      _packed=packed, device=dev)
    prev = recover_prev3d(gr, U, dist, [source], config, _packed=packed,
                          device=dev)[0]
    receivers = np.asarray(receivers, dtype=np.int64).ravel()
    spm_t = np.asarray(dist[0])[receivers]
    paths = [recontruct_path(prev, int(source), int(r_))
             for r_ in receivers]
    pts = [np.stack([gr.x[p], gr.y[p], gr.z[p]], axis=1) for p in paths]
    r_max = float(np.max(gr.r))
    _, t = refine_paths_batch(pts, profile_r, profile_v, m=m, iters=iters,
                              lr=lr, r_max=r_max, device=dev)
    # bending is a descent from the SPM polyline: never worse
    return np.minimum(np.asarray(t), spm_t), spm_t


def converted3d_refined(
    gr: Grid3D,
    U_down: np.ndarray,
    U_core: np.ndarray,
    source: int,
    receivers: Sequence[int],
    r_boundary: float,
    profile_r: np.ndarray,
    profile_v_mantle: np.ndarray,
    profile_v_core: np.ndarray,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    star: int = 2,
    m: int = 192,
    iters: int = 800,
    lr: float = 3.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Bias-free 3-D converted-phase (SKS-class) first arrivals: staged
    star-`star` solve + per-stage path recovery + bending under the
    COMPOSITE radial profile (mantle speed above r_boundary, core speed
    below - Snell's law at the crossing emerges from the continuous
    Fermat minimum).

    The initial polyline comes from the STAGED fields (stage prevs via
    `_prev3d_seeded`, stage handoffs stitched through the twin planes),
    which pins the phase CLASS; a plain composite-velocity SPM solve
    would instead find interface-skimming paths whose graph edges mix the
    two side velocities.  The final stage restarts from the core field's
    underside plane alone, as the JAX function does (solve3d_converted
    also keeps stage A's topside times there).

    Returns (refined_times, spm_times) per receiver."""
    from .path import recontruct_path
    from .refine import refine_paths_batch

    dev = resolve_device(device)
    dtype = np.dtype(config.dtype)
    shifts = shifts_star(star)
    shp3 = (gr.nnods[2], gr.nnods[1], gr.nnods[0])
    n0, n1 = gr.nnods[0], gr.nnods[1]
    r_ax = np.asarray(gr.r_ax)
    k_top = int(np.argmin(np.abs(r_ax - r_boundary)))
    k_under = k_top - 1

    keep_top = (gr.r >= r_boundary - 1e-6).reshape(shp3)
    keep_core = (gr.r <= r_boundary - 1e-6).reshape(shp3)
    W_dn, sc_dn, lay_dn = _staged_weights(gr, U_down, keep_top, dtype,
                                          shifts, dev)
    W_k, sc_k, lay_k = _staged_weights(gr, U_core, keep_core, dtype,
                                       shifts, dev)

    tol = torch.tensor(config.tol_value(), dtype=W_dn.dtype, device=dev)
    stA = _solve3d_sweep([int(source)], W_dn, sc_dn, tol, config.max_iters,
                         (0, 1, 2), shifts, lay_dn)
    d0K = torch.full_like(stA.dist, float("inf"))
    d0K[:, k_under] = stA.dist[:, k_top]
    stK = _solve3d_sweep_init(d0K, W_k, sc_k, tol, config.max_iters,
                              (0, 1, 2), shifts, lay_k)
    d0B = torch.full_like(stK.dist, float("inf"))
    d0B[:, k_top] = stK.dist[:, k_under]
    stB = _solve3d_sweep_init(d0B, W_dn, sc_dn, tol, config.max_iters,
                              (0, 1, 2), shifts, lay_dn)

    prevA = _prev3d_seeded(stA.dist[0], W_dn, shifts).cpu().numpy()
    prevK = _prev3d_seeded(stK.dist[0], W_k, shifts).cpu().numpy()
    prevB = _prev3d_seeded(stB.dist[0], W_dn, shifts).cpu().numpy()
    prevA[int(source)] = int(source)
    dB = stB.dist[0].reshape(-1).cpu().numpy()
    spm_t = dB[np.asarray(receivers, dtype=np.int64)]

    plane = n0 * n1                      # flat stride of one r-level

    def col_node(node, k):
        """Node id at r-level k in the same (phi, theta) column."""
        return int(node) % plane + k * plane

    paths = []
    for r_ in np.asarray(receivers, dtype=np.int64):
        pB = recontruct_path(prevB, -1, int(r_))   # walk to its seed
        pB = pB[:-1] if pB[-1] == -1 else pB       # (sentinel never hit)
        e_top = int(pB[-1])
        pK = recontruct_path(prevK, -1, col_node(e_top, k_under))
        pK = pK[:-1] if pK[-1] == -1 else pK
        s_under = int(pK[-1])
        pA = recontruct_path(prevA, int(source), col_node(s_under, k_top))
        nodes = np.concatenate([pB, pK, pA]).astype(np.int64)
        paths.append(np.stack([gr.x[nodes], gr.y[nodes], gr.z[nodes]],
                              axis=1))

    rs = np.asarray(profile_r, np.float64)
    v_comp = np.where(rs >= r_boundary,
                      np.asarray(profile_v_mantle, np.float64),
                      np.asarray(profile_v_core, np.float64))
    _, t = refine_paths_batch(paths, rs, v_comp, m=m, iters=iters, lr=lr,
                              r_max=float(np.max(gr.r)), device=dev)
    return np.asarray(t), spm_t
