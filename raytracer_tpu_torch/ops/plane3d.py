"""One directional plane pass of the 3-D sweep engine: kernel and twin.

Counterpart of `raytracer_tpu/solvers/solve3d.py` `_plane_sweep3d`, which
the JAX package runs as XLA (a `lax.scan` over the planes along one
axis).  As plain torch one plane step is ~400 small launches (17 tap
rolls, adds and minima, four `_sum_min_scan`s of ~7 levels each), ~250k
a round at 128x128x64, so the port runs a whole pass in one launch of
the hand-written CUDA kernel `csrc/plane3d.cu` (a kernel of the port's
own choice: the JAX package has no Pallas kernel here).

What a pass computes, for the planes p along `axis` in sweep order
(descending for `down`, as `lax.scan(reverse=True)`): `cur` starts as
plane p of the input field, then
  1. cross taps: for m = 1..reach, for each shift s with s[axis] = m*sgn
     (sgn = +1 down, -1 up), cur = min(cur, roll(prev_m, -in-plane
     shift) + W[s]), prev_m the plane processed m steps earlier (+inf at
     the box face, or `carry_init`);
  2. in-plane taps, in the stencil's order, each a Jacobi update of the
     whole plane: cur = min(cur, roll(cur, -shift) + W[s]);
  3. `_axis_scan` along plane axis 0, then along plane axis 1: min(x,
     forward scan of x, backward scan of x), both scans of the same x.
The plain twin `plane_sweep3d_reference` is that function op for op (the
JAX package's rolls wrap; a wrapped candidate always meets a +inf
weight, because `_shifted_weights` masks the box faces, so the kernel
skips taps that leave the plane and gives the same floats: the tests
assert the premise on the weights they use).  `plane_sweep3d` takes a
CPU tensor to the twin and a CUDA tensor to the kernel (or raises).

The kernel's scans read the sum component of `_sum_min_scan`'s
recursion from trees built once a layout (`scan_sum_trees`, the
recursion's own pairwise sums in the field's dtype, as
`diag_circulant.chain_sum_tree` builds the 2-D chain's) and scan only
the min component, level by level in place; `plane3d_scan_reference`
replays those levels in torch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..kernels import BLOCK_SMEM
from .diag_circulant import _sum_min_scan
from .sweep3d import SHIFTS3


def _axis_scan(dist: torch.Tensor, cost_fwd: torch.Tensor,
               cost_bwd: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact min-plus chain relaxation along `axis`, both directions.

    cost_fwd[..., t, ...] = weight entering position t from t-1 (+inf at
    t=0); cost_bwd = entering t from t+1 (flipped for the reverse scan).
    The scan is `jax.lax.associative_scan`'s recursion over (sum, min)
    pairs (`_sum_min_scan`), so the sums round as the JAX package's.
    The costs broadcast against `dist` (a leading source dimension of
    size 1 gives every source the same sums).
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


class PlaneLayout3D(NamedTuple):
    """`_sweep_layout3d` of one axis: the weights as (nA, n_shifts, p0,
    p1) planes and the four in-plane scan-cost plane stacks (nA, p0, p1)
    (p0, p1 the other two axes in order); on a CUDA device also the
    kernel's sum trees (`scan_sum_trees`)."""

    W: torch.Tensor
    c0f: torch.Tensor
    c0b: torch.Tensor
    c1f: torch.Tensor
    c1b: torch.Tensor
    trees: Optional[Tuple[torch.Tensor, ...]] = None


def tree_levels(n: int):
    """(offset, length) of each level of `_sum_min_scan`'s recursion on a
    line of n values: level 0 holds n, level l + 1 floor(len_l / 2), for
    as long as a level holds at least 2 values."""
    out, off = [], 0
    while n >= 2:
        out.append((off, n))
        off += n
        n //= 2
    return out


def _tree(c: torch.Tensor, dim: int) -> torch.Tensor:
    """The levels of pairwise sums of `c` along `dim`, concatenated:
    level l + 1 = level_l[0:n-1:2] + level_l[1::2], the recursion's sums."""
    levels = []
    while c.shape[dim] >= 2:
        levels.append(c)
        n = c.shape[dim]
        even = [slice(None)] * c.dim()
        odd = [slice(None)] * c.dim()
        even[dim], odd[dim] = slice(0, n - 1, 2), slice(1, None, 2)
        c = c[tuple(even)] + c[tuple(odd)]
    if not levels:
        shp = list(c.shape)
        shp[dim] = 0
        return c.new_empty(shp)
    return torch.cat(levels, dim=dim).contiguous()


def scan_sum_trees(c0f, c0b, c1f, c1b):
    """The kernel's sum trees of one layout: for the scans along plane
    axis 0 (lines over p0, one per p1 column) (nA, T0, p1) forward and
    backward, along plane axis 1 (nA, p0, T1); the backward ones from the
    reversed costs, as `_axis_scan` flips them."""
    return (_tree(c0f, 1), _tree(torch.flip(c0b, dims=[1]), 1),
            _tree(c1f, 2), _tree(torch.flip(c1b, dims=[2]), 2))


def plane3d_scan_reference(x: torch.Tensor, tree_f: torch.Tensor,
                           tree_b: torch.Tensor, axis: int) -> torch.Tensor:
    """csrc/plane3d.cu's scan of (p0, p1) planes along plane axis `axis`
    in plain torch: the min component alone, level by level in place
    (value i of level l at position (i + 1) * 2^l - 1 of the line), up:
    m[p] = min(m[p - 2^l] + s_l[2i+1], m[p]) at p = (2i+2) * 2^l - 1;
    down: m[q] = min(m[q - 2^l] + s_l[2i], m[q]) at q = (2i+1) * 2^l - 1,
    i >= 1; the backward direction on the reversed line with its own
    tree; out = min(x, forward, backward).  The same floats as
    `_axis_scan` by another route.  x (..., p0, p1); trees as
    `scan_sum_trees` gives them for one plane."""
    lines = torch.movedim(x, axis - 2, -1)          # (..., other, n)
    tf = torch.movedim(tree_f, axis - 2, -1)
    tb = torch.movedim(tree_b, axis - 2, -1)
    levels = tree_levels(lines.shape[-1])

    def scan(v, tree):
        a = v.clone()
        for lev, (off, n) in enumerate(levels):                  # up
            i = torch.arange(n // 2, device=v.device)
            p = ((2 * i + 2) << lev) - 1
            a[..., p] = torch.minimum(a[..., p - (1 << lev)]
                                      + tree[..., off + 2 * i + 1], a[..., p])
        for lev in range(len(levels) - 1, -1, -1):               # down
            off, n = levels[lev]
            i = torch.arange(1, (n - 1) // 2 + 1, device=v.device)
            q = ((2 * i + 1) << lev) - 1
            a[..., q] = torch.minimum(a[..., q - (1 << lev)]
                                      + tree[..., off + 2 * i], a[..., q])
        return a

    fwd = scan(lines, tf)
    bwd = torch.flip(scan(torch.flip(lines, dims=[-1]), tb), dims=[-1])
    out = torch.minimum(torch.minimum(lines, fwd), bwd)
    return torch.movedim(out, -1, axis - 2)


def plane_taps(shifts, axis: int, down: bool):
    """(reach, cross, inpl, oaxes): cross[m-1] the shifts whose `axis`
    component is m * sgn (sgn = +1 down, -1 up; the taps of the opposite
    sign are the other direction's pass), inpl those with 0 there, in
    the stencil's order, and oaxes the two other axes."""
    sgn = +1 if down else -1
    reach = max(abs(sh[axis]) for sh in shifts)
    cross = [[s for s, sh in enumerate(shifts) if sh[axis] == m * sgn]
             for m in range(1, reach + 1)]
    inpl = [s for s, sh in enumerate(shifts) if sh[axis] == 0]
    oaxes = [a for a in (0, 1, 2) if a != axis]
    return reach, cross, inpl, oaxes


def _init_carry(inf_pl: torch.Tensor, reach: int, carry_init):
    """The scan carry before the first plane: +inf planes, or
    `carry_init` (one plane, or a tuple of up to `reach` planes, the one
    processed last first) padded with +inf."""
    if carry_init is None:
        return (inf_pl,) * reach
    if isinstance(carry_init, tuple):
        return tuple(carry_init) + (inf_pl,) * (reach - len(carry_init))
    return (carry_init,) + (inf_pl,) * (reach - 1)


def plane_sweep3d_reference(d: torch.Tensor, layout, axis: int, down: bool,
                            carry_init=None, shifts=SHIFTS3) -> torch.Tensor:
    """Plain PyTorch twin of one directional pass: the JAX package's
    `_plane_sweep3d` op for op, on a (n2, n1, n0) field or a batch
    (S, n2, n1, n0) of them (the JAX package vmaps; each source gets the
    same floats).  `layout` is `_sweep_layout3d`'s for `axis` (its first
    five fields), `carry_init` one (p0, p1) plane (or (S, p0, p1)), or a
    tuple of them."""
    reach, cross, inpl, oaxes = plane_taps(shifts, axis, down)

    def pl_shift(s):
        sh = shifts[s]
        return (sh[oaxes[0]], sh[oaxes[1]])

    batched = d.dim() == 4
    x = d if batched else d[None]
    xs = torch.movedim(x, 1 + axis, 1)               # (S, nA, p0, p1)
    W, c0f, c0b, c1f, c1b = layout[:5]
    nA = xs.shape[1]
    inf_pl = torch.full_like(xs[:, 0], float("inf"))
    prevs = tuple(p if p.dim() == 3 else p[None].expand_as(inf_pl)
                  for p in _init_carry(inf_pl, reach, carry_init))
    out = torch.empty_like(xs)
    for p in (range(nA - 1, -1, -1) if down else range(nA)):
        cur, Wp = xs[:, p], W[p]
        for m in range(reach):
            for s in cross[m]:
                da, db = pl_shift(s)
                cur = torch.minimum(cur, torch.roll(prevs[m], (-da, -db),
                                                    dims=(1, 2)) + Wp[s])
        for s in inpl:
            da, db = pl_shift(s)
            cur = torch.minimum(cur, torch.roll(cur, (-da, -db), dims=(1, 2))
                                + Wp[s])
        cur = _axis_scan(cur, c0f[p][None], c0b[p][None], 1)
        cur = _axis_scan(cur, c1f[p][None], c1b[p][None], 2)
        out[:, p] = cur
        prevs = (cur,) + prevs[:-1]
    out = torch.movedim(out, 1, 1 + axis)
    return out if batched else out[0]


def _tap_table(shifts, axis: int, down: bool, device) -> torch.Tensor:
    """(n_cross + n_inpl, 4) int32 rows (s, m, da, db) as the kernel reads
    them: the cross taps (m >= 1), then the in-plane taps (m = 0) in the
    stencil's order; cached per (stencil, axis, direction, device)."""
    key = (tuple(shifts), axis, down, str(device))
    tab = _TAPS.get(key)
    if tab is None:
        _, cross, inpl, oaxes = plane_taps(shifts, axis, down)
        rows = [(s, m + 1, shifts[s][oaxes[0]], shifts[s][oaxes[1]])
                for m, lst in enumerate(cross) for s in lst]
        rows += [(s, 0, shifts[s][oaxes[0]], shifts[s][oaxes[1]])
                 for s in inpl]
        tab = torch.tensor(rows, dtype=torch.int32, device=device)
        _TAPS[key] = tab
    return tab


_TAPS: dict = {}


def plane3d_smem_bytes(p0: int, p1: int, itemsize: int) -> Tuple[int, int]:
    """(shared bytes, planes) of one kernel block: as many (p0, p1)
    planes as fit in BLOCK_SMEM, at most 3 - the current plane;
    a second one for the in-plane taps' ping-pong and the scans (else it
    lives in device memory, one plane a source); a third one lets an
    axis's forward and backward scans run together.  Raises ValueError,
    naming the limit, for a plane that does not fit alone."""
    one = p0 * p1 * itemsize
    if one > BLOCK_SMEM:
        raise ValueError(f"plane3d keeps a {p0}x{p1} plane ({one} bytes) in "
                         f"shared memory: over the {BLOCK_SMEM} "
                         f"bytes an H100 block may have")
    planes = min(3, BLOCK_SMEM // one)
    return planes * one, planes


def _plane3d_lib() -> ctypes.CDLL:
    lib = kernels.load("plane3d")
    fn = lib.plane3d_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p] * 2)
    return lib


def plane_sweep3d(d: torch.Tensor, layout: PlaneLayout3D, axis: int,
                  down: bool, carry_init=None,
                  shifts=SHIFTS3) -> torch.Tensor:
    """One Gauss-Seidel plane pass along `axis` (directional sweeping) of
    a (n2, n1, n0) field or a batch (S, n2, n1, n0); returns a new field,
    the input untouched.  `solvers.solve3d._plane_sweep3d` is this
    function under the JAX package's name.

    The cross taps read the planes already updated in this pass, so
    arrivals cross the whole box along `axis` in one pass; the in-plane
    taps and the two in-plane axis scans give full reach within each
    plane.  Every candidate is a real path cost, so the fixpoint is that
    of the Jacobi engines.  carry_init seeds the planes "before" the
    first one processed (one plane, or a tuple of up to `reach`): +inf
    when None (the box face); the node-sharded solver of the JAX package
    passes the neighbour block's halo plane.

    A CUDA tensor (float32 or float64) goes to the hand-written kernel
    `csrc/plane3d.cu`, one block a source marching the planes
    (`plane_sweep3d.launches` counts its launches); a plane larger than
    an H100 block's shared memory raises ValueError before the launch.
    A CPU tensor goes to `plane_sweep3d_reference`.  Any other device
    raises.
    """
    if d.dim() not in (3, 4):
        raise ValueError(f"d must be (n2, n1, n0) or (S, n2, n1, n0), got "
                         f"{tuple(d.shape)}")
    W = layout.W
    if d.device != W.device or d.dtype != W.dtype:
        raise ValueError(f"field ({d.device}, {d.dtype}) and weights "
                         f"({W.device}, {W.dtype}) differ")
    if d.device.type == "cpu":
        return plane_sweep3d_reference(d, layout, axis, down, carry_init,
                                       shifts)
    if d.device.type != "cuda":
        raise ValueError(f"plane_sweep3d runs on cuda or cpu, not "
                         f"{d.device}")
    kernels.require_float("plane3d", d.dtype)
    if layout.trees is None:
        raise ValueError("the layout carries no sum trees: build it on the "
                         "card with _sweep_layout3d")
    batched = d.dim() == 4
    x = d if batched else d[None]
    S = x.shape[0]
    xs = torch.movedim(x, 1 + axis, 1).contiguous()      # (S, nA, p0, p1)
    _, nA, p0, p1 = xs.shape
    if tuple(W.shape) != (nA, len(shifts), p0, p1):
        raise ValueError(f"layout W {tuple(W.shape)} does not fit planes "
                         f"({nA}, {p0}, {p1}) of {len(shifts)} shifts")
    smem, planes = plane3d_smem_bytes(p0, p1, d.element_size())
    reach, cross, inpl, _ = plane_taps(shifts, axis, down)
    taps = _tap_table(shifts, axis, down, d.device)
    carry = None
    nc = 0
    if carry_init is not None:
        seeds = (carry_init if isinstance(carry_init, tuple)
                 else (carry_init,))
        if len(seeds) > reach:
            raise ValueError(f"carry_init holds {len(seeds)} planes, the "
                             f"stencil reaches {reach}")
        carry = torch.stack([p.expand(S, p0, p1) if p.dim() == 2
                             else p.reshape(S, p0, p1) for p in seeds],
                            dim=1).to(d.dtype).contiguous()
        nc = len(seeds)
    out = torch.empty_like(xs)
    xbuf = None if planes > 1 else torch.empty((S, p0 * p1), dtype=d.dtype,
                                               device=d.device)
    t0f, t0b, t1f, t1b = layout.trees
    stream = torch.cuda.current_stream(d.device).cuda_stream
    rc = _plane3d_lib().plane3d_launch(
        xs.data_ptr(), out.data_ptr(), W.data_ptr(), t0f.data_ptr(),
        t0b.data_ptr(), t1f.data_ptr(), t1b.data_ptr(),
        0 if carry is None else carry.data_ptr(),
        0 if xbuf is None else xbuf.data_ptr(),
        S, nA, p0, p1, len(shifts), nc, sum(len(c) for c in cross),
        len(inpl), int(down), planes, smem,
        int(d.dtype == torch.float64), taps.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"plane3d kernel launch failed: CUDA error {rc}")
    plane_sweep3d.launches += 1
    out = torch.movedim(out, 1, 1 + axis)
    return out if batched else out[0]


plane_sweep3d.launches = 0
