"""O(M) analytic circulant builder for the annulus mesh.

The production annulus mesh is perfectly rotationally symmetric: every
theta column carries the same radial node template, the same secondary
subdivisions, the same twin doubling and the same edge weights
(`ops/circulant.py` proves this numerically on every build).  The full
n-node graph therefore never needs to exist: this module builds ONE
periodic *wedge* of a few columns at the full mesh's exact column pitch
(`init_annulus(..., dtheta=2*pi/ntheta)`), extracts the circulant stencil
from it with the standard `build_circulant`, and tiles node coordinates
analytically.  Setup cost is O(M) in the per-column node count M instead
of O(n = M * ntheta): the 20.9M-node 8640x2400 grid packs in seconds
instead of the minutes the materialised build takes.

Correctness argument:
  * a periodic wedge of W columns at pitch dtheta is geometrically
    identical to any W consecutive columns of the full annulus: the
    builders parameterise everything by dtheta, and the stencil reach is
    +-2 columns < W//2, so the wedge's column pattern IS the full mesh's
    column pattern (same slot keys, same dc offsets, same weights);
  * `build_circulant`'s slot ordering is intrinsic (sorted by quantised
    (r, theta-offset, twin-class) keys), so the stencil does not depend
    on builder node numbering - the wedge-extracted (src_flat, w,
    fan_slots, fan_w) equal the full-mesh extraction bit-for-bit at f32.

A copy of `raytracer_tpu/models/fast_annulus.py` (host NumPy); the port's
tests hold its output equal, bit for bit, to the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..config import R
from ..utils import profiling
from ..utils.coords import polar2cartesian
from .annulus import Grid2D, RaggedView, init_annulus

# minimum wedge width: the dc reach is +-2 and build_circulant folds dc
# offsets through `dc > nt//2` - nt//2 must exceed the reach
_MIN_WEDGE = 6
_DEFAULT_WEDGE = 8


def wedge_annulus(ntheta: int, nr: int, spacing: float = 20.0, star: int = 1,
                  wedge: int = _DEFAULT_WEDGE):
    """(gr, A, halo) of a `wedge`-column periodic wedge at the FULL mesh's
    column pitch 2*pi/ntheta.  Every column is geometrically identical to
    a column of the full (ntheta, nr) annulus."""
    if wedge < _MIN_WEDGE:
        raise ValueError(f"wedge must be >= {_MIN_WEDGE} columns")
    if ntheta < wedge:
        raise ValueError(f"ntheta={ntheta} smaller than the wedge ({wedge}); "
                         "use init_annulus directly")
    dtheta = 2 * np.pi / ntheta
    return init_annulus(wedge, nr, spacing=spacing, star=star, dtheta=dtheta)


def _empty_ragged() -> RaggedView:
    return RaggedView(np.empty(0, np.int64), np.zeros(1, np.int64))


def tile_wedge_grid(gr_w: Grid2D, cmap_w, ntheta: int,
                    perm: Optional[np.ndarray] = None) -> Grid2D:
    """Full-annulus Grid2D tiled from a wedge's column-0 template.

    Node numbering is column-major with the per-column slot permutation
    `perm` (default identity): node of slot perm[j] in column c has id
    c * M + j; the core centre is last (id = ntheta * M).  Carries
    coordinates, polar coordinates and twin classes; element/neighbour
    lists are empty (the circulant solvers never touch them - graph
    structure lives in the stencil).
    """
    M = cmap_w.M
    if perm is None:
        perm = np.arange(M, dtype=np.int64)
    ids0 = cmap_w.node_of[:, 0][perm]        # wedge column-0 node per new id
    r_t = gr_w.r[ids0]                       # (M,) radii template
    th_t = gr_w.theta[ids0]                  # (M,) theta offsets in [0, dtheta)
    cls_t = (gr_w.twin_class[ids0] if gr_w.twin_class is not None
             else np.zeros(M, np.int8))

    dtheta = 2 * np.pi / ntheta
    n = ntheta * M + 1
    theta = np.empty(n, np.float64)
    r = np.empty(n, np.float64)
    cols = np.arange(ntheta, dtype=np.float64) * dtheta
    theta[:-1] = (cols[:, None] + th_t[None, :]).reshape(-1)
    r[:-1] = np.broadcast_to(r_t, (ntheta, M)).reshape(-1)
    theta[-1] = 0.0
    r[-1] = 0.0                              # core centre
    x, z = polar2cartesian(theta, r)

    twin_class = np.empty(n, np.int8)
    twin_class[:-1] = np.broadcast_to(cls_t, (ntheta, M)).reshape(-1)
    twin_class[-1] = 0

    return Grid2D(
        x=x, z=z, theta=theta, r=r,
        e2n=_empty_ragged(),
        ntheta=ntheta, nr=gr_w.nr, nel=0, nnods=n,
        neighbours=_empty_ragged(),
        is_quad=np.zeros(0, bool),
        twin_class=twin_class,
        e2n_flat=np.empty(0, np.int64), e2n_off=np.zeros(1, np.int64),
        nbr_flat=np.empty(0, np.int64), nbr_off=np.zeros(1, np.int64),
    )


@profiling.setup_span("build.grid")
def init_annulus_circulant(
    ntheta: int,
    nr: int,
    spacing: float = 20.0,
    star: int = 1,
    velocity: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    dtype=np.float32,
    wedge: int = _DEFAULT_WEDGE,
) -> Tuple[Grid2D, "CirculantGraph", np.ndarray]:
    """O(M) fast path to a solve-ready (grid, CirculantGraph, U) triple.

    `velocity` maps node radii -> velocities (scalar (n,) or dual (n, 2));
    it MUST be radial (velocity of a node depends only on its r) - that is
    the rotational symmetry the circulant layout requires, and exactly what
    `interpolate_velocity` / `dual_velocity` over a radial profile provide.
    Default: scalar AK135 Vp, matching the reference driver.

    Returns (gr, cg, U) where gr is the tiled full grid in slot-major node
    order (node (c, m) = c*M + m, centre last), cg the full-size
    CirculantGraph and U the velocities on gr's nodes.  Feed them to
    `AnnulusSolver(gr, A=None, halo=None, U=U, circulant=cg)`.

    Equivalent output to `init_annulus` + `build_circulant` (identical
    stencil, tested) at O(M) instead of O(n) host cost.
    """
    from ..ops.circulant import CirculantGraph, ColumnMap, build_circulant

    if velocity is None:
        from .velocity import (LinearInterpolation, interpolate_velocity,
                               velocity_profile)

        prof = velocity_profile("ak135")
        interp = LinearInterpolation(prof.r, prof.Vp)
        velocity = lambda rr: interpolate_velocity(rr, interp)  # noqa: E731

    gr_w, A_w, halo_w = wedge_annulus(ntheta, nr, spacing=spacing, star=star,
                                      wedge=wedge)
    U_w = np.asarray(velocity(gr_w.r))
    cg_w = build_circulant(gr_w, A_w, halo_w, U_w, dtype=dtype)
    cmap_w = cg_w.cmap
    M = cmap_w.M

    # Per-column node numbering: originals first, twins after (stable in
    # slot order within each class).  The standard build appends twins
    # after all regular nodes, and the prev-recovery zero-weight tie-break
    # (min node id among equal candidates, ops/circulant.py) is acyclic
    # precisely because a twin's ORIGINAL always has the smaller id - a
    # coincident twin-twin tie otherwise ping-pongs.  Replicate the
    # invariant here.
    cls_slot = (gr_w.twin_class[cmap_w.node_of[:, 0]]
                if gr_w.twin_class is not None else np.zeros(M, np.int8))
    perm = np.argsort(cls_slot != 0, kind="stable").astype(np.int64)
    pos = np.empty(M, np.int64)               # slot -> within-column id
    pos[perm] = np.arange(M, dtype=np.int64)

    gr = tile_wedge_grid(gr_w, cmap_w, ntheta, perm=perm)
    n = gr.nnods
    center = n - 1

    ids = np.arange(n - 1, dtype=np.int64)
    c_of = np.empty(n, np.int64)
    m_of = np.empty(n, np.int64)
    c_of[:-1] = ids // M
    m_of[:-1] = np.tile(perm, ntheta)          # slot of each node
    c_of[center] = -1
    m_of[center] = -1
    node_of = (np.arange(ntheta, dtype=np.int64)[None, :] * M
               + pos[:, None])                 # (M slots, ntheta) node ids
    cmap = ColumnMap(c_of=c_of, m_of=m_of, node_of=node_of,
                     center=center, M=M, ntheta=ntheta)

    cg = CirculantGraph(
        src_flat=cg_w.src_flat, w=cg_w.w,
        fan_slots=cg_w.fan_slots, fan_w=cg_w.fan_w,
        cmap=cmap, n=n,
    )

    # velocities tile with the radii (radial model); slot template from
    # the wedge's own sampled values so U is bit-equal to velocity(gr.r)
    U_t = U_w[cmap_w.node_of[:, 0][perm]]
    if U_t.ndim == 1:
        U = np.empty(n, U_t.dtype)
        U[:-1] = np.broadcast_to(U_t, (ntheta, M)).reshape(-1)
        U[center] = U_w[cmap_w.center]
    else:
        U = np.empty((n, U_t.shape[1]), U_t.dtype)
        U[:-1] = np.broadcast_to(U_t, (ntheta, M, U_t.shape[1])).reshape(-1, U_t.shape[1])
        U[center] = U_w[cmap_w.center]
    return gr, cg, U
