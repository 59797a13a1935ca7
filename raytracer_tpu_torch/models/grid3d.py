"""3-D structured spherical-shell grid (theta, phi, r box).

Host-side NumPy, a copy of `raytracer_tpu/models/grid3d.py`: the eager
and lazy node layouts, 8-node hexahedral connectivity, nodal incidence
with optional star-level expansion, discontinuity-forced radial axes with
side-aware velocities, and closest-point lookup.  It uses the port's own
`config.TWIN_OFFSET` and `config.VELOCITY_BUFFER`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..config import TWIN_OFFSET, VELOCITY_BUFFER
from ..utils.coords import spherical2cart


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Eager grid: axes + flattened cartesian/spherical node coordinates.

    Node (i, j, k) -> flat id i + j*n0 + k*n0*n1 (theta fastest), matching
    the reference layout (src/StructuredGrid.jl:96-101).

    forced_radii records velocity-discontinuity radii baked into r_ax by
    `grid3d(force_radii=...)`: each appears as TWO adjacent r levels
    (r_d - twin_offset carrying the below-side velocity, r_d the above
    side) -- the lattice-preserving equivalent of the 2-D annulus' twin
    node doubling + halo (models/annulus.py, reference
    src/GridAnnulus.jl:910-968).  See `velocity3d`.
    """

    c0: Tuple[float, float, float]
    c1: Tuple[float, float, float]
    nnods: Tuple[int, int, int]
    theta_ax: np.ndarray
    phi_ax: np.ndarray
    r_ax: np.ndarray
    theta: np.ndarray
    phi: np.ndarray
    r: np.ndarray
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    forced_radii: Tuple[float, ...] = ()
    twin_offset: float = 0.05

    @property
    def nels(self) -> Tuple[int, int, int]:
        return tuple(n - 1 for n in self.nnods)

    @property
    def nnods_total(self) -> int:
        return int(np.prod(self.nnods))

    @property
    def nel_total(self) -> int:
        return int(np.prod(self.nels))

    def __len__(self) -> int:
        return self.nnods_total


@dataclasses.dataclass(frozen=True)
class LazyGrid3D:
    """Computed-on-index grid (src/StructuredGrid.jl:18-25,47-55)."""

    c0: Tuple[float, float, float]
    c1: Tuple[float, float, float]
    delta: Tuple[float, float, float]
    nnods: Tuple[int, int, int]

    def __getitem__(self, flat: int):
        n0, n1, _ = self.nnods
        i = flat % n0
        j = (flat // n0) % n1
        k = flat // (n0 * n1)
        return (
            self.c0[0] + i * self.delta[0],
            self.c0[1] + j * self.delta[1],
            self.c0[2] + k * self.delta[2],
        )

    def __len__(self) -> int:
        return int(np.prod(self.nnods))


def grid3d(c0, c1, nnods, force_radii=None, twin_offset: float = None) -> Grid3D:
    """Eager spherical-shell grid (src/StructuredGrid.jl:35-45).

    force_radii: velocity-discontinuity radii (km) to bake into the
    radial axis -- the 3-D equivalent of the 2-D mesher forcing the AK135
    discontinuities into the r column (src/GridAnnulus.jl:73-86) PLUS its
    twin doubling: for each such radius strictly inside the box, the
    nearest interior r level snaps onto it and an extra level is inserted
    at r - twin_offset, so the interface is represented by two adjacent
    levels that `velocity3d` assigns the above/below velocities.  The
    regular (theta, phi, r) lattice -- and with it the whole dense
    26-shift solve -- is preserved; only the axis becomes non-uniform
    (the shifted-weight build uses true coordinates, so nothing else
    changes).  Crossing the interface costs the twin-gap traversal
    (~twin_offset / v ~ 5 ms), the dense analogue of the 2-D halo's
    zero-cost twin merge.
    """
    off = TWIN_OFFSET if twin_offset is None else float(twin_offset)
    th_ax = np.linspace(c0[0], c1[0], nnods[0])
    ph_ax = np.linspace(c0[1], c1[1], nnods[1])
    r_ax = np.linspace(c0[2], c1[2], nnods[2])
    forced = []
    if force_radii:
        dr = r_ax[1] - r_ax[0] if len(r_ax) > 1 else 0.0
        for rd in sorted(force_radii):
            rd = float(rd)
            if not (c0[2] + 0.5 * dr < rd < c1[2] - 0.25 * dr):
                continue
            # snap the nearest interior level, then insert the twin below
            k = int(np.argmin(np.abs(r_ax - rd)))
            k = min(max(k, 1), len(r_ax) - 2)
            r_ax[k] = rd
            r_ax = np.insert(r_ax, k, rd - off)
            forced.append(rd)
        r_ax = np.unique(r_ax)
    nn = (int(nnods[0]), int(nnods[1]), int(len(r_ax)))
    # flat layout: theta fastest, then phi, then r
    TH = np.tile(th_ax, nn[1] * nn[2])
    PH = np.tile(np.repeat(ph_ax, nn[0]), nn[2])
    RR = np.repeat(r_ax, nn[0] * nn[1])
    x, y, z = spherical2cart(TH, PH, RR)
    return Grid3D(
        c0=tuple(c0), c1=tuple(c1), nnods=nn,
        theta_ax=th_ax, phi_ax=ph_ax, r_ax=r_ax,
        theta=TH, phi=PH, r=RR, x=x, y=y, z=z,
        forced_radii=tuple(forced), twin_offset=off,
    )


def velocity3d(gr: Grid3D, interpolant, buffer: float = None) -> np.ndarray:
    """Side-aware velocity sampling for a discontinuity-forced 3-D grid.

    Levels exactly ON a forced radius take the velocity `buffer` km ABOVE
    it; their twin levels (r_d - twin_offset) take `buffer` km BELOW --
    the 3-D counterpart of the 2-D dual_velocity semantics
    (src/ShortestPath.jl:97-112) that keeps each side of an interface at
    its own velocity instead of the 1-km table smear.  Away from forced
    radii this is plain interpolation.
    """
    buf = VELOCITY_BUFFER if buffer is None else float(buffer)
    U = np.asarray(interpolant(gr.r), dtype=np.float64)
    for rd in gr.forced_radii:
        U = np.where(gr.r == rd, interpolant(rd + buf), U)
        U = np.where(gr.r == rd - gr.twin_offset, interpolant(rd - buf), U)
    return U


def lazy_grid3d(c0, c1, nnods) -> LazyGrid3D:
    delta = tuple((c1[d] - c0[d]) / (nnods[d] - 1) for d in range(3))
    return LazyGrid3D(c0=tuple(c0), c1=tuple(c1), delta=delta, nnods=tuple(nnods))


def connectivity3d(gr: Grid3D) -> np.ndarray:
    """(nel, 8) hexa element->node table (src/StructuredGrid.jl:121-168)."""
    n0, n1, _ = gr.nnods
    e0, e1, e2 = gr.nels
    i = np.tile(np.arange(e0), e1 * e2)
    j = np.tile(np.repeat(np.arange(e1), e0), e2)
    k = np.repeat(np.arange(e2), e0 * e1)
    base = i + j * n0 + k * n0 * n1
    nxny = n0 * n1
    return np.stack(
        [
            base,
            base + 1,
            base + 1 + n0,
            base + n0,
            base + nxny,
            base + nxny + 1,
            base + nxny + 1 + n0,
            base + nxny + n0,
        ],
        axis=1,
    ).astype(np.int64)


def nodal_incidence3d(gr: Grid3D, neighbour_levels: int = 0) -> sp.csr_matrix:
    """Node adjacency: nodes sharing an element, optionally expanded by
    `neighbour_levels` graph powers (src/StructuredGrid.jl:177-223)."""
    e2n = connectivity3d(gr)
    nel = e2n.shape[0]
    rows = np.repeat(np.arange(nel), 8)
    inc = sp.csr_matrix(
        (np.ones(nel * 8, np.int32), (rows, e2n.ravel())),
        shape=(nel, gr.nnods_total),
    )
    A = (inc.T @ inc).tocsr()
    for _ in range(neighbour_levels):
        A = (A + A @ A).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    A.sort_indices()
    A.data = np.ones(len(A.data), dtype=bool)
    return A


def closest_point3d(gr: Grid3D, x: float, y: float, z: float) -> int:
    """Closest node in cartesian space (src/StructuredGrid.jl:257-270)."""
    return int(np.argmin((gr.x - x) ** 2 + (gr.y - y) ** 2 + (gr.z - z) ** 2))


def distance3d_nodes(gr: Grid3D, a: int, b: int) -> float:
    return float(
        np.sqrt((gr.x[a] - gr.x[b]) ** 2 + (gr.y[a] - gr.y[b]) ** 2 + (gr.z[a] - gr.z[b]) ** 2)
    )
