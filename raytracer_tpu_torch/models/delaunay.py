"""Delaunay-triangulated Earth disc: the non-circulant mesher.

A host copy of `raytracer_tpu/models/delaunay.py` (NumPy and
scipy.spatial.Delaunay, no torch): `triangle_annulus_2d` in its three
modes, `structured_convex_hull`, `unstructured_constrained_domain` and
`add_midpoints`, which the reference's orphaned Triangulate.jl mesher
(src/SSSP/annulus/mesh.jl) describes:

- ``mesh_type='layered'``  : concentric ring point sets (optionally
  aligned to the velocity discontinuities) + core point; the production
  mode.
- ``mesh_type='structured'``: rectangular lattice clipped to the Earth
  disc, merged with a surface circle, triangulated over the convex hull.
- ``mesh_type='unstructured'``: surface circle only; interior filled by
  iterative Delaunay refinement (centroid insertion into every triangle
  exceeding ``max_area``) until the area constraint holds.

Produces a Grid2D whose graph is NOT circulant: AnnulusSolver sends it
to 'banded' under auto and to 'ell' from an explicit circulant-family
method, as the JAX package does on its accelerator.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.spatial

from ..config import DISCONTINUITY_RADII, R, R_INNER
from ..utils.coords import cartesian2polar, polar2cartesian
from .annulus import Grid2D, element_neighbours


def ring_points(radii: Sequence[float], spacing: float) -> np.ndarray:
    """Points on concentric rings, ~`spacing` km apart along each ring."""
    pts = []
    for r in radii:
        n = max(int(2 * np.pi * r // spacing), 6)
        t = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
        pts.append(np.stack(polar2cartesian(t, np.full(n, float(r))), axis=1))
    return np.concatenate(pts)


def _circle(n: int, r: float) -> np.ndarray:
    """n-1 points on a circle of radius r (mesh.jl circle, pop_end=true:
    LinRange(0, 2pi, n) with the duplicate endpoint dropped)."""
    t = np.linspace(0.0, 2 * np.pi, n)[:-1]
    return np.stack(polar2cartesian(t, np.full(len(t), float(r))), axis=1)


def _dedupe(pts: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """Drop coincident points (keeps first occurrence, preserves order).

    The structured lattice can land exactly on a surface-circle point
    (e.g. (R, 0) when nx is odd); qhull dislikes exact duplicates.
    """
    key = np.round(pts / tol).astype(np.int64)
    _, idx = np.unique(key, axis=0, return_index=True)
    return pts[np.sort(idx)]


def structured_convex_hull(
    nsurf: int = 50, nx: int = 20, nz: int = 20, r_out: float = R
) -> np.ndarray:
    """Point set of the reference's :structured mode (mesh.jl:55-94):
    a rectangular (nx, nz) lattice over [-R, R]^2 clipped to the Earth
    disc, merged with nsurf-1 surface-circle points."""
    surf = _circle(nsurf, r_out)
    gx = np.linspace(-r_out, r_out, nx)
    gz = np.linspace(-r_out, r_out, nz)
    X, Z = np.meshgrid(gx, gz, indexing="ij")
    inner = np.stack([X.ravel(), Z.ravel()], axis=1)
    keep = np.hypot(inner[:, 0], inner[:, 1]) <= r_out
    return _dedupe(np.concatenate([surf, inner[keep]]))


def _tri_areas(pts: np.ndarray, simplices: np.ndarray) -> np.ndarray:
    a, b, c = pts[simplices[:, 0]], pts[simplices[:, 1]], pts[simplices[:, 2]]
    return 0.5 * np.abs(
        (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
        - (c[:, 0] - a[:, 0]) * (b[:, 1] - a[:, 1])
    )


def unstructured_constrained_domain(
    nsurf: int = 50,
    max_area: float = 25_000.0,
    r_out: float = R,
    max_rounds: int = 60,
) -> np.ndarray:
    """Point set of the reference's :unstructured mode (mesh.jl:96-111):
    the surface polygon refined until every triangle area <= max_area
    (Triangle's ``pa{max_area}Q`` behaviour; see module docstring for the
    centroid-insertion emulation)."""
    pts = _circle(nsurf, r_out)
    for _ in range(max_rounds):
        tri = scipy.spatial.Delaunay(pts)
        areas = _tri_areas(pts, tri.simplices)
        bad = areas > max_area
        if not bad.any():
            return pts
        centroids = pts[tri.simplices[bad]].mean(axis=1)
        pts = _dedupe(np.concatenate([pts, centroids]))
    raise RuntimeError(
        f"area refinement did not converge in {max_rounds} rounds "
        f"(max area {areas.max():.1f} > {max_area})"
    )


def _grid_from_points(pts: np.ndarray, nr: int,
                      nnods_shared: Optional[int] = None) -> Grid2D:
    """Delaunay-triangulate a point set and wrap it as a Grid2D."""
    tri = scipy.spatial.Delaunay(pts)
    simplices = tri.simplices
    keep = _tri_areas(pts, simplices) > 1e-9  # drop qhull slivers
    simplices = simplices[keep]

    theta, r = cartesian2polar(pts[:, 0], pts[:, 1])
    r = np.minimum(r, R)  # float noise on surface points (mesh.jl:47)
    e2n = [s.astype(np.int64) for s in simplices]
    if nnods_shared is None:
        nnods_shared = len(pts)
    neighbours = element_neighbours(e2n, nnods_shared=nnods_shared)
    return Grid2D(
        x=pts[:, 0].copy(), z=pts[:, 1].copy(), theta=theta, r=r,
        e2n=e2n, ntheta=0, nr=nr, nel=len(e2n), nnods=len(pts),
        neighbours=neighbours, is_quad=np.zeros(len(e2n), bool),
    )


def triangle_annulus_2d(
    nr: int = 20,
    spacing: float = 400.0,
    r_out: float = R,
    r_in: float = R_INNER,
    layered: bool = True,
    mesh_type: str = "layered",
    nsurf: int = 50,
    nx: int = 20,
    nz: int = 20,
    max_area: float = 25_000.0,
) -> Grid2D:
    """Delaunay-triangulated Earth disc (mesh.jl:14-53 equivalent).

    mesh_type selects the reference's three entry modes (see module
    docstring).  'layered': radial rings are a linspace from r_in to
    r_out; with layered=True the 7 discontinuity radii are forced in
    (layered_domain, mesh.jl:113-183).  'structured' uses (nsurf, nx,
    nz); 'unstructured' uses (nsurf, max_area); both ignore nr/spacing.
    """
    if mesh_type == "structured":
        return _grid_from_points(structured_convex_hull(nsurf, nx, nz, r_out), nr=nz)
    if mesh_type == "unstructured":
        return _grid_from_points(
            unstructured_constrained_domain(nsurf, max_area, r_out), nr=0)
    if mesh_type != "layered":
        raise ValueError(f"unknown mesh_type {mesh_type!r}")

    radii = np.linspace(r_in, r_out, nr)
    if layered:
        radii = np.unique(np.concatenate([radii, np.asarray(DISCONTINUITY_RADII)]))
    pts = ring_points(radii, spacing)
    # core centre point closes the inner hole like the structured mesher
    pts = np.concatenate([pts, [[0.0, 0.0]]])
    # core point excluded from neighbour sharing (bounds the core fan degree)
    return _grid_from_points(pts, nr=len(radii), nnods_shared=len(pts) - 1)


def add_midpoints(gr: Grid2D, npoints: int = 1) -> Grid2D:
    """Insert npoints evenly-spaced points on every triangle edge as
    secondary nodes (mesh.jl:310-383 equivalent, incl. its npoints knob);
    new nodes join both adjacent elements."""
    pairs = []
    owners = []
    local = np.array([[0, 1], [1, 2], [2, 0]])
    for e, nodes in enumerate(gr.e2n):
        p = np.sort(nodes[local], axis=1)
        pairs.append(p)
        owners.append(np.full(3, e))
    pairs = np.concatenate(pairs)
    owners = np.concatenate(owners)
    edges, inverse = np.unique(pairs, axis=0, return_inverse=True)

    # fractional positions k/(npoints+1), k = 1..npoints, along each edge
    frac = (np.arange(1, npoints + 1) / (npoints + 1))[None, :]  # (1, P)
    mid_x = (gr.x[edges[:, 0:1]] * (1 - frac) + gr.x[edges[:, 1:2]] * frac).ravel()
    mid_z = (gr.z[edges[:, 0:1]] * (1 - frac) + gr.z[edges[:, 1:2]] * frac).ravel()
    # edge k owns node ids gr.nnods + k*npoints + (0..npoints-1)
    new_ids = gr.nnods + np.arange(len(edges) * npoints).reshape(len(edges), npoints)

    e2n = [list(nodes) for nodes in gr.e2n]
    for k in range(len(pairs)):
        e2n[owners[k]].extend(int(v) for v in new_ids[inverse[k]])
    e2n = [np.asarray(n, dtype=np.int64) for n in e2n]

    theta, r = cartesian2polar(mid_x, mid_z)
    return Grid2D(
        x=np.concatenate([gr.x, mid_x]),
        z=np.concatenate([gr.z, mid_z]),
        theta=np.concatenate([gr.theta, theta]),
        r=np.concatenate([gr.r, r]),
        e2n=e2n, ntheta=gr.ntheta, nr=gr.nr, nel=gr.nel,
        nnods=gr.nnods + len(edges) * npoints,
        neighbours=gr.neighbours, is_quad=gr.is_quad,
    )
