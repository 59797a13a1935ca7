"""Element-wise interpolation of nodal fields onto secondary nodes.

Host-side NumPy, a copy of `raytracer_tpu/models/interpolation.py` (the port
imports nothing of the JAX package); `tests/test_torch_amplitude.py`
holds it equal to the original.

Equivalent of src/Interpolations/ (interpolation.jl, bilinear.jl,
barycentric.jl): bilinear interpolation inside quads (with the 2-pi wrap
fix) and barycentric inside triangles, both vectorised over elements.
The reference uses this to interpolate primary-vertex velocities onto the
secondary nodes (benchmarks/gpu.jl:58) as an alternative to sampling the
radial profile directly.
"""
from __future__ import annotations

import numpy as np


def bilinear(theta_v, r_v, theta_p, r_p, values):
    """Bilinear interpolation in (theta, r) inside a quad.

    theta_v, r_v : (..., 4) vertex coords in reference order
                   [bottom-left, bottom-right, top-right, top-left]
    theta_p, r_p : (...) interpolation points
    values       : (..., 4) vertex values
    Matches src/Interpolations/bilinear.jl:1-17 including the seam fix
    (x2 - x1 > pi  =>  x1 += 2*pi).
    """
    z1, z2 = r_v[..., 0], r_v[..., 3]
    x1, x2 = theta_v[..., 0].copy(), theta_v[..., 1]
    wrap = (x2 - x1) > np.pi
    x1 = np.where(wrap, x1 + 2 * np.pi, x1)
    dx21 = x2 - x1
    dz21 = z2 - z1
    dx2 = x2 - theta_p
    dx1 = theta_p - x1
    dz2 = z2 - r_p
    dz1 = r_p - z1
    return (
        values[..., 0] * dx2 * dz2
        + values[..., 1] * dx1 * dz2
        + values[..., 3] * dx2 * dz1
        + values[..., 2] * dx1 * dz1
    ) / (dx21 * dz21)


def barycentric_coordinates(xv, zv, xp, zp):
    """Barycentric coords of points inside triangles
    (src/Interpolations/barycentric.jl:1-15); all args broadcastable,
    xv/zv have a trailing axis of 3."""
    x1, x2, x3 = xv[..., 0], xv[..., 1], xv[..., 2]
    z1, z2, z3 = zv[..., 0], zv[..., 1], zv[..., 2]
    det = (z2 - z3) * (x1 - x3) + (x3 - x2) * (z1 - z3)
    N1 = ((z2 - z3) * (xp - x3) + (x3 - x2) * (zp - z3)) / det
    N2 = ((z3 - z1) * (xp - x3) + (x1 - x3) * (zp - z3)) / det
    return N1, N2, 1.0 - N1 - N2


def interpolate_elementwise(V: np.ndarray, gr) -> np.ndarray:
    """Interpolate primary-vertex values of V onto every secondary node.

    Equivalent of `interpolate!` (src/Interpolations/interpolation.jl:5-18):
    quads use bilinear in (theta, r), triangles barycentric in (x, z).
    Returns a copy of V with the secondary entries replaced.
    """
    V = np.asarray(V, dtype=np.float64).copy()
    for e in range(gr.nel):
        nodes = gr.e2n[e]
        if gr.is_quad[e]:
            if len(nodes) <= 4:
                continue
            verts, rest = nodes[:4], nodes[4:]
            V[rest] = bilinear(
                gr.theta[verts][None, :],
                gr.r[verts][None, :],
                gr.theta[rest],
                gr.r[rest],
                V[verts][None, :],
            )
        else:
            if len(nodes) <= 3:
                continue
            verts, rest = nodes[:3], nodes[3:]
            N1, N2, N3 = barycentric_coordinates(
                gr.x[verts][None, :], gr.z[verts][None, :], gr.x[rest], gr.z[rest]
            )
            V[rest] = N1 * V[verts[0]] + N2 * V[verts[1]] + N3 * V[verts[2]]
    return V
