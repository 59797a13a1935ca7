"""Radial Earth velocity models (AK135 / IASP91 Vp/Vs tables).

Host-side NumPy, a copy of the parts of `raytracer_tpu/models/velocity.py`
the port needs.  The `depth Vp Vs` tables are the JAX package's, copied
byte for byte under `raytracer_tpu_torch/data/`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np

from ..config import DISCONTINUITY_RADII, VELOCITY_BUFFER
from ..utils import profiling

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

_PROFILE_FILES = {
    # the reference's two tables (both IASP91-generated) and the genuine
    # AK135 .tvel knots (Kennett, Engdahl & Buland 1995)
    "ak135": "R_Vp_Vs_AK135.txt",
    "iasp91": "R_Vp_Vs_IASP91.txt",
    "ak135-true": "AK135_tvel_Kennett1995.txt",
}


@dataclasses.dataclass(frozen=True)
class VelProfile:
    """Radial profile: radius (km, ascending), Vp and Vs (km/s)."""

    r: np.ndarray
    Vp: np.ndarray
    Vs: np.ndarray


@profiling.setup_span("build.velocity")
def velocity_profile(model: str = "ak135") -> VelProfile:
    """Load a radial Earth model table and convert depth -> radius.

    The table is `depth Vp Vs` with 1-km sampling; radius = max(depth) -
    depth, rows reversed so radius is ascending.
    """
    try:
        fname = _PROFILE_FILES[model.lower()]
    except KeyError:
        raise ValueError(f"unknown velocity model {model!r}; expected one of {sorted(_PROFILE_FILES)}")
    table = np.loadtxt(os.path.join(_DATA_DIR, fname))
    depth = table[:, 0]
    r = depth.max() - depth
    return VelProfile(r=r[::-1].copy(), Vp=table[::-1, 1].copy(), Vs=table[::-1, 2].copy())


def table_interface_radii(model: str = "ak135", min_jump: float = 0.3,
                          wave: str = "Vp") -> tuple:
    """Radii (km) where the vendored 1-km table actually jumps: the
    midpoints of adjacent-row velocity steps larger than `min_jump` km/s,
    outermost first.  These are the tables' (IASP91) interfaces, not
    config.DISCONTINUITY_RADII (the reference's hardcoded list, whose CMB
    constant sits 2.5 km below the table's transition); the
    discontinuity-aware 3-D grid (grid3d force_radii) uses these."""
    prof = velocity_profile(model)
    v = getattr(prof, wave if wave in ("Vp", "Vs") else "Vp")
    jump = np.abs(np.diff(v)) > min_jump
    mids = 0.5 * (prof.r[:-1] + prof.r[1:])[jump]
    return tuple(float(m) for m in mids[::-1])   # outermost first


class LinearInterpolation:
    """1-D linear interpolant over (x, y) with clamped extrapolation."""

    def __init__(self, x, y):
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        if self.x.ndim != 1 or self.x.shape != self.y.shape:
            raise ValueError("LinearInterpolation expects 1-D x and y of equal length")

    def __call__(self, r):
        return np.interp(r, self.x, self.y)


@profiling.setup_span("build.velocity")
def interpolate_velocity(r: np.ndarray, interpolant: Callable, buffer: float = VELOCITY_BUFFER) -> np.ndarray:
    """Sample a radial velocity interpolant onto grid nodes.

    Nodes lying exactly on a discontinuity take the velocity just *above*
    (r + buffer).
    """
    r = np.asarray(r)
    V = interpolant(r)
    on_disc = np.zeros(r.shape, dtype=bool)
    for rad in DISCONTINUITY_RADII:
        on_disc |= r == rad
    if on_disc.any():
        V = np.where(on_disc, interpolant(r + buffer), V)
    return V


def dual_velocity(r: np.ndarray, interpolant: Callable, buffer: float = VELOCITY_BUFFER) -> np.ndarray:
    """(n, 2) velocity: column 0 = below (r - buffer), column 1 = above.

    Away from discontinuities both columns are equal (src/ShortestPath.jl:97-112).
    """
    r = np.asarray(r)
    V = interpolant(r)
    below = V.copy()
    above = V.copy()
    on_disc = np.zeros(r.shape, dtype=bool)
    for rad in DISCONTINUITY_RADII:
        on_disc |= r == rad
    if on_disc.any():
        below = np.where(on_disc, interpolant(r - buffer), below)
        above = np.where(on_disc, interpolant(r + buffer), above)
    return np.stack([below, above], axis=1)
