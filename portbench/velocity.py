"""The reference's velocity model: the AK135 Vp column of RayTracer.jl's
1-km table (`data/ak135_depth_vp_vs.txt`, rows `depth Vp Vs`), sampled
by linear interpolation in radius.  The program builds its velocities
with its own `models/velocity`, so the comparison checks its sampling
too.

`node_velocity(r, cfg)` is the one sampler: a node lying exactly on one of
the configuration's discontinuity radii takes the velocity
`discontinuity_buffer_km` above it, as the upstream's `main_annulus.jl`
samples; a configuration without that key samples plainly.
"""
from __future__ import annotations

import functools
import os

import numpy as np

_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "ak135_depth_vp_vs.txt")
_COLUMNS = {"Vp": 1, "Vs": 2}


@functools.lru_cache(maxsize=None)
def radial_table(wave: str = "Vp"):
    """(radius ascending, velocity) in km and km/s."""
    t = np.loadtxt(_TABLE)
    r = t[:, 0].max() - t[:, 0]
    return r[::-1].copy(), t[::-1, _COLUMNS[wave]].copy()


def node_velocity(r, cfg: dict) -> np.ndarray:
    """Velocity (km/s, float64) at node radii `r` under configuration
    `cfg` (its `velocity` group)."""
    v = cfg["velocity"]
    tr, tv = radial_table(v["wave"])
    r = np.asarray(r, np.float64)
    out = np.interp(r, tr, tv)
    buf = v.get("discontinuity_buffer_km")
    if buf is not None:
        on = np.zeros(r.shape, bool)
        for d in cfg["discontinuity_depths_km"]:
            on |= r == cfg["R_km"] - d
        if on.any():
            out = np.where(on, np.interp(r + buf, tr, tv), out)
    return out
