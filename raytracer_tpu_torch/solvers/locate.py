"""Event location helpers of the PyTorch port.

Counterpart of `raytracer_tpu/solvers/locate.py`.  This slice carries
only `_radial_profile`, the radial table the bending refinement of
`AnnulusSolver.refined_travel_times` and `refined_travel_time_table`
reads; the locators follow with ROADMAP A.9b.
"""
from __future__ import annotations

import numpy as np


def _radial_profile(profile, r, U):
    """(radii, velocities) for the continuous bending functional: the
    explicit table when given, else the grid's own sampled velocities
    (dual columns averaged) - the convention of
    `AnnulusSolver.refined_travel_times`."""
    if profile is not None:
        return tuple(np.asarray(a, np.float64) for a in profile)
    order = np.argsort(np.asarray(r), kind="stable")
    rs = np.asarray(r)[order]
    vs = np.asarray(U, np.float64)[order]
    if vs.ndim == 2:
        vs = vs.mean(axis=1)
    return rs, vs
