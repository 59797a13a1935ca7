"""Coordinate transforms (2-D polar, 3-D spherical)."""
from __future__ import annotations

import numpy as np


def polar2cartesian(theta, r):
    """(theta, r) -> (x, z) with x = r sin(theta), z = r cos(theta)."""
    return r * np.sin(theta), r * np.cos(theta)


def spherical2cart(theta, phi, r):
    """Spherical -> cartesian, theta the colatitude, phi the longitude."""
    x = r * np.cos(phi) * np.sin(theta)
    y = r * np.sin(phi) * np.sin(theta)
    z = r * np.cos(theta)
    return x, y, z
