"""Coordinate transforms (2-D polar, 3-D spherical)."""
from __future__ import annotations

import numpy as np


def polar2cartesian(theta, r):
    """(theta, r) -> (x, z) with x = r sin(theta), z = r cos(theta)."""
    return r * np.sin(theta), r * np.cos(theta)


def cartesian2polar(x, z):
    """(x, z) -> (theta, r), theta in [0, 2pi)."""
    theta = np.arctan2(x, z)
    theta = np.where(theta < 0, theta + 2 * np.pi, theta)
    return theta, np.sqrt(x * x + z * z)


def spherical2cart(theta, phi, r):
    """Spherical -> cartesian, theta the colatitude, phi the longitude."""
    x = r * np.cos(phi) * np.sin(theta)
    y = r * np.sin(phi) * np.sin(theta)
    z = r * np.cos(theta)
    return x, y, z
