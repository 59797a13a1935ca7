"""Coordinate transforms and distances (2-D polar, 3-D spherical).

A copy of `raytracer_tpu/utils/coords.py`; every function works on NumPy
arrays and scalars.
"""
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


def distance2d(ax, az, bx, bz):
    """Euclidean distance in the (x, z) plane."""
    return np.sqrt((ax - bx) ** 2 + (az - bz) ** 2)


def polardistance(theta1, theta2, r1, r2):
    """Chord length between two polar points."""
    return np.sqrt(r1 * r1 + r2 * r2 - 2 * r1 * r2 * np.cos(theta1 - theta2))


def arclength(theta1, theta2, r):
    """Arc length along a circle of radius r."""
    return r * np.abs(theta2 - theta1)


def spherical2cart(theta, phi, r):
    """Spherical -> cartesian, theta the colatitude, phi the longitude."""
    x = r * np.cos(phi) * np.sin(theta)
    y = r * np.sin(phi) * np.sin(theta)
    z = r * np.cos(theta)
    return x, y, z


def distance3d(ax, ay, az, bx, by, bz):
    """Euclidean distance in 3-D."""
    return np.sqrt((ax - bx) ** 2 + (ay - by) ** 2 + (az - bz) ** 2)
