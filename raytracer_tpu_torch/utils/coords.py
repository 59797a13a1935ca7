"""Coordinate transforms (2-D polar)."""
from __future__ import annotations

import numpy as np


def polar2cartesian(theta, r):
    """(theta, r) -> (x, z) with x = r sin(theta), z = r cos(theta)."""
    return r * np.sin(theta), r * np.cos(theta)
