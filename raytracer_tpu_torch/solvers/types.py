"""SSSP result containers: predecessor ids and travel times."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BellmanFordMoore(NamedTuple):
    prev: np.ndarray
    dist: np.ndarray


class Dijkstra(NamedTuple):
    prev: np.ndarray
    dist: np.ndarray


class RadiusStepping(NamedTuple):
    prev: np.ndarray
    dist: np.ndarray
