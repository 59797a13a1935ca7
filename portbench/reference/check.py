"""The comparison that decides `correct`.

The one number is a widest gap in seconds against the reference's exact
float64 field T (the reference's node order and ids):

- `time_gap_s`: the largest |t - T| over every entry of a table.

A program's outputs are first put into the reference's node order by
`node_map`, which matches nodes by coordinates (and twin class, which
tells coincident twins apart) and fails unless the match is one to one
within `MATCH_KM`.
"""
from __future__ import annotations

import numpy as np

MATCH_KM = 1e-6
BIG = float(np.finfo(np.float64).max)   # +inf, written as a JSON number


def node_map(ref, xyz: np.ndarray, cls: np.ndarray):
    """(m, worst): m[i] = the reference id of the program's node i, and
    the largest distance of a match in km (+inf unless the nodes match
    one to one within MATCH_KM)."""
    rxyz, rcls = ref.node_keys()
    xyz = np.asarray(xyz, np.float64)
    if (xyz.shape == rxyz.shape and np.array_equal(cls, rcls)
            and np.abs(xyz - rxyz).max() <= MATCH_KM):
        return np.arange(len(xyz)), float(np.abs(xyz - rxyz).max())
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(rxyz).query(xyz, k=2)
    first = rcls[idx[:, 0]] == cls
    m = np.where(first, idx[:, 0], idx[:, 1])
    d = np.where(first, dist[:, 0], dist[:, 1])
    ok = (len(xyz) == len(rxyz) and len(np.unique(m)) == len(m)
          and np.array_equal(rcls[m], cls) and d.max() <= MATCH_KM)
    return m, (float(d.max()) if ok else np.inf)


def _finite_max(a) -> float:
    a = np.asarray(a, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.max(np.where(np.isfinite(a), a, np.inf)))


def time_gap(t, T) -> float:
    return _finite_max(np.abs(np.asarray(t, np.float64) - T))


def table_numbers(T_rows, table, stations) -> dict:
    """The number of a table answer: T_rows (S, n) for its sources."""
    return {"time_gap_s": time_gap(table, T_rows[:, stations])}


def json_number(v: float) -> float:
    return v if np.isfinite(v) else BIG
