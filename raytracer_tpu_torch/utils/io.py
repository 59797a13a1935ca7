"""Result export: travel-time CSV and npz archive."""
from __future__ import annotations

import csv
from typing import Optional, Sequence

import numpy as np


def travel_times(D, gr, receivers: Sequence[int], isave: bool = False, flname: str = "") -> np.ndarray:
    """Travel times at receiver nodes; optional CSV `degree,travel_time`."""
    receivers = np.asarray(receivers)
    tt = np.asarray(D.dist)[receivers]
    if isave:
        deg = np.rad2deg(np.asarray(gr.theta)[receivers])
        with open(flname, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["degree", "travel_time"])
            for d, t in zip(deg, tt):
                wr.writerow([d, t])
    return tt


def save_solution_npz(path: str, D, gr, source: int, paths: Optional[Sequence[np.ndarray]] = None) -> None:
    """Archive grid coords, travel-time field and ray paths as npz."""
    arrays = {
        "x": np.asarray(gr.x),
        "z": np.asarray(gr.z),
        "theta": np.asarray(gr.theta),
        "r": np.asarray(gr.r),
        "dist": np.asarray(D.dist),
        "prev": np.asarray(D.prev),
        "source": np.asarray(source),
    }
    if paths is not None:
        for i, p in enumerate(paths):
            arrays[f"path_{i}"] = np.asarray(p)
    np.savez_compressed(path, **arrays)
