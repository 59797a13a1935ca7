"""Result export: travel-time CSV and npz archive.

Both take a result whose `dist` is a host array or a tensor on any
device (a `solve(device_dist=True)` result holds it on the card) and
copy it to the host before NumPy reads it.
"""
from __future__ import annotations

import csv
from typing import Optional, Sequence

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A host array from a NumPy array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def travel_times(D, gr, receivers: Sequence[int], isave: bool = False, flname: str = "") -> np.ndarray:
    """Travel times at receiver nodes; optional CSV `degree,travel_time`."""
    receivers = np.asarray(receivers)
    tt = _host(D.dist)[receivers]
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
        "dist": _host(D.dist),
        "prev": _host(D.prev),
        "source": np.asarray(source),
    }
    if paths is not None:
        for i, p in enumerate(paths):
            arrays[f"path_{i}"] = np.asarray(p)
    np.savez_compressed(path, **arrays)
