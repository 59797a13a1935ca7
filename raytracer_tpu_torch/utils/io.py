"""Result export: travel-time CSV, npz archive and MAT file.

A copy of `raytracer_tpu/utils/io.py`.  The writers take a result whose
`dist` is a host array or a tensor on any device (a
`solve(device_dist=True)` result holds it on the card) and copy it to
the host before NumPy reads it.
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


def load_solution_npz(path: str):
    """Load an archive written by save_solution_npz (by either package).

    Returns (data dict, prev, dist, source, paths list).
    """
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    keys = sorted(
        (k for k in data if k.startswith("path_")), key=lambda k: int(k.split("_")[1])
    )
    paths = [data[k] for k in keys]
    return data, data["prev"], data["dist"], int(data["source"]), paths


def save_matfile(path: str, D, gr, paths: Optional[Sequence[np.ndarray]] = None) -> None:
    """MATLAB-compatible export via scipy.io (the reference's
    main_annulus.jl:6-32)."""
    from scipy.io import savemat

    data = {
        "x": np.asarray(gr.x),
        "z": np.asarray(gr.z),
        "theta": np.asarray(gr.theta),
        "r": np.asarray(gr.r),
    }
    if paths is not None:
        dist = _host(D.dist)
        for i, p in enumerate(paths):
            p = np.asarray(p)
            data[f"x_path{i + 1}"] = np.asarray(gr.x)[p]
            data[f"z_path{i + 1}"] = np.asarray(gr.z)[p]
            data[f"travel_time_path{i + 1}"] = dist[p]
    savemat(path, data)
