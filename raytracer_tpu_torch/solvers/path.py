"""Ray-path reconstruction by predecessor backtrace.

The host walk `recontruct_path` keeps the reference API's spelling
(`reconstruct_path` is the alias), `ray_parameters` and `takeoff_angle`
are host NumPy (copies of the JAX package's), and `backtrace_paths` walks
every receiver at once on the device: one launch of the CUDA kernel
`csrc/paths.cu` on the card, a loop of `max_len` gathers (the plain twin,
`ops/paths.walk_reference`) on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.circulant import resolve_device
from ..ops.paths import paths


def recontruct_path(prev, source: int, receiver: int) -> np.ndarray:
    """Walk prev from receiver until the source; returns node ids.

    The name keeps the reference API's spelling.  Guards against cycles
    from unreachable receivers: an unreachable receiver (its predecessor
    is itself) yields the length-1 path [receiver].
    """
    prev = np.asarray(prev)
    if int(prev[receiver]) == int(receiver) and int(receiver) != int(source):
        return np.asarray([int(receiver)], dtype=np.int64)
    path = [int(receiver)]
    ipath = int(prev[receiver])
    while ipath != source and ipath != path[-1] and len(path) <= len(prev):
        path.append(ipath)
        ipath = int(prev[ipath])
    path.append(int(source))
    return np.asarray(path, dtype=np.int64)


# alias with the correct spelling
reconstruct_path = recontruct_path


def ray_parameters(points, profile_r, profile_v) -> np.ndarray:
    """(k-1,) spherical ray parameter p = r sin(theta)/v at the segment
    midpoints of a path polyline (cartesian (k, 2) or (k, 3) points,
    theta the angle between the segment and the local radial).

    In a radially stratified model p is CONSTANT along a true ray
    (Benndorf's relation / spherical Snell's law), and equals dt/dDelta
    of the arrival, so the spread of this array measures how far a
    (graph or bent) path is from ray-theoretic.
    Using |mid x seg| = r |seg| sin(theta), p = |mid x seg|/(|seg| v(r)).
    """
    pts = np.asarray(points, np.float64)
    if pts.shape[0] < 2:
        return np.zeros(0)
    a, b = pts[:-1], pts[1:]
    mid, seg = 0.5 * (a + b), b - a
    if pts.shape[1] == 2:
        cross = np.abs(mid[:, 0] * seg[:, 1] - mid[:, 1] * seg[:, 0])
    else:
        cross = np.linalg.norm(np.cross(mid, seg), axis=1)
    r_mid = np.linalg.norm(mid, axis=1)
    v = np.interp(r_mid, np.asarray(profile_r, np.float64),
                  np.asarray(profile_v, np.float64))
    L = np.linalg.norm(seg, axis=1)
    return cross / np.maximum(L * v, 1e-12)


def takeoff_angle(points) -> float:
    """Angle (degrees) between the path's leaving direction at its FIRST
    point and the local upward radial: 0 = straight up, 90 = horizontal,
    180 = straight down.  Pass the polyline receiver-first for the
    incidence angle, source-first (reversed) for the take-off angle."""
    pts = np.asarray(points, np.float64)
    if pts.shape[0] < 2:
        return float("nan")
    d = pts[1] - pts[0]
    rhat = pts[0] / max(np.linalg.norm(pts[0]), 1e-12)
    c = float(np.dot(d, rhat) / max(np.linalg.norm(d), 1e-12))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _int32_on(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a,
                                      dtype=np.int32), device=dev)


def backtrace_paths(prev, source, receivers, max_len: int,
                    device="cuda") -> torch.Tensor:
    """Device backtrace: (n_receivers, max_len) int32 node-id matrix on
    `device`.

    Entries after the source are padded with the source id; the rows are
    walked in parallel for a fixed depth (the JAX package's scan).  On
    the card one launch of `csrc/paths.cu` (a thread a receiver); on the
    CPU the plain twin."""
    dev = resolve_device(device)
    return paths(_int32_on(prev, dev), int(source),
                 _int32_on(receivers, dev).reshape(-1),
                 int(max_len)).nodes
