"""Sharded bending refinement: the bend stage of the refined table over
a mesh.

Counterpart of `raytracer_tpu/parallel/refine_shard.py`.  The Adam bend
(solvers/refine.py) is independent for every path, so the fan is split
across the mesh's ranks with no collective inside the bend: the paths
are padded to a multiple of the mesh size (the last one repeated), each
rank bends its block with `refine_paths_batch` (the `bend` kernel on the
card, its plain twin on the CPU), and one `all_gather` gives every rank
the whole fan, the padding rows dropped.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..solvers.refine import refine_paths_batch
from .mesh import SOURCE_AXIS, Mesh, all_gather, make_mesh, source_sharding


def refine_paths_sharded(paths: Sequence[np.ndarray], profile_r, profile_v,
                         mesh: Optional[Mesh] = None, m: int = 128,
                         iters: int = 800, lr: float = 3.0, quad: int = 8,
                         device=None):
    """(points, times) like solvers/refine.refine_paths_batch (float64),
    with the path fan split over `mesh`'s ranks; every rank of the mesh
    calls it and gets the whole fan.  `device` is the default mesh's."""
    mesh = mesh if mesh is not None else make_mesh(device=device)
    mesh.require_member()
    paths = list(paths)
    B0 = len(paths)
    paths += [paths[-1]] * ((-B0) % mesh.size)
    mine = source_sharding(mesh).local(paths)
    P, t = refine_paths_batch(mine, profile_r, profile_v, m=m, iters=iters,
                              lr=lr, quad=quad, device=mesh.device)
    P = all_gather(torch.from_numpy(P).to(mesh.device), mesh, SOURCE_AXIS)
    t = all_gather(torch.from_numpy(t).to(mesh.device), mesh, SOURCE_AXIS)
    return P.cpu().numpy()[:B0], t.cpu().numpy()[:B0]
