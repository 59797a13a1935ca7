"""The reference of the annulus configurations: the upstream graph built
again (`annulus_mesh`), its edge weights 2 L / (U_a + U_b) in float64 from
the upstream's 1-km AK135 table as `velocity.node_velocity` samples it
(the program samples its own copy with its own code), the halo's twin
links at zero cost, and exact shortest paths (`sssp`)."""
from __future__ import annotations

import numpy as np
import torch

from ..velocity import node_velocity
from . import sssp
from .annulus_mesh import build_annulus


class Reference:
    def __init__(self, cfg: dict, device):
        m = build_annulus(cfg["ntheta"], cfg["nr"], cfg["spacing_km"],
                          cfg["R_km"], cfg["r_inner_km"],
                          cfg["discontinuity_depths_km"],
                          cfg["twin_offset_km"])
        self.device = torch.device(device)
        self.mesh = m
        self.n = len(m.x)
        U = node_velocity(m.r, cfg)
        n = self.n
        # A's edges in CSR order (destination, then source ascending) and
        # the halo's pairs (not edges of A) inserted at their places
        dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(m.A.indptr))
        src = m.A.indices.astype(np.int64)
        L = np.hypot(m.x[dst] - m.x[src], m.z[dst] - m.z[src])
        us = U[dst] + U[src]
        w = np.where(us > 0, 2.0 * L / np.where(us > 0, us, 1.0), np.inf)
        key = dst * n + src
        hkey = np.sort(m.halo[:, 1] * n + m.halo[:, 0])
        at = np.searchsorted(key, hkey)
        self._key = np.insert(key, at, hkey)
        self._w = np.insert(w, at, 0.0)
        self._graphs: dict = {}

    def problem_size(self):
        """(nodes, directed edges) of the graph, halo links included."""
        return self.n, len(self._key)

    def graph(self, dtype=torch.float64) -> sssp.EllGraph:
        if dtype not in self._graphs:
            indptr = np.zeros(self.n + 1, np.int64)
            np.cumsum(np.bincount(self._key // self.n, minlength=self.n),
                      out=indptr[1:])
            self._graphs[dtype] = sssp.ell_graph(
                indptr, self._key % self.n, self._w, dtype, self.device)
        return self._graphs[dtype]

    def node_keys(self):
        """Coordinates and twin class, by which a program's node is
        matched to the reference's."""
        m = self.mesh
        return np.stack([m.x, m.z], axis=1), m.twin_class

    def solve(self, sources, dtype=torch.float64):
        return sssp.ell_solve(self.graph(dtype), sources)
