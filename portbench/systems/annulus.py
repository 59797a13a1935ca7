"""The program under test on an annulus configuration: the port's
velocity model, `init_annulus_circulant` and `AnnulusSolver`, called as a
user calls them (the main path of `raytracer_tpu_torch.main_annulus`)."""
from __future__ import annotations

import numpy as np


class System:
    def __init__(self, cfg: dict, mix: dict, device, rec):
        from raytracer_tpu_torch.config import SolverConfig
        from raytracer_tpu_torch.models.fast_annulus import \
            init_annulus_circulant
        from raytracer_tpu_torch.models.velocity import (
            LinearInterpolation, interpolate_velocity, velocity_profile)
        from raytracer_tpu_torch.solvers.api import AnnulusSolver

        self.mix = mix
        v = cfg["velocity"]
        prof = velocity_profile(v["model"])
        interp = LinearInterpolation(prof.r, getattr(prof, v["wave"]))
        gr, cg, U = init_annulus_circulant(
            cfg["ntheta"], cfg["nr"], spacing=cfg["spacing_km"],
            star=cfg["star"],
            velocity=lambda rr: interpolate_velocity(rr, interp),
            dtype=cfg["dtype"])
        self.solver = AnnulusSolver(
            gr, None, None, U, SolverConfig(dtype=cfg["dtype"]),
            method=cfg["method"], circulant=cg, device=device)
        self.R = cfg["R_km"]
        self.x, self.z = np.asarray(gr.x), np.asarray(gr.z)
        self.cls = np.asarray(gr.twin_class)
        r = np.hypot(self.x, self.z)
        self.surface = np.flatnonzero(np.abs(r - self.R) < 1e-6)
        self._tree = None

    def node_keys(self):
        return np.stack([self.x, self.z], axis=1), self.cls

    def event_nodes(self, theta_deg, depth_km):
        """The node nearest each position (theta from the z axis)."""
        from scipy.spatial import cKDTree

        if self._tree is None:
            self._tree = cKDTree(np.stack([self.x, self.z], axis=1))
        th = np.deg2rad(theta_deg)
        r = self.R - np.asarray(depth_km)
        return self._tree.query(np.stack([r * np.sin(th), r * np.cos(th)],
                                         axis=1))[1].astype(np.int64)

    def surface_nodes(self):
        return self.surface

    def table(self, sources: np.ndarray, stations: np.ndarray, rec):
        """A (sources x stations) first-arrival table as a host array."""
        with rec.span("solve"):
            t = self.solver.travel_time_table(sources, stations,
                                              batch=self.mix["batch"])
        rec.count("solver_iters", self.solver.last_iterations)
        return t
