"""raytracer_tpu_torch - the PyTorch/CUDA port of raytracer_tpu.

A second package beside the JAX one, for an NVIDIA H100.  It imports
torch and never jax or the JAX package.  It carries the main path (the
AK135 annulus from the O(M) circulant builder, the directional-sweep
solver whose radial Gauss-Seidel sweep is the hand-written CUDA kernel
`csrc/rsweep.cu`, the predecessor tree, ray paths and the travel-time
CSV), the Jacobi engines 'twrapped' (kernel `csrc/titer.cu`), 'stream'
(kernel `csrc/band.cu`), 'wrapped' (kernel `csrc/witer.cu`) and 'diag'
(kernel `csrc/diag.cu`), the quarantined engines 'pallas' (kernel
`csrc/relax.cu`) and 'fused' (kernel `csrc/fused.cu`), and the plain
'circulant' oracle; and the 3-D
spherical-shell solve (`grid3d` -> `prepare3d` -> `solve3d` ->
`recover_prev3d`) whose kernel engine is `csrc/sweep3d.cu` and whose
directional-sweep engine is `csrc/plane3d.cu`, with the staged 3-D solves
(`solve3d_reflection`, `solve3d_converted`) on it.
Entry points run on the card unless the caller passes `device="cpu"`.
"""
from .config import DEFAULT_SOLVER_CONFIG, R, SolverConfig
from .models.annulus import Grid2D, closest_point, init_annulus
from .models.fast_annulus import init_annulus_circulant
from .models.grid3d import Grid3D, closest_point3d, grid3d, velocity3d
from .models.velocity import (LinearInterpolation, interpolate_velocity,
                              table_interface_radii, velocity_profile)
from .ops.circulant import CirculantGraph, build_circulant
from .solvers.api import AnnulusSolver
from .solvers.path import recontruct_path
from .solvers.solve3d import (mask_region3d, prepare3d, recover_prev3d,
                              solve3d, solve3d_converted, solve3d_reflection)
from .solvers.types import BellmanFordMoore
from .utils.io import save_solution_npz, travel_times

__all__ = [
    "DEFAULT_SOLVER_CONFIG", "R", "SolverConfig",
    "Grid2D", "closest_point", "init_annulus", "init_annulus_circulant",
    "Grid3D", "closest_point3d", "grid3d", "velocity3d",
    "prepare3d", "solve3d", "recover_prev3d", "mask_region3d",
    "solve3d_reflection", "solve3d_converted",
    "LinearInterpolation", "interpolate_velocity", "table_interface_radii",
    "velocity_profile",
    "CirculantGraph", "build_circulant",
    "AnnulusSolver", "recontruct_path", "BellmanFordMoore",
    "save_solution_npz", "travel_times",
]
