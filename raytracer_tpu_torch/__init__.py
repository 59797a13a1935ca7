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
(`solve3d_reflection`, `solve3d_converted`) on it; and the generic-graph
solvers of any mesh (the Delaunay mesher `triangle_annulus_2d`,
`add_midpoints`): the reference's headline Bellman-Ford-Moore `bfm` on a
padded ELL graph (kernel `csrc/ell_bfm.cu`), the RCM-banded solver
(`prepare_banded`, `solve_banded`, `solve_banded_gs`; kernels
`csrc/banded.cu`), the host Dijkstra gold standard and radius stepping;
and the staged solvers: the reference's multi-stage and multiphase
sweeps (`bfm_ms`, `bfm_multiphase`) on the level-masked ELL step, the
staged stream engine and the staged directional sweep, and the named
phases (`phase_travel_times`: PcP, SKS, PP, pP/sP and the rest) over
the radial partition (`partition_grid`, `level_mask`); and the paths,
bending refinement and sensitivity kernels: `backtrace_paths` and the
tomography matrix `sensitivity_matrix` / `sensitivity_coo` (kernel
`csrc/paths.cu`), the Adam bend of `refine_paths_batch` / `refine_fan`
(kernel `csrc/bend.cu`), `AnnulusSolver.refined_travel_times`,
`refined_travel_time_table` and `sensitivity_matrix`, and the 3-D
`refine3d_travel_times` and `converted3d_refined`; and event location
and amplitudes: the 2-D and 3-D locators (`locate`, `locate_phases`,
`locate_many`, `locate_dd`, `locate3d`, `locate3d_phases`,
`locate_many3d`) whose grid search is the kernel `csrc/gridsearch.cu`,
and host copies of the amplitude models (t*, spreading, Zoeppritz
coefficients, the flattened radial model, IASP91, the element
interpolation).
Entry points run on the card unless the caller passes `device="cpu"`.
"""
from .config import DEFAULT_SOLVER_CONFIG, R, SolverConfig
from .models.amplitude import (ak135_spreading, amplitude_factor,
                               attenuation_factor, geometrical_spreading,
                               tstar)
from .models.annulus import Grid2D, closest_point, init_annulus, node_adjacency
from .models.delaunay import (add_midpoints, structured_convex_hull,
                              triangle_annulus_2d,
                              unstructured_constrained_domain)
from .models.fast_annulus import init_annulus_circulant
from .models.flatearth import (RadialModel, cmb_radius,
                               depth_from_depth_phase,
                               depth_phase_first_arrival)
from .models.grid3d import (Grid3D, closest_point3d, grid3d,
                            nodal_incidence3d, velocity3d)
from .models.iasp91 import generate_iasp91_table, iasp91_velocity
from .models.interpolation import (barycentric_coordinates, bilinear,
                                   interpolate_elementwise)
from .models.partition import (GridPartition, find_layer_number,
                               level_mask, partition_grid)
from .models.velocity import (LinearInterpolation, dual_velocity,
                              interpolate_velocity, table_interface_radii,
                              velocity_profile)
from .models.zoeppritz import (Medium, energy_coefficients,
                               free_surface_receiver, interface_media,
                               pcp_p_amplitude_ratio, prem_density,
                               scattering)
from .ops.banded import (BandedGraph, prepare_banded, solve_banded,
                        solve_banded_gs)
from .ops.circulant import (CirculantGraph, PrevRecovery, build_circulant,
                            recover_prev)
from .ops.graph import ELLGraph, csr_to_ell
from .ops.relax import DeviceGraph
from .solvers.api import AnnulusSolver
from .solvers.bfm import (bfm, bfm3d, bfm_gpu, bfm_tpu, prepare, solve,
                          solve_many)
from .solvers.dijkstra import dijkstra, weight_matrix, weights
from .solvers.locate import (Location, Location3D, locate, locate3d,
                             locate3d_phases, locate_dd, locate_many,
                             locate_many3d, locate_phases, station_fields,
                             station_fields3d)
from .solvers.multiphase import (bfm_ms, bfm_multiphase, boundary_velocity,
                                 directions)
from .solvers.phases import (depth_phase_travel_times, phase_travel_times,
                             reflected_travel_times)
from .solvers.path import (backtrace_paths, ray_parameters,
                           reconstruct_path, recontruct_path, takeoff_angle)
from .solvers.refine import (refine_fan, refine_path, refine_paths_batch,
                             refraction_inits, resample_path)
from .solvers.sensitivity import (path_sensitivity, path_sensitivity_dual,
                                  sensitivity_coo, sensitivity_matrix)
from .solvers.solve3d import (converted3d_refined, mask_region3d,
                              prepare3d, recover_prev3d,
                              refine3d_travel_times, solve3d,
                              solve3d_converted, solve3d_reflection)
from .solvers.radius_stepping import radius_stepping
from .solvers.types import BellmanFordMoore, Dijkstra, RadiusStepping
from .utils.io import save_solution_npz, travel_times

__all__ = [
    "DEFAULT_SOLVER_CONFIG", "R", "SolverConfig",
    "Grid2D", "closest_point", "init_annulus", "init_annulus_circulant",
    "node_adjacency", "add_midpoints", "triangle_annulus_2d",
    "structured_convex_hull", "unstructured_constrained_domain",
    "Grid3D", "closest_point3d", "grid3d", "velocity3d", "nodal_incidence3d",
    "prepare3d", "solve3d", "recover_prev3d", "mask_region3d",
    "solve3d_reflection", "solve3d_converted",
    "LinearInterpolation", "interpolate_velocity", "table_interface_radii",
    "velocity_profile", "dual_velocity",
    "GridPartition", "find_layer_number", "level_mask", "partition_grid",
    "bfm_ms", "bfm_multiphase", "boundary_velocity", "directions",
    "phase_travel_times", "depth_phase_travel_times",
    "reflected_travel_times",
    "CirculantGraph", "build_circulant", "PrevRecovery", "recover_prev",
    "ELLGraph", "csr_to_ell", "DeviceGraph",
    "BandedGraph", "prepare_banded", "solve_banded", "solve_banded_gs",
    "bfm", "bfm_gpu", "bfm_tpu", "bfm3d", "prepare", "solve", "solve_many",
    "dijkstra", "weight_matrix", "weights", "radius_stepping",
    "AnnulusSolver", "recontruct_path", "BellmanFordMoore", "Dijkstra",
    "RadiusStepping",
    "backtrace_paths", "ray_parameters", "reconstruct_path",
    "takeoff_angle",
    "refine_fan", "refine_path", "refine_paths_batch", "refraction_inits",
    "resample_path",
    "path_sensitivity", "path_sensitivity_dual", "sensitivity_coo",
    "sensitivity_matrix",
    "refine3d_travel_times", "converted3d_refined",
    "tstar", "attenuation_factor", "geometrical_spreading",
    "ak135_spreading", "amplitude_factor",
    "RadialModel", "cmb_radius", "depth_phase_first_arrival",
    "depth_from_depth_phase",
    "iasp91_velocity", "generate_iasp91_table",
    "Medium", "scattering", "energy_coefficients", "free_surface_receiver",
    "interface_media", "prem_density", "pcp_p_amplitude_ratio",
    "bilinear", "barycentric_coordinates", "interpolate_elementwise",
    "Location", "Location3D", "locate", "locate3d", "locate_dd",
    "locate_many", "locate_many3d", "locate_phases", "locate3d_phases",
    "station_fields", "station_fields3d",
    "save_solution_npz", "travel_times",
]
