"""Global constants and solver knobs of the PyTorch port.

A copy of `raytracer_tpu/config.py`: the Earth radius, the AK135
discontinuity radii the mesh forces into every column and their node
mask, and `SolverConfig` with the same fields in the same order, the
same defaults and the same `tol_value` rule.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Earth radius in km
R = 6371.0

# Depths (km) of the seismic velocity discontinuities of the AK135 model.
DISCONTINUITY_DEPTHS: Tuple[float, ...] = (20.0, 35.0, 210.0, 410.0, 660.0, 2740.0, 2891.5)

# Radii of the discontinuities (outermost first), exact in float64.
DISCONTINUITY_RADII: Tuple[float, ...] = tuple(R - d for d in DISCONTINUITY_DEPTHS)

# Layer boundary radii including the surface, used by `constrain2layers`.
LAYER_RADII: Tuple[float, ...] = (R,) + DISCONTINUITY_RADII

# Radial offset applied to duplicated (twin) nodes at discontinuities.
TWIN_OFFSET = 0.05

# +-1 km buffer used when sampling velocity right at a discontinuity.
VELOCITY_BUFFER = 1.0

# Inner cut-off radius of the annulus grid.
R_INNER = 0.1


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Runtime knobs of the solvers.

    dtype     : device dtype of distances and weights
    max_iters : hard cap on the number of sweep rounds or iterations
    node_pad  : the ELL layout pads its node count to a multiple of this
                (ops/graph.csr_to_ell), with at least one dummy row
    degree_pad : and its neighbour count (ELL width) to a multiple of this
    tol       : stop once no distance improves by more than `tol`
                seconds; None picks 1e-3 for float32 (one f32 ULP of the
                largest travel times is ~2.4e-4 s) and 0.0 for float64
    band_closure : min-plus band-closure levels of the Jacobi engines'
                stencil ('twrapped', 'stream'): each level squares the
                truncated (dm, dc) band at pack time, so one band sweep
                composes up to 2**levels original hops (exact; see
                ops/wrapped_t.py::_compose_band)
    warm_levels : coarse-to-fine warm-start levels of the 'stream'
                engine (exact; 0 = off, None = the measured policy of
                ops/stream_t.py::auto_warm_levels)
    """

    dtype: str = "float32"
    max_iters: int = 100_000
    node_pad: int = 1024
    degree_pad: int = 8
    tol: float = None
    band_closure: int = 1
    warm_levels: int = None

    def tol_value(self) -> float:
        if self.tol is not None:
            return self.tol
        return 1e-3 if np.dtype(self.dtype) == np.float32 else 0.0


DEFAULT_SOLVER_CONFIG = SolverConfig()


def discontinuity_mask(r: np.ndarray) -> np.ndarray:
    """Boolean mask of nodes lying exactly on one of the 7 discontinuities.

    Exact float equality is intentional: grid construction places boundary
    nodes at exactly these radii.
    """
    mask = np.zeros(r.shape, dtype=bool)
    for rad in DISCONTINUITY_RADII:
        mask |= r == rad
    return mask
