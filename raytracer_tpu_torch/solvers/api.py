"""High-level solver API of the PyTorch port.

`AnnulusSolver` packs the circulant graph once and then serves repeated
solves on one explicit device.  This slice of the port carries the
directional-sweep engine only (the JAX package's auto route on its
accelerator); every other method raises `NotImplementedError` naming the
ROADMAP item that ports it.  Nothing falls back silently: no CPU run
unless the caller asks for `device="cpu"`, no other engine unless the
caller asks for it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.circulant import (CirculantError, CirculantGraph,
                             build_circulant, recover_prev_device)
from ..ops.sweep_theta import resolve_device, solve_circulant_sweep
from ..ops.wrapped_t import pack_twrapped_stencil, supports_twrapped
from .types import BellmanFordMoore

# methods of the JAX package's AnnulusSolver that later slices port
_NOT_PORTED = {
    "twrapped": "ROADMAP A.5 (Jacobi engines; kernel B.2)",
    "stream": "ROADMAP A.5 (Jacobi engines; kernel B.3)",
    "circulant": "ROADMAP A.5 (the plain solve_circulant Jacobi oracle)",
    "ell": "ROADMAP A.6 (generic graphs)",
    "banded": "ROADMAP A.6 (generic graphs)",
    "wrapped": "ROADMAP A.11 (deprecated engines; kernel B.5)",
    "diag": "ROADMAP A.11 (deprecated engines; kernel B.6)",
    "pallas": "ROADMAP A.11 (quarantined engines; kernel B.7)",
    "fused": "ROADMAP A.11 (quarantined engines; kernel B.8)",
}


class AnnulusSolver:
    """One-time graph packing + repeated SSSP solves on `device`.

    method:
      'auto'  -> 'sweep'
      'sweep' -> directional-sweep solver (ops/sweep_theta.py): radial
                 Gauss-Seidel sweeps as a CUDA kernel + hierarchical
                 horizontal closure; converges in ~3-4 ROUNDS
    device: "cuda" (default) or "cpu"; the CPU runs the kernels' plain
    PyTorch versions and is there for tests.
    """

    def __init__(
        self,
        gr,
        A: Optional[sp.csr_matrix],
        halo: Optional[np.ndarray],
        U: np.ndarray,
        config: SolverConfig = DEFAULT_SOLVER_CONFIG,
        method: str = "auto",
        circulant: Optional[CirculantGraph] = None,
        device="cuda",
    ):
        """Pass `circulant=` a prebuilt CirculantGraph (from
        models/fast_annulus.py::init_annulus_circulant) to skip the
        extraction; A and halo may then be None."""
        self.device = resolve_device(device)
        self.gr = gr
        self.U = np.asarray(U)
        self.config = config
        self.last_iterations: Optional[int] = None
        self._device_cache: dict = {}

        was_auto = method == "auto"
        if was_auto:
            method = "sweep"
        if method != "sweep":
            raise NotImplementedError(
                f"method={method!r} is not ported yet: "
                f"{_NOT_PORTED.get(method, 'unknown method')}")
        if circulant is None:
            if A is None:
                raise ValueError("pass A and halo, or a prebuilt circulant")
            try:
                circulant = build_circulant(gr, A, halo, U,
                                            dtype=np.dtype(config.dtype))
            except CirculantError as e:
                raise NotImplementedError(
                    f"circulant layout unavailable ({e}); the 'ell'/"
                    f"'banded' fallback is {_NOT_PORTED['ell']}") from e
        if was_auto and not supports_twrapped(circulant):
            # the JAX package re-routes this wrap structure to the Jacobi
            # chain (twrapped/stream by size)
            raise NotImplementedError(
                f"ntheta={circulant.ntheta} has no sweep support under "
                f"'auto'; its twrapped/stream route is {_NOT_PORTED['twrapped']}")
        self.circulant: CirculantGraph = circulant
        self._method = method
        # the sweep tables are rebuilt from the RAW decomposition: the
        # shared stencil is packed closure-free
        self._sweep_stencil = pack_twrapped_stencil(
            circulant, dtype=np.dtype(config.dtype), band_closure=0)

    @property
    def method(self) -> str:
        return self._method

    def recover_prev(self, dist) -> np.ndarray:
        """Predecessor tree from a converged distance field: the argmin
        sweep of the circulant stencil on the solver's device."""
        return recover_prev_device(self.circulant, dist, self.device,
                                   _dcache=self._device_cache)

    def solve(self, source: int, want_prev: bool = True) -> BellmanFordMoore:
        """Single-source solve; dist as a host array, prev (int64) from
        the device argmin sweep when `want_prev`."""
        dist, self.last_iterations = solve_circulant_sweep(
            self.circulant, [source], self.config, device=self.device,
            _packed=self._sweep_stencil)
        dist = dist[0]
        if want_prev:
            prev = self.recover_prev(dist)
            prev[source] = source
        else:
            prev = np.arange(len(dist))
        return BellmanFordMoore(prev=prev, dist=dist)
