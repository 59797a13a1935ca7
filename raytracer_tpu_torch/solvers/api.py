"""High-level solver API of the PyTorch port.

`AnnulusSolver` packs the circulant graph once and then serves repeated
solves on one explicit device.  This port carries the directional-sweep
engine ('sweep', the JAX package's auto route on its accelerator), the
Jacobi engines 'twrapped', 'stream', 'wrapped' and 'diag', the
quarantined engines 'pallas' and 'fused' (explicit methods only, as in
the JAX package), and the plain Jacobi oracle 'circulant'; every other
method raises
`NotImplementedError` naming the ROADMAP item that ports it.  Nothing
falls back silently: no CPU run unless the caller asks for
`device="cpu"`, no engine the JAX package would not route to.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..contrib.fused_circulant import solve_circulant_fused
from ..contrib.pallas_circulant import (pack_tiled_stencil,
                                        solve_circulant_pallas)
from ..ops.circulant import (CirculantError, CirculantGraph,
                             build_circulant, recover_prev_device,
                             resolve_device, solve_circulant)
from ..ops.diag_circulant import pack_diag_stencil, solve_circulant_diag
from ..ops.diag_wrapped import (pack_wrapped_stencil,
                                solve_circulant_wrapped, supports_wrapped)
from ..ops.stream_t import solve_circulant_stream
from ..ops.sweep_theta import solve_circulant_sweep
from ..ops.wrapped_t import (max_twrapped_batch, pack_twrapped_stencil,
                             solve_circulant_twrapped, supports_twrapped)
from ..utils.cache import build_circulant_cached
from .types import BellmanFordMoore

# methods of the JAX package's AnnulusSolver that later slices port
_NOT_PORTED = {
    "ell": "ROADMAP A.6 (generic graphs)",
    "banded": "ROADMAP A.6 (generic graphs)",
}
_PORTED = ("sweep", "twrapped", "stream", "wrapped", "diag", "pallas",
           "fused", "circulant")
# the kernel engines that chunk a whole source list themselves
_BATCHED = ("twrapped", "sweep", "stream", "wrapped")
# the JAX package's auto re-route of grids without sweep support:
# 'twrapped' up to this many nodes, 'stream' above
_TWRAPPED_MAX_NODES = 350_000


class AnnulusSolver:
    """One-time graph packing + repeated SSSP solves on `device`.

    method:
      'auto'      -> 'sweep'; a grid without sweep support (the wrap
                     condition of `supports_twrapped`) goes to 'stream'
                     above 350k nodes and to 'twrapped' otherwise, as in
                     the JAX package
      'sweep'     -> directional-sweep solver (ops/sweep_theta.py): radial
                     Gauss-Seidel sweeps as a CUDA kernel + hierarchical
                     horizontal closure; converges in ~3-4 ROUNDS
      'twrapped'  -> theta-major full-iteration Jacobi engine
                     (ops/wrapped_t.py, CUDA kernel csrc/titer.cu); a grid
                     it does not support goes on to 'wrapped', and a grid
                     whose source block exceeds the kernel's budget even
                     at one source goes to 'stream'
      'stream'    -> streamed theta-major Jacobi engine (ops/stream_t.py,
                     band sweep as the CUDA kernel csrc/band.cu); any size
      'wrapped'   -> slot-major full-iteration Jacobi engine
                     (ops/diag_wrapped.py, CUDA kernel csrc/witer.cu); a
                     grid it does not support (ntheta < 8, or exactly one
                     duplicated theta lane: ntheta = 127 mod 128) goes on
                     to 'diag'
      'diag'      -> diagonal-band Jacobi engine (ops/diag_circulant.py,
                     one sweep per iteration as the CUDA kernel
                     csrc/diag.cu, the ring and chain scans in torch);
                     sources one after another, any ntheta
      'pallas'    -> lane-gather Jacobi engine (contrib/pallas_circulant.py,
                     one relaxation sweep per iteration as the CUDA kernel
                     csrc/relax.cu, the ring and slot scans and the fan
                     in torch); the sources of a call batched along the
                     kernel's rows
      'fused'     -> the whole Jacobi loop in one cooperative launch of
                     the CUDA kernel csrc/fused.cu
                     (contrib/fused_circulant.py); sources batched as
                     for 'pallas'; `last_iterations` is -1, the count
                     staying on the device, as in the JAX package
      'pallas' and 'fused' are explicit methods only: no auto route
      reaches them, as in the JAX package
      'circulant' -> plain Jacobi solve (ops/circulant.solve_circulant),
                     the oracle of the kernel engines
    cache_dir: a directory for the circulant stencil built from (A, halo)
    (utils/cache.py; the JAX package's file names and keys).
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
        cache_dir: Optional[str] = None,
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
        self._sweep_stencil = None
        self._twrapped_stencil = None
        self._wrapped_stencil = None
        self._diag_stencil = None
        self._tiled_stencil = None

        was_auto = method == "auto"
        if was_auto:
            method = "sweep"
        if method not in _PORTED:
            raise NotImplementedError(
                f"method={method!r} is not ported yet: "
                f"{_NOT_PORTED.get(method, 'unknown method')}")
        if circulant is None:
            if A is None:
                raise ValueError("pass A and halo, or a prebuilt circulant")
            dtype = np.dtype(config.dtype)
            try:
                if cache_dir is not None:
                    circulant = build_circulant_cached(gr, A, halo, U, dtype,
                                                       cache_dir)
                else:
                    circulant = build_circulant(gr, A, halo, U, dtype=dtype)
            except CirculantError as e:
                raise NotImplementedError(
                    f"circulant layout unavailable ({e}); the 'ell'/"
                    f"'banded' fallback is {_NOT_PORTED['ell']}") from e
        if method == "sweep" and was_auto and not supports_twrapped(circulant):
            # auto only: the wrap structure has no sweep support; the
            # Jacobi chain by size
            method = ("twrapped" if gr.nnods <= _TWRAPPED_MAX_NODES
                      else "stream")
        if method == "twrapped" and not supports_twrapped(circulant):
            method = "wrapped"
        if method == "wrapped" and not supports_wrapped(circulant):
            method = "diag"
        self.circulant: CirculantGraph = circulant
        self._method = method

    @property
    def method(self) -> str:
        return self._method

    def _packed(self, sweep: bool):
        """The theta-major stencil, packed once: closure-free for the
        sweep (its tables are rebuilt from the RAW decomposition), with
        `config.band_closure` for the Jacobi engines."""
        attr = "_sweep_stencil" if sweep else "_twrapped_stencil"
        if getattr(self, attr) is None:
            setattr(self, attr, pack_twrapped_stencil(
                self.circulant, dtype=np.dtype(self.config.dtype),
                band_closure=0 if sweep else self.config.band_closure))
        return getattr(self, attr)

    def _dist_batch(self, sources: Sequence[int], receivers=None,
                    batch: int = 8, device_out: bool = False):
        """(S, n) distance fields for a batch of sources; with `receivers`,
        (S, n_receivers), extracted on the device.  `batch` bounds the
        source block of one solve.  device_out=True keeps the rows on
        the device on the kernel engines (ignored by 'circulant')."""
        cfg = self.config
        if self._method == "twrapped":
            ws = self._packed(sweep=False)
            # the JAX package's source-block clamp (its TPU VMEM figure);
            # a grid too large even at S=1 goes to the streamed engine
            smax = max_twrapped_batch(ws)
            if smax < 1:
                self._method = "stream"
            else:
                dist, iters = solve_circulant_twrapped(
                    self.circulant, sources, cfg,
                    batch=min(batch, smax, len(sources)),
                    receivers=receivers, device_out=device_out,
                    device=self.device, _packed=ws)
                self.last_iterations = iters
                return dist
        if self._method == "stream":
            dist, iters = solve_circulant_stream(
                self.circulant, sources, cfg,
                band_closure=cfg.band_closure,
                batch=min(batch, len(sources)), receivers=receivers,
                device_out=device_out, device=self.device,
                _packed=self._packed(sweep=False))
            self.last_iterations = iters
            return dist
        if self._method == "wrapped":
            if self._wrapped_stencil is None:
                self._wrapped_stencil = pack_wrapped_stencil(
                    self.circulant, dtype=np.dtype(cfg.dtype))
            dist, iters = solve_circulant_wrapped(
                self.circulant, sources, cfg,
                batch=min(batch, len(sources)), receivers=receivers,
                device_out=device_out, device=self.device,
                _packed=self._wrapped_stencil)
            self.last_iterations = iters
            return dist
        if self._method == "sweep":
            dist, iters = solve_circulant_sweep(
                self.circulant, sources, cfg,
                batch=min(batch, len(sources)), receivers=receivers,
                device_out=device_out, device=self.device,
                _packed=self._packed(sweep=True))
            self.last_iterations = iters
            return dist
        if self._method == "diag":
            # full rows on the host, receivers sliced there, as in the
            # JAX package
            if self._diag_stencil is None:
                self._diag_stencil = pack_diag_stencil(
                    self.circulant, dtype=np.dtype(cfg.dtype))
            dist, iters = solve_circulant_diag(
                self.circulant, sources, cfg, device=self.device,
                _packed=self._diag_stencil, _dcache=self._device_cache)
            self.last_iterations = iters
            return dist if receivers is None else dist[:, receivers]
        if self._method in ("pallas", "fused"):
            # every given source in one call, full rows on the host, as
            # the JAX package's _dist_batch_full
            if self._tiled_stencil is None:
                self._tiled_stencil = pack_tiled_stencil(
                    self.circulant, dtype=np.dtype(cfg.dtype))
            solve = (solve_circulant_pallas if self._method == "pallas"
                     else solve_circulant_fused)
            dist, iters = solve(self.circulant, sources, cfg,
                                device=self.device,
                                _packed=self._tiled_stencil,
                                _dcache=self._device_cache)
            self.last_iterations = iters
            return dist if receivers is None else dist[:, receivers]
        rows = []
        for s in sources:
            d, iters = solve_circulant(self.circulant, int(s), cfg,
                                       device=self.device,
                                       _dcache=self._device_cache)
            self.last_iterations = iters
            rows.append(d)
        dist = np.stack(rows)
        return dist if receivers is None else dist[:, receivers]

    def recover_prev(self, dist) -> np.ndarray:
        """Predecessor tree from a converged distance field: the argmin
        sweep of the circulant stencil on the solver's device."""
        return recover_prev_device(self.circulant, dist, self.device,
                                   _dcache=self._device_cache)

    def solve(self, source: int, want_prev: bool = True,
              device_dist: bool = False) -> BellmanFordMoore:
        """Single-source solve; dist as a host array, prev (int64) from
        the device argmin sweep when `want_prev`.  device_dist=True
        (kernel engines only) returns `dist` as a tensor on the solver's
        device after the solve has converged; 'diag', 'pallas', 'fused'
        and 'circulant' return a host array all the same, as in the JAX
        package."""
        dist = self._dist_batch([source], device_out=device_dist)[0]
        if want_prev:
            prev = self.recover_prev(dist)
            prev[source] = source
        else:
            prev = np.arange(len(dist))
        return BellmanFordMoore(prev=prev, dist=dist)

    def travel_time_table(self, sources: Sequence[int],
                          receivers: Sequence[int],
                          batch: int = 8) -> np.ndarray:
        """(n_sources, n_receivers) first-arrival table (no predecessors).

        The kernel engines are handed the WHOLE source list at once and
        chunk it by `batch` themselves; only the receiver columns leave
        the device.  'diag', 'pallas', 'fused' and 'circulant' solve
        chunk by chunk, `batch` sources per call.
        """
        receivers = np.asarray(receivers)
        if self._method in _BATCHED:
            return self._dist_batch([int(s) for s in sources],
                                    receivers=receivers, batch=batch)
        out = np.empty((len(sources), len(receivers)),
                       dtype=np.dtype(self.config.dtype))
        for i in range(0, len(sources), batch):
            chunk = [int(s) for s in sources[i:i + batch]]
            out[i:i + len(chunk)] = self._dist_batch(chunk,
                                                     receivers=receivers)
        return out
