"""High-level solver API of the PyTorch port.

`AnnulusSolver` packs the graph once (the circulant layout when the
mesh's rotational symmetry verifies, the RCM-banded or padded-ELL layout
otherwise) and then serves repeated solves on one explicit device.  This
port carries the directional-sweep engine ('sweep', the JAX package's
auto route on its accelerator), the Jacobi engines 'twrapped', 'stream',
'wrapped' and 'diag', the quarantined engines 'pallas' and 'fused'
(explicit methods only, as in the JAX package), the plain Jacobi oracle
'circulant', and the generic-graph methods 'banded' and 'ell'.  A mesh
without a circulant layout falls back as the JAX package's accelerator
route does: to 'banded' under auto, to 'ell' from an explicit
circulant-family method, with the JAX package's warning.  Nothing else
falls back: no CPU run unless the caller asks for `device="cpu"`, no
engine the JAX package would not route to.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..contrib.fused_circulant import solve_circulant_fused
from ..contrib.pallas_circulant import (pack_tiled_stencil,
                                        solve_circulant_pallas)
from ..ops.banded import prepare_banded, solve_banded
from ..ops.circulant import (CirculantError, CirculantGraph, PrevRecovery,
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
from . import bfm as _bfm
from .types import BellmanFordMoore

# the methods that need the circulant layout
_CIRCULANT = ("sweep", "twrapped", "stream", "wrapped", "diag", "pallas",
              "fused", "circulant")
# the methods of a materialised graph without one
_GRAPH = ("banded", "ell")
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
      'banded'    -> RCM-banded diagonal sweep (ops/banded.py, one Jacobi
                     iteration a launch of the CUDA kernel banded_sweep,
                     csrc/banded.cu): any graph, the unstructured-mesh
                     path; prev from the host PrevRecovery
      'ell'       -> the padded-ELL Bellman-Ford-Moore solver
                     (solvers/bfm.py, one iteration a call of the CUDA
                     kernel csrc/ell_bfm.cu): any graph; prev is BFM's own
                     and `last_iterations` is not set, as in the JAX
                     package
    A mesh whose circulant layout cannot be built (a Delaunay mesh, for
    one) falls back with a warning: to 'banded' under auto, to 'ell' from
    an explicit circulant-family method, as the JAX package's
    accelerator route does.
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

        self.A = A
        self.halo = (np.asarray(halo) if halo is not None
                     else np.empty((0, 2), np.int64))
        self.ell = None
        self.banded = None
        self._prev_rec = None

        was_auto = method == "auto"
        fallback = "ell"
        if was_auto:
            method, fallback = "sweep", "banded"
        if method not in _CIRCULANT + _GRAPH:
            raise ValueError(f"unknown method {method!r}")
        if circulant is not None and method in _GRAPH:
            raise ValueError(
                f"method={method!r} needs the materialised graph; a prebuilt "
                "circulant stencil only serves the circulant-family methods")
        if circulant is None and A is None:
            raise ValueError("pass A and halo, or a prebuilt circulant")
        if method in _CIRCULANT:
            dtype = np.dtype(config.dtype)
            try:
                if circulant is None:
                    if cache_dir is not None:
                        circulant = build_circulant_cached(
                            gr, A, halo, U, dtype, cache_dir)
                    else:
                        circulant = build_circulant(gr, A, halo, U,
                                                    dtype=dtype)
            except CirculantError as e:
                warnings.warn(f"circulant layout unavailable ({e}); "
                              f"falling back to {fallback}")
                method = fallback
        if method in _CIRCULANT:
            if (method == "sweep" and was_auto
                    and not supports_twrapped(circulant)):
                # auto only: the wrap structure has no sweep support; the
                # Jacobi chain by size
                method = ("twrapped" if gr.nnods <= _TWRAPPED_MAX_NODES
                          else "stream")
            if method == "twrapped" and not supports_twrapped(circulant):
                method = "wrapped"
            if method == "wrapped" and not supports_wrapped(circulant):
                method = "diag"
        elif method == "banded":
            self.banded = prepare_banded(A, self.halo, gr, U, config,
                                         device=self.device)
        else:
            self.ell = _bfm.prepare(A, self.halo, gr, U, config,
                                    device=self.device)
        # None on 'ell' and 'banded'
        self.circulant: Optional[CirculantGraph] = circulant
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
                device_out=device_out, engine="pallas", device=self.device,
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
        if self._method == "banded":
            dist, iters = solve_banded(self.banded, list(sources), cfg)
            self.last_iterations = iters
            return dist if receivers is None else dist[:, receivers]
        if self._method == "ell":
            dist = np.stack([_bfm.solve(self.ell, int(s), cfg).dist
                             for s in sources])
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
        sweep of the circulant stencil on the solver's device, the host
        PrevRecovery on a graph without a circulant layout."""
        if self.circulant is not None:
            return recover_prev_device(self.circulant, dist, self.device,
                                       _dcache=self._device_cache)
        if self._prev_rec is None:
            self._prev_rec = PrevRecovery(self.gr, self.A, self.halo, self.U)
        return self._prev_rec(np.asarray(dist, dtype=np.float64))

    def solve(self, source: int, want_prev: bool = True,
              device_dist: bool = False) -> BellmanFordMoore:
        """Single-source solve; dist as a host array, prev (int64) from
        the device argmin sweep when `want_prev`.  device_dist=True
        (kernel engines only) returns `dist` as a tensor on the solver's
        device after the solve has converged; 'diag', 'pallas', 'fused'
        and 'circulant' return a host array all the same, as in the JAX
        package.  On 'ell' prev is BFM's own (int32) and `last_iterations`
        is left as it was; on 'banded' prev comes from the host
        PrevRecovery, as in the JAX package."""
        if self._method == "ell":
            return _bfm.solve(self.ell, source, self.config)
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
        the device.  'diag', 'pallas', 'fused', 'circulant', 'banded' and
        'ell' solve chunk by chunk, `batch` sources per call.
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

    def sensitivity_matrix(self, D: BellmanFordMoore, source: int,
                           receivers: Sequence[int], max_len: int = 0):
        """(n_rec, n) tomography kernels dt/dU for this solver's grid,
        velocity and halo (solvers/sensitivity.py), a tensor on the
        solver's device, from a `solve(source)` result that carries prev.
        max_len bounds the backtrace depth (0 = 4 (ntheta + nr), or 2048
        on a grid without them)."""
        from .sensitivity import sensitivity_matrix

        if max_len <= 0:
            nt = int(getattr(self.gr, "ntheta", 0) or 0)
            nr = int(getattr(self.gr, "nr", 0) or 0)
            max_len = 4 * (nt + nr) if (nt and nr) else 2048
        return sensitivity_matrix(self.gr, self.U, D.prev, source,
                                  receivers, max_len, self.halo,
                                  device=self.device)

    def refined_travel_times(self, source: int,
                             receivers: Sequence[int],
                             D: BellmanFordMoore = None,
                             profile=None,
                             m: int = 128, iters: int = 800,
                             lr: float = 3.0, quad: int = 8,
                             multistart: bool = True,
                             dtype="float64") -> np.ndarray:
        """(n_rec,) bending-refined first arrivals (solvers/refine.py):
        solve (or reuse D with prev), backtrace each receiver on the host
        (`recontruct_path`), bend the fan on the solver's device (the
        `bend` kernel on the card); `multistart` also bends
        refraction-branch candidates for close receivers and keeps the
        minimum.

        profile: (radii, velocities) radial table for the continuous
        functional, e.g. the AK135 1-km table; None uses the solver's own
        sampled (r, U), whose refined time is the Fermat limit of that
        coarser model.  The bend runs in `dtype` (float64 by default, as
        solvers/refine.py)."""
        from .locate import _radial_profile
        from .path import recontruct_path
        from .refine import refine_fan

        if D is None:
            D = self.solve(source, want_prev=True)
        rs, vs = _radial_profile(profile, self.gr.r, self.U)
        paths = [recontruct_path(D.prev, source, r) for r in receivers]
        pts = [np.stack([self.gr.x[p], self.gr.z[p]], axis=1)
               for p in paths]
        return refine_fan(pts, rs, vs, m=m, iters=iters, lr=lr,
                          quad=quad, multistart=multistart, dtype=dtype,
                          device=self.device)

    def refined_travel_time_table(self, sources: Sequence[int],
                                  receivers: Sequence[int],
                                  profile=None, m: int = 384,
                                  iters: int = 1600, lr: float = 3.0,
                                  quad: int = 16,
                                  multistart: bool = True,
                                  multistart_max_deg: float = 32.0,
                                  dtype="float64") -> np.ndarray:
        """(n_sources, n_receivers) bias-free first-arrival table: solve +
        prev + backtrace per source, then bend the WHOLE table's path fan
        (n_sources * n_receivers polylines) in batched launches of
        `refine_paths_batch`.  The defaults are the accuracy-grade
        bending configuration (m=384, quad=16).  multistart: as
        `refined_travel_times`, for pairs closer than
        `multistart_max_deg`."""
        from .locate import _radial_profile
        from .path import recontruct_path
        from .refine import refine_fan

        rs, vs = _radial_profile(profile, self.gr.r, self.U)
        pts = []
        for s in sources:
            D = self.solve(int(s), want_prev=True)
            for r in receivers:
                p = recontruct_path(D.prev, int(s), int(r))
                pts.append(np.stack([self.gr.x[p], self.gr.z[p]], axis=1))
        t = refine_fan(pts, rs, vs, m=m, iters=iters, lr=lr, quad=quad,
                       multistart=multistart,
                       multistart_max_deg=multistart_max_deg, dtype=dtype,
                       device=self.device)
        return t.reshape(len(sources), len(receivers))
