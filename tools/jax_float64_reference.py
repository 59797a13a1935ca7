"""The JAX package's float64 sweep solve on the CPU at 180x63, the
reference that chip_smoke.py holds the port's float64 `auto` route to.

    JAX_PLATFORMS=cpu python tools/jax_float64_reference.py

Prints the rounds of `AnnulusSolver(method="sweep")` in float64 (tol 0:
the solve runs until no node improves at all) on
init_annulus_circulant(180, 63, 20) from the surface source at theta 0,
and its travel times at 60 and 150 degrees (`JAX_F64_180` in
chip_smoke.py).  About a minute on one core.  Imports the JAX package
only, never the port.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import SolverConfig  # noqa: E402


def main():
    gr, cg, U = rt.init_annulus_circulant(180, 63, 20.0, dtype=np.float64)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    t0 = time.perf_counter()
    solver = rt.AnnulusSolver(gr, None, None, U, SolverConfig(dtype="float64"),
                              method="sweep", circulant=cg)
    d = np.asarray(solver.solve(src, want_prev=False).dist)
    secs = time.perf_counter() - t0
    out = {}
    for deg in (60.0, 150.0):
        out[deg] = float(d[rt.closest_point(gr, np.deg2rad(deg), rt.R,
                                            system="polar")])
    print(f"float64 sweep 180x63: {solver.last_iterations} rounds, "
          f"t(60) = {out[60.0]!r} s, t(150) = {out[150.0]!r} s "
          f"({secs:.1f} s)")


if __name__ == "__main__":
    main()
