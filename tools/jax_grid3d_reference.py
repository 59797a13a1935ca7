"""The JAX package's 3-D travel-time tables on the CPU, the reference
values that chip_smoke.py holds the PyTorch port to.

    JAX_PLATFORMS=cpu python tools/jax_grid3d_reference.py

Prints, at full precision:
- the root `example_grid3d.py` at its defaults (24x24x16, theta and phi
  70-110 deg, depth 2000 km, AK135 Vp, float32; JAX's `auto` on the CPU
  is the xla engine): its 3x3 table and iterations (`JAX_EXAMPLE`);
- the same 3 sources x 3 receivers on the chip-campaign wedge of
  `benchmarks/chip_dsweep3d.py` (128x128x64 = 1,048,576 nodes, theta and
  phi 60-120 deg, depth 2500 km), xla engine with scan_every 0 and 8
  (`JAX_WEDGE_TABLE`).
About a minute and 2 GB of host memory in all.  Imports the JAX package
only, never the port.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import R, SolverConfig  # noqa: E402
from raytracer_tpu.models.grid3d import grid3d  # noqa: E402
from raytracer_tpu.solvers.solve3d import prepare3d, solve3d  # noqa: E402
from raytracer_tpu.utils.coords import spherical2cart  # noqa: E402

SOURCES = [(75.0, 75.0), (90.0, 90.0), (105.0, 105.0)]
RECEIVERS = [(80.0, 80.0), (90.0, 75.0), (105.0, 95.0)]


def _nodes(g, degs):
    return [rt.closest_point3d(g, *spherical2cart(np.deg2rad(a),
                                                  np.deg2rad(b), R))
            for a, b in degs]


def table(lo_deg, hi_deg, depth, dims, scan_every=None):
    g = grid3d((np.deg2rad(lo_deg), np.deg2rad(lo_deg), R - depth),
               (np.deg2rad(hi_deg), np.deg2rad(hi_deg), R), dims)
    prof = rt.velocity_profile("ak135")
    U = rt.LinearInterpolation(prof.r, prof.Vp)(g.r)
    cfg = SolverConfig(dtype="float32")
    packed = prepare3d(g, U, cfg)
    t0 = time.perf_counter()
    tab, iters = solve3d(g, U, _nodes(g, SOURCES), cfg, scan_every=scan_every,
                         receivers=_nodes(g, RECEIVERS), engine="xla",
                         _packed=packed)
    return tab, iters, time.perf_counter() - t0


def main():
    for label, args in (
            ("example 24x24x16 (xla, scan_every 8)",
             (70.0, 110.0, 2000.0, (24, 24, 16))),
            ("wedge 128x128x64 (xla, scan_every 0)",
             (60.0, 120.0, 2500.0, (128, 128, 64), 0)),
            ("wedge 128x128x64 (xla, scan_every 8)",
             (60.0, 120.0, 2500.0, (128, 128, 64), 8))):
        tab, iters, secs = table(*args)
        rows = ", ".join("[" + ", ".join(repr(float(v)) for v in row) + "]"
                         for row in tab)
        print(f"{label}: {iters} iterations in {secs:.1f} s; table "
              f"[{rows}]", flush=True)


if __name__ == "__main__":
    main()
