"""The JAX package's sharded and xla-engine sweep solves on the CPU at
180x63, the references that chip_smoke.py holds the port's phases 22
and 23 to.

    JAX_PLATFORMS=cpu python tools/jax_shard_reference.py

On init_annulus_circulant(180, 63, 20) (float32, AK135 Vp) from the
surface source at theta 0, prints `JAX_SHARD`: for the theta-sharded
solve (`solve_sweep_theta_sharded`) on D = 1 and D = 2 virtual CPU
devices its rounds and the sha256 of its (1, n) float32 field (the
block sweeps, the fan's minimum and the vote are additions and minima
only, so the port on the card must give the same bits), and for the
xla engine (`solve_circulant_sweep(engine="xla", mode=m)`) each mode's
rounds and its times at 60 and 150 degrees; and the same for the r and
kernel-r modes on init_annulus_circulant(48, 12, 150) (keys "r@48x12",
"kernel-r@48x12"), the size at which chip_smoke.py runs those two, whose
radial sweeps are plain tensor code on the card.  A few minutes on one
core.  Imports the JAX package only, never the port.
"""
from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import SolverConfig  # noqa: E402
from raytracer_tpu.ops.sweep_theta import solve_circulant_sweep  # noqa: E402
from raytracer_tpu.parallel.theta_shard import (  # noqa: E402
    make_theta_mesh, solve_sweep_theta_sharded)

MODES = ("theta", "r", "both", "kernel", "kernel-r", "hclosure")


def main():
    gr, cg, U = rt.init_annulus_circulant(180, 63, 20.0)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    recs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in (60.0, 150.0)]
    cfg = SolverConfig(dtype="float32")
    out = {}
    for D in (1, 2):
        t0 = time.perf_counter()
        vals, rounds = solve_sweep_theta_sharded(
            cg, [src], cfg, mesh=make_theta_mesh(jax.devices()[:D]))
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        out[f"theta_d{D}"] = (int(rounds), hashlib.sha256(
            vals.tobytes()).hexdigest()[:16])
        print(f"# theta-sharded D={D}: {rounds} rounds, t(60) = "
              f"{float(vals[0, recs[0]])!r}, t(150) = "
              f"{float(vals[0, recs[1]])!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for mode in MODES:
        t0 = time.perf_counter()
        d, rounds = solve_circulant_sweep(cg, src, cfg, mode=mode)
        out[mode] = (int(rounds), float(d[0, recs[0]]), float(d[0, recs[1]]))
        print(f"# xla {mode}: {out[mode]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    gr, cg, U = rt.init_annulus_circulant(48, 12, 150.0)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    recs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in (60.0, 150.0)]
    for mode in ("r", "kernel-r"):
        d, rounds = solve_circulant_sweep(cg, src, cfg, mode=mode)
        out[f"{mode}@48x12"] = (int(rounds), float(d[0, recs[0]]),
                                float(d[0, recs[1]]))
        print(f"# xla {mode} 48x12: {out[f'{mode}@48x12']}", flush=True)
    print(f"JAX_SHARD = {out!r}")


if __name__ == "__main__":
    main()
