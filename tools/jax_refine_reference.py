"""The JAX package's bending refinement and tomography on the CPU: the
figures that chip_smoke.py holds the PyTorch port's paths slice to.

    JAX_PLATFORMS=cpu python tools/jax_refine_reference.py [--skip-tomography]

1. The root driver's `--refine` at 180x63 (`main_annulus.py --nr 63
   --refine`, float32 as that driver runs, without x64): the AK135 Vp
   annulus, the surface source, its solver's auto route on the CPU, the
   150-receiver fan's paths by `recontruct_path`, and `refine_paths_batch`
   at its defaults (m 128, 800 steps, quad 8, lr 3) under the AK135 Vp
   table.  Prints the 150 refined times (`JAX_REFINE`).
2. The JAX package's spread against itself: the same 800-step bend of the
   same polylines after a nudge of the input vertices, four nudges (one
   all up, three of random sign), the most any time moves.  In float32 a
   1e-9 km nudge is below the coordinates' resolution (~5e-4 km at the
   surface) and moves nothing, so the nudge there is one float32 ulp of
   each coordinate (`JAX_REFINE_SPREAD`); with `--x64` the bend runs in
   float64 and the nudge is 1e-9 km, as tests/test_torch_refine.py takes
   it (printed for comparison).
3. The root `example_tomography.py` at its defaults (64x16, 12 sources x
   36 receivers, float64 under x64): misfit before and after, and the
   checkerboard correlation (`JAX_TOMO`).
Takes about 3 minutes and ~3 GB.  Imports the JAX package only, never the
port.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import R, SolverConfig  # noqa: E402


def fan_paths():
    """The root driver's polylines at 180x63 and its SPM times."""
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    prof = rt.velocity_profile("ak135")
    Vp = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                               prof.Vp))
    solver = rt.AnnulusSolver(gr, A, halo, Vp, SolverConfig(dtype="float32"))
    source = rt.closest_point(gr, 0.0, R, system="polar")
    D = solver.solve(source)
    degs = np.arange(2.0, 152.0, 2.0)
    degs = np.concatenate([degs, 360.0 - degs[::-1]])
    receivers = [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
                 for d in degs]
    paths = [rt.recontruct_path(D.prev, source, r) for r in receivers]
    pts = [np.stack([gr.x[p], gr.z[p]], axis=1) for p in paths]
    return solver.method, pts, np.asarray(D.dist)[receivers], prof


def nudged(pts, k, rng, x64):
    """The k-th nudge of the polylines: 1e-9 km in float64, one float32
    ulp in float32; k = 0 all up, else random signs."""
    out = []
    for p in pts:
        sign = (np.ones(p.shape) if k == 0
                else rng.choice([-1.0, 1.0], size=p.shape))
        if x64:
            out.append(p + 1e-9 * sign)
        else:
            p32 = p.astype(np.float32)
            to = np.where(sign > 0, np.inf, -np.inf).astype(np.float32)
            out.append(np.nextafter(p32, to).astype(np.float64))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--x64", action="store_true",
                    help="bend in float64 with a 1e-9 km nudge")
    ap.add_argument("--skip-tomography", action="store_true")
    args = ap.parse_args()
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    from raytracer_tpu.solvers.refine import refine_paths_batch

    t0 = time.time()
    method, pts, spm, prof = fan_paths()
    t1 = time.time()
    _, t_ref = refine_paths_batch(pts, prof.r, prof.Vp)
    t_ref = np.asarray(t_ref, np.float64)
    t2 = time.time()
    rng = np.random.default_rng(0)
    spread = 0.0
    for k in range(4):
        tn = np.asarray(refine_paths_batch(nudged(pts, k, rng, args.x64),
                                           prof.r, prof.Vp)[1], np.float64)
        spread = max(spread, float(np.abs(tn - t_ref).max()))
    t3 = time.time()
    dt = "float64" if args.x64 else "float32"
    print(f"solver method {method}; solve+paths {t1 - t0:.1f} s, bend "
          f"{t2 - t1:.1f} s, four nudged bends {t3 - t2:.1f} s ({dt})")
    print(f"refined below SPM at {int(np.sum(t_ref <= spm))}/150 "
          f"receivers; SPM - refined {float(np.min(spm - t_ref)):.4f} to "
          f"{float(np.max(spm - t_ref)):.4f} s")
    print(f"JAX_REFINE_SPREAD = {spread!r}   # {dt}")
    print("JAX_REFINE = [" + ", ".join(repr(float(v)) for v in t_ref) + "]")
    if not args.skip_tomography:
        jax.config.update("jax_enable_x64", True)
        import example_tomography

        out = example_tomography.run(verbose=False)
        print(f"JAX_TOMO = {{'misfit0': {out['misfit0']!r}, 'misfit1': "
              f"{out['misfit1']!r}, 'corr': {float(out['corr'])!r}}}")


if __name__ == "__main__":
    main()
