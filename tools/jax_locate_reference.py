"""The JAX package's event location and amplitudes on the CPU: the figures
that chip_smoke.py phase 21 and tests/test_torch_locate.py hold the
PyTorch port's location slice to.

    JAX_PLATFORMS=cpu python tools/jax_locate_reference.py [--skip-catalogue]

1. `JAX_LOCATE`: the workload of `benchmarks/chip_locate.py`, nothing cut:
   `init_annulus(180, 63, spacing=20)`, AK135 Vp, a float32 solver (its
   route on the CPU), 12 surface stations every 30 degrees, 64 on-grid
   events drawn by `default_rng(0)` with 0.2 s of pick noise, located by
   `locate_many(sigma=0.2)` on those station fields.  The grid search runs
   in float64 (x64 on), as the port's does.  Prints the node hits, the
   mean distance of the picked nodes and of the refined positions to the
   true nodes (km).
2. `JAX_AMPLITUDE`: the root driver `main_annulus.py --nr 63 --q 600
   --freq 1 --refine` (float32, without x64, as that driver runs), its
   amplitude CSV's columns (deg, tstar_s, spreading_km, rel_amp,
   pcp_p_ratio, valid) at 30, 60, 90 and 150 degrees.
3. `JAX_EXAMPLE_LOCATION`: the root `example_location.run()` at its
   defaults under x64 (the mean node and refined errors, km).
4. `JAX_BEND_LOCATE_SPREAD`: the JAX package's own spread of a
   `locate(bend=True)` on the 32x8 fixture of tests/test_locate.py (the
   three events of `test_bend_mode_beats_plain_gauss_newton`, picks from
   the 64x16 grid): the most the refined position (km) and the origin
   time (s) move under four nudges (all up, then three of random sign)
   of one float64 ulp, first of every pick, then of every vertex of the
   polylines the bend starts from.  The picks do not reach the bend (it
   bends the best node's graph paths), so their nudge moves only the
   Gauss-Newton step, by rounding; the polylines' nudge shows the
   800-step bend's chaos, and the port's bend-mode locations are held to
   twice that spread.
5. `JAX_TSTAR_SPREAD`: the JAX package's own spread of the `--q` CSV's t*
   under the same one-float32-ulp nudges of the fan's polylines that
   tools/jax_refine_reference.py applies (the --refine bend at 180x63,
   float32): the most t* moves, relative, at each of the four degrees
   (`--tstar-spread`; about 3 more minutes).
Takes about 5 minutes and ~4 GB.  Imports the JAX package only, never the
port.
"""
from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import R, SolverConfig  # noqa: E402

AMPLITUDE_DEGREES = (30.0, 60.0, 90.0, 150.0)
STATION_DEGS = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 315.0]


def catalogue():
    """benchmarks/chip_locate.py's workload: hits, node and refined
    errors (km) of the 64 events."""
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    prof = rt.velocity_profile("ak135")
    Vp = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                               prof.Vp))
    solver = rt.AnnulusSolver(gr, A, halo, Vp, SolverConfig(dtype="float32"))
    stations = [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
                for d in np.arange(0.0, 360.0, 30.0)]
    fields = rt.station_fields(solver, stations)
    rng = np.random.default_rng(0)
    ev = rng.integers(0, gr.nnods, size=64)
    T_obs = fields[:, ev].T + rng.normal(0.0, 0.2, (64, len(stations)))
    locs = rt.locate_many(solver, stations, T_obs,
                          sigma=[0.2] * len(stations), fields=fields)
    x, z = np.asarray(gr.x), np.asarray(gr.z)
    hits = sum(int(l.node) == int(e) for l, e in zip(locs, ev))
    node_err = np.mean([np.hypot(x[l.node] - x[e], z[l.node] - z[e])
                        for l, e in zip(locs, ev)])
    ref_err = np.mean([np.hypot(l.x - x[e], l.z - z[e])
                       for l, e in zip(locs, ev)])
    return solver.method, hits, float(node_err), float(ref_err)


def amplitude_rows():
    """The root CLI's amplitude CSV rows at AMPLITUDE_DEGREES."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "amp")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, os.path.join(ROOT, "main_annulus.py"),
                        "--nr", "63", "--q", "600", "--freq", "1",
                        "--refine", "--out-prefix", prefix],
                       check=True, env=env, cwd=tmp, capture_output=True)
        with open(f"{prefix}_amplitude.csv") as f:
            rows = [r for r in csv.reader(f)
                    if r and not r[0].startswith(("#", "deg"))]
    table = np.array([[float(v) for v in r] for r in rows])
    return {d: [float(v) for v in table[np.argmin(np.abs(table[:, 0] - d))]]
            for d in AMPLITUDE_DEGREES}


def ulp_nudge(a, k, rng):
    """One float64 ulp up (k = 0) or of random sign."""
    sign = (np.ones(a.shape) if k == 0
            else rng.choice([-1.0, 1.0], size=a.shape))
    return np.nextafter(a, np.where(sign > 0, np.inf, -np.inf))


def bend_spread():
    """The JAX package's own spread of a bend-mode location under
    one-ulp nudges of the picks and of the bend's input polylines, on
    the 32x8 fixture of tests/test_locate.py: ((km, s), (km, s))."""
    import raytracer_tpu.solvers.refine as jrefine
    from raytracer_tpu.solvers.locate import locate, station_fields

    gr, A, halo = rt.init_annulus(32, 8, spacing=250.0)
    prof = rt.velocity_profile("ak135")
    interp = rt.LinearInterpolation(prof.r, prof.Vp)
    cfg = SolverConfig(dtype="float64")
    solver = rt.AnnulusSolver(gr, A, halo,
                              rt.interpolate_velocity(gr.r, interp), cfg)
    stations = [rt.closest_point(gr, np.deg2rad(d), R, system="polar")
                for d in STATION_DEGS]
    fields = station_fields(solver, stations)
    grf, Af, halof = rt.init_annulus(64, 16, spacing=120.0)
    fine = rt.AnnulusSolver(grf, Af, halof,
                            rt.interpolate_velocity(grf.r, interp), cfg)
    st_fine = [rt.closest_point(grf, np.deg2rad(d), R, system="polar")
               for d in STATION_DEGS]
    ffine = station_fields(fine, st_fine)
    rng = np.random.default_rng(0)
    plain = jrefine.refine_paths_batch
    spread = {"picks": [0.0, 0.0], "polylines": [0.0, 0.0]}
    for deg, dep in [(73.1, 400.0), (141.7, 150.0), (222.3, 1000.0)]:
        true = rt.closest_point(grf, np.deg2rad(deg), R - dep,
                                system="polar")
        t_obs = ffine[:, true]
        base = locate(solver, stations, t_obs, fields=fields, bend=True,
                      profile=(prof.r, prof.Vp))
        for what in spread:
            for k in range(4):
                picks = t_obs
                if what == "picks":
                    picks = ulp_nudge(t_obs, k, rng)
                else:
                    jrefine.refine_paths_batch = (
                        lambda paths, *a, k=k, **kw: plain(
                            [ulp_nudge(np.asarray(p, np.float64), k, rng)
                             for p in paths], *a, **kw))
                try:
                    lb = locate(solver, stations, picks, fields=fields,
                                bend=True, profile=(prof.r, prof.Vp))
                finally:
                    jrefine.refine_paths_batch = plain
                d = spread[what]
                d[0] = max(d[0], float(np.hypot(lb.x - base.x,
                                                lb.z - base.z)))
                d[1] = max(d[1], abs(lb.t0 - base.t0))
    return tuple(spread["picks"]), tuple(spread["polylines"])


def tstar_spread():
    """The most t* moves, relative, at AMPLITUDE_DEGREES when the
    --refine fan's polylines move by one float32 ulp (four nudges)."""
    from jax_refine_reference import fan_paths, nudged
    from raytracer_tpu.solvers.refine import refine_paths_batch

    jax.config.update("jax_enable_x64", False)
    try:
        _, pts, _, prof = fan_paths()
        degs = np.arange(2.0, 152.0, 2.0)
        degs = np.concatenate([degs, 360.0 - degs[::-1]])
        idx = [int(np.argmin(np.abs(degs - d))) for d in AMPLITUDE_DEGREES]

        def tstars(polylines):
            bent, _ = refine_paths_batch(polylines, prof.r, prof.Vp)
            return np.array([rt.tstar(np.asarray(bent[i]), prof.r, prof.Vp,
                                      600.0) for i in idx])

        base = tstars(pts)
        rng = np.random.default_rng(0)
        spread = np.zeros(len(idx))
        for k in range(4):
            spread = np.maximum(spread, np.abs(
                tstars(nudged(pts, k, rng, False)) / base - 1.0))
    finally:
        jax.config.update("jax_enable_x64", True)
    return dict(zip(AMPLITUDE_DEGREES, spread.tolist()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-catalogue", action="store_true")
    ap.add_argument("--tstar-spread", action="store_true",
                    help="only the t* spread (item 5)")
    args = ap.parse_args()
    if args.tstar_spread:
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        t0 = time.time()
        print(f"JAX_TSTAR_SPREAD = {tstar_spread()!r}   # relative "
              f"({time.time() - t0:.1f} s)", flush=True)
        return
    t0 = time.time()
    picks, polylines = bend_spread()
    print(f"pick nudges move the bend-mode location by {picks!r} (km, s)")
    print(f"JAX_BEND_LOCATE_SPREAD = {polylines!r}   # km, s: polyline "
          f"nudges ({time.time() - t0:.1f} s)", flush=True)
    t0 = time.time()
    import example_location

    out = example_location.run(verbose=False)
    print(f"JAX_EXAMPLE_LOCATION = {{'node_err': {out['node_err']!r}, "
          f"'refined_err': {out['refined_err']!r}}}   "
          f"({time.time() - t0:.1f} s)", flush=True)
    t0 = time.time()
    rows = amplitude_rows()
    print("JAX_AMPLITUDE = {   # deg: deg, tstar_s, spreading_km, rel_amp, "
          f"pcp_p_ratio, valid ({time.time() - t0:.1f} s)")
    for d in AMPLITUDE_DEGREES:
        print(f"    {d!r}: {rows[d]!r},")
    print("}", flush=True)
    if not args.skip_catalogue:
        t0 = time.time()
        method, hits, node_err, ref_err = catalogue()
        print(f"solver method {method} ({time.time() - t0:.1f} s)")
        print(f"JAX_LOCATE = {{'hits': {hits}, 'node_err': {node_err!r}, "
              f"'refined_err': {ref_err!r}}}", flush=True)


if __name__ == "__main__":
    main()
