"""The JAX package's figures of the reference-faithful mesh on the CPU,
the constants that chip_smoke.py phase 25 holds the port to.

    JAX_PLATFORMS=cpu python tools/jax_faithful_reference.py [--skip-dijkstra]

Prints, from `init_annulus(..., faithful=True)` (the reference mesher's
duplicated secondary nodes) and the surface source at theta 0:
  * at 180x50, spacing 50: the node, directed-edge and halo-row counts, the
    two digests and the Dijkstra receiver times (4 decimals) of
    benchmarks/faithful_digests.json, recomputed (`FAITHFUL_180x50`);
  * at 180x63, spacing 20: the nodes and slots a column, scipy Dijkstra's
    t(60) and t(150) on the JAX package's `weight_matrix` with float64
    weights (~45 s, ~4 GB; and with its default float32 weights, for the
    record), the directional sweep's rounds and times in float64 and
    float32 on both engines: `AnnulusSolver(method="sweep")`, which takes
    the xla engine off the TPU, and `solve_circulant_sweep(engine=
    "pallas", interpret=True)`, the engine of the JAX package's
    accelerator route and of the port's, and how many of the 150 receiver
    walks of each field reach the source without a cycle (ROADMAP C.9)
    (`FAITHFUL_180x63`);
  * the CLI's `--model iasp91 --wave Vs --dtype float64 --nr 63` solve on
    the deduplicated mesh: Dijkstra's t(60) and t(150) on float64 and on
    float32 weights, and the float64 sweep's rounds and times on both
    engines (`CLI_IASP91_VS`).
About 20 minutes on one core.  Imports the JAX package only, never the
port.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np
import scipy.sparse.csgraph as csgraph

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import SolverConfig  # noqa: E402
from raytracer_tpu.ops.circulant import recover_prev_device  # noqa: E402
from raytracer_tpu.ops.sweep_theta import solve_circulant_sweep  # noqa: E402


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def reaching(prev, source, receivers) -> int:
    """How many receivers' predecessor walks reach `source` without
    meeting a node twice."""
    count = 0
    for node in receivers:
        seen = set()
        while node != source and node not in seen:
            seen.add(node)
            node = int(prev[node])
        count += node == source
    return count


def fan(gr):
    degs = np.arange(2.0, 152.0, 2.0)
    degs = np.concatenate([degs, 360.0 - degs[::-1]])
    return [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in degs]


def at(gr, d, deg) -> float:
    return float(d[rt.closest_point(gr, np.deg2rad(deg), rt.R,
                                    system="polar")])


def velocity(gr, model="ak135", wave="Vp"):
    prof = rt.velocity_profile(model)
    return rt.interpolate_velocity(
        gr.r, rt.LinearInterpolation(prof.r, getattr(prof, wave)))


def dijkstra_at(gr, A, halo, U, src, dtype="float64"):
    t0 = time.perf_counter()
    W = rt.weight_matrix(A, halo, gr, U, SolverConfig(dtype=dtype))
    d = csgraph.dijkstra(W.T, directed=True, indices=src)
    del W
    return at(gr, d, 60.0), at(gr, d, 150.0), time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-dijkstra", action="store_true")
    args = ap.parse_args()

    t0 = time.perf_counter()
    gr, A, halo = rt.init_annulus(180, 50, spacing=50.0, faithful=True)
    W = rt.weight_matrix(A, halo, gr, velocity(gr),
                         SolverConfig(dtype="float64"))
    d = csgraph.dijkstra(W.T, directed=True,
                         indices=rt.closest_point(gr, 0.0, rt.R,
                                                  system="polar"))
    print("FAITHFUL_180x50 = " + repr({
        "nodes": int(gr.nnods), "edges": int(A.nnz),
        "halo_rows": int(len(halo)),
        "r_sorted_sha256_16": digest(np.sort(np.round(gr.r, 6))),
        "degree_hist_sha256_16": digest(np.bincount(np.diff(A.indptr))),
        "travel_times_s": [round(float(t), 4) for t in d[fan(gr)]]})
        + f"  # {time.perf_counter() - t0:.1f} s", flush=True)
    del W

    t0 = time.perf_counter()
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0, faithful=True)
    t_build = time.perf_counter() - t0
    U = velocity(gr)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    recs = fan(gr)
    out = {"nodes": int(gr.nnods), "edges": int(A.nnz),
           "halo_rows": int(len(halo))}
    print(f"faithful 180x63 built in {t_build:.1f} s: {out}", flush=True)
    if not args.skip_dijkstra:
        t60, t150, secs = dijkstra_at(gr, A, halo, U, src)
        out["dijkstra"] = (t60, t150)
        print(f"  dijkstra t(60)={t60!r} t(150)={t150!r} ({secs:.1f} s)",
              flush=True)
        t60, t150, secs = dijkstra_at(gr, A, halo, U, src, "float32")
        print(f"  dijkstra on float32 weights t(60)={t60!r} t(150)={t150!r} "
              f"({secs:.1f} s)", flush=True)
    for dtype in ("float64", "float32"):
        t0 = time.perf_counter()
        solver = rt.AnnulusSolver(gr, A, halo, U, SolverConfig(dtype=dtype),
                                  method="sweep")
        D = solver.solve(src)
        d, prev = np.asarray(D.dist), np.asarray(D.prev)
        out["M"] = int(solver.circulant.cmap.M)
        out[dtype + " xla"] = (solver.last_iterations, at(gr, d, 60.0),
                               at(gr, d, 150.0), reaching(prev, src, recs))
        print(f"  {dtype} sweep, xla engine: {out[dtype + ' xla']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        dp, it = solve_circulant_sweep(
            solver.circulant, [src], SolverConfig(dtype=dtype),
            engine="pallas", interpret=True, _packed=solver._sweep_stencil)
        dp = np.asarray(dp)[0]
        prev = np.asarray(recover_prev_device(solver.circulant, dp))
        prev[src] = src
        out[dtype] = (it, at(gr, dp, 60.0), at(gr, dp, 150.0),
                      reaching(prev, src, recs))
        print(f"  {dtype} sweep, pallas engine: {out[dtype]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"FAITHFUL_180x63 = {out!r}", flush=True)

    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    U = velocity(gr, "iasp91", "Vs")
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    cli = {}
    if not args.skip_dijkstra:
        cli["dijkstra"] = dijkstra_at(gr, A, halo, U, src)[:2]
        cli["dijkstra_f32w"] = dijkstra_at(gr, A, halo, U, src, "float32")[:2]
    t0 = time.perf_counter()
    solver = rt.AnnulusSolver(gr, A, halo, U, SolverConfig(dtype="float64"),
                              method="sweep")
    d = np.asarray(solver.solve(src, want_prev=False).dist)
    cli["float64 xla"] = (solver.last_iterations, at(gr, d, 60.0),
                          at(gr, d, 150.0))
    dp, it = solve_circulant_sweep(
        solver.circulant, [src], SolverConfig(dtype="float64"),
        engine="pallas", interpret=True, _packed=solver._sweep_stencil)
    dp = np.asarray(dp)[0]
    cli["float64"] = (it, at(gr, dp, 60.0), at(gr, dp, 150.0))
    print(f"CLI_IASP91_VS = {cli!r}  # sweeps "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

if __name__ == "__main__":
    main()
