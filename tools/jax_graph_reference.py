"""The JAX package's generic-graph solvers on the CPU: the figures that
chip_smoke.py holds the PyTorch port's `bfm` and `banded` routes to on
the card.

    JAX_PLATFORMS=cpu python tools/jax_graph_reference.py [--skip-bfm]

Prints, each on a line of its own:
  * `bfm` on init_annulus(180, 63, spacing=20) (the reference's benchmark
    graph, bench.py) with AK135 Vp, float32, from the surface source at
    theta 0: its iterations, t(60) and t(150), how many of
    main_annulus's 150 receivers (2..150 degrees both sides) have a
    predecessor walk that reaches the source without a cycle (ROADMAP
    C.9), and a sha256 of `dist` and of `prev`;
  * `solve_banded` and `solve_banded_gs` (block 512, passes 2) on the
    production Delaunay annulus, add_midpoints(triangle_annulus_2d(
    nr=60, spacing=120)) with node_adjacency(star=0) and no halo
    (benchmarks/chip_banded_gs.py), float32, the same kind of source:
    iterations (rounds for gs) and a sha256 of the field;
  * `radius_stepping` on init_annulus(16, 6, spacing=200) (no halo, as
    the reference's radius stepping predates the twin merge), float32,
    from the surface source: iterations, computed here by replaying the
    solver's loop, and a sha256 of `dist` and `prev`.
A digest is sha256 over the array's little-endian bytes: `dist` as
float32, `prev` as int64.  Takes about 15 minutes and ~6 GB on one CPU
core, most of it the 180x63 bfm (`--skip-bfm` leaves it out).  Imports
the JAX package only, never the port.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import SolverConfig  # noqa: E402
from raytracer_tpu.models.annulus import node_adjacency  # noqa: E402
from raytracer_tpu.models.delaunay import (add_midpoints,  # noqa: E402
                                           triangle_annulus_2d)
from raytracer_tpu.ops.banded import (prepare_banded, solve_banded,  # noqa: E402
                                      solve_banded_gs)

F32 = SolverConfig(dtype="float32")


def digest(a, dtype) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a), dtype=dtype).tobytes()).hexdigest()


def _vp(gr):
    prof = rt.velocity_profile("ak135")
    return rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                                prof.Vp))


def _reaching(prev, source, receivers) -> int:
    n = 0
    for r in receivers:
        node, seen = r, set()
        while node != source and node not in seen:
            seen.add(node)
            node = int(prev[node])
        n += node == source
    return n


def bfm_180x63():
    t0 = time.perf_counter()
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    U = _vp(gr)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = rt.prepare(A, halo, gr, U, F32)
    t_prep = time.perf_counter() - t0
    from raytracer_tpu.solvers.bfm import _solve_jit

    t0 = time.perf_counter()
    st = _solve_jit(g, jax.numpy.asarray(src, jax.numpy.int32),
                    F32.max_iters, F32.dtype)
    dist = np.asarray(st.dist)[: g.n]
    prev = np.asarray(st.prev)[: g.n]
    t_solve = time.perf_counter() - t0
    degs = np.arange(2.0, 152.0, 2.0)
    degs = np.concatenate([degs, 360.0 - degs[::-1]])
    recs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in degs]
    t60 = float(dist[recs[int(np.argmin(np.abs(degs - 60.0)))]])
    t150 = float(dist[recs[int(np.argmin(np.abs(degs - 150.0)))]])
    print(f"bfm 180x63: {gr.nnods} nodes, {A.nnz} edges, {int(st.it)} "
          f"iterations, t(60) = {t60!r} s, t(150) = {t150!r} s, "
          f"{_reaching(prev, src, recs)} of {len(recs)} receiver walks "
          f"reach the source, dist {digest(dist, '<f4')}, prev "
          f"{digest(prev, '<i8')} (build {t_build:.1f} s, prepare "
          f"{t_prep:.1f} s, solve {t_solve:.1f} s)", flush=True)


def banded_delaunay():
    t0 = time.perf_counter()
    gr = add_midpoints(triangle_annulus_2d(nr=60, spacing=120.0))
    A = node_adjacency(gr, star=0)
    halo = np.empty((0, 2), np.int64)
    U = _vp(gr)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    bg = prepare_banded(A, halo, gr, U, F32)
    t_prep = time.perf_counter() - t0
    for name, fn in (("solve_banded", solve_banded),
                     ("solve_banded_gs", solve_banded_gs)):
        t0 = time.perf_counter()
        d, it = fn(bg, [src], F32)
        print(f"{name} delaunay: {gr.nnods} nodes, {A.nnz} edges, "
              f"{len(bg.offsets_np)} offsets, source {src}, {it} "
              f"iterations, dist {digest(d[0], '<f4')} (build+prepare "
              f"{t_prep:.1f} s, solve {time.perf_counter() - t0:.1f} s)",
              flush=True)


def radius_stepping_16x6():
    from raytracer_tpu.solvers.radius_stepping import _solve_jit

    gr, A, _ = rt.init_annulus(16, 6, spacing=200.0)
    U = _vp(gr)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    g = rt.prepare(A, np.empty((0, 2), np.int64), gr, U, F32)
    st = _solve_jit(g, jax.numpy.asarray(src, jax.numpy.int32),
                    F32.max_iters, F32.dtype)
    D = rt.radius_stepping(A, np.empty((0, 2), np.int64), src, gr, U, F32)
    print(f"radius_stepping 16x6: {gr.nnods} nodes, {int(st.it)} "
          f"iterations, dist {digest(D.dist, '<f4')}, prev "
          f"{digest(D.prev, '<i8')}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-bfm", action="store_true")
    args = ap.parse_args()
    radius_stepping_16x6()
    banded_delaunay()
    if not args.skip_bfm:
        bfm_180x63()


if __name__ == "__main__":
    main()
