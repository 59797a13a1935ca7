"""End-to-end driver of the PyTorch port (the main path).

Builds the AK135 annulus with the O(M) circulant builder, solves the
travel-time field from a surface source with the chosen engine
(`--method`, the JAX driver's choices; 'auto' takes the directional
sweep, or the JAX package's Jacobi route on a grid without sweep
support, and methods not ported yet raise naming their ROADMAP item),
reconstructs ray paths to the receiver fan (2..150 deg both
sides), and writes the travel-time CSV and the npz archive to
`--out-prefix`.  Runs on the card unless `--device cpu` is given.

    python -m raytracer_tpu_torch.main_annulus --ntheta 180 --nr 63
    python -m raytracer_tpu_torch.main_annulus --method wrapped
    python -m raytracer_tpu_torch.main_annulus --nr 63 --method pallas
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .config import R
from .models.annulus import closest_point
from .models.fast_annulus import init_annulus_circulant
from .solvers.api import AnnulusSolver
from .solvers.path import recontruct_path
from .utils.io import save_solution_npz, travel_times


def receiver_degrees() -> np.ndarray:
    """2..150 deg on both sides of the source."""
    degs = np.arange(2.0, 152.0, 2.0)
    return np.concatenate([degs, 360.0 - degs[::-1]])


def build_parser() -> argparse.ArgumentParser:
    """The CLI's options; each one the JAX package's main_annulus.py also
    has keeps its default (the 180x50 grid)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntheta", type=int, default=180)
    ap.add_argument("--nr", type=int, default=50)
    ap.add_argument("--spacing", type=float, default=20.0)
    ap.add_argument("--method", default="auto",
                    choices=["auto", "sweep", "stream", "twrapped", "wrapped",
                             "diag", "circulant", "pallas", "fused", "banded",
                             "ell"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-prefix", default="annulus_run")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    times = {}

    def section(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
        return out

    gr, cg, U = section("init_annulus_circulant", lambda: init_annulus_circulant(
        args.ntheta, args.nr, spacing=args.spacing))
    print(f"grid: {gr.nnods} nodes, {cg.M} slots per column")
    source = closest_point(gr, 0.0, R, system="polar")

    solver = section("solver pack", lambda: AnnulusSolver(
        gr, None, None, U, method=args.method, circulant=cg,
        device=args.device))
    print(f"solver method: {solver.method} on {solver.device}")

    section("solve (first)", lambda: solver.solve(source, want_prev=False))
    section("solve (steady)", lambda: solver.solve(source, want_prev=False))
    D = section("solve + prev recovery", lambda: solver.solve(source))
    unit = "rounds" if solver.method == "sweep" else "iterations"
    print(f"Converged in {solver.last_iterations} {unit}")

    degs = receiver_degrees()
    receivers = [closest_point(gr, np.deg2rad(d), R, system="polar")
                 for d in degs]
    paths = section("paths", lambda: [recontruct_path(D.prev, source, rec)
                                      for rec in receivers])
    tt = section("outputs", lambda: travel_times(
        D, gr, receivers, isave=True,
        flname=f"{args.out_prefix}_travel_times.csv"))
    save_solution_npz(f"{args.out_prefix}.npz", D, gr, source, paths)

    for name, t in times.items():
        print(f"{name:>24s}: {t:.4f} s")
    print(f"travel time at  60 deg: {tt[np.argmin(np.abs(degs - 60.0))]:.3f} s")
    print(f"travel time at 150 deg: {tt[np.argmin(np.abs(degs - 150.0))]:.3f} s")


if __name__ == "__main__":
    main()
