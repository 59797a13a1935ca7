"""3-D spherical-shell demo of the port: a (theta, phi, r) wedge grid and
first-arrival travel times from a few surface sources through AK135 Vp,
printed as a small travel-time table.

    python -m raytracer_tpu_torch.example_grid3d [--n NT NP NR]
        [--depth KM] [--dtype float32|float64] [--engine stencil]
        [--device cuda|cpu]

The counterpart of the root `example_grid3d.py`, with the same flags and
defaults plus `--device` (default cuda).  The stencil engine is
`solve3d` under engine='auto', which takes the kernel engine
(`csrc/sweep3d.cu` on the card) for the star-1 stencil; the line before
the table names the route and the source batch.  `--engine ell` runs the
same solve on the generic ELL Bellman-Ford-Moore solver instead
(`nodal_incidence3d` -> `prepare` -> `solve_many`, the kernel
`csrc/ell_bfm.cu` on the card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .config import R, SolverConfig
from .models.grid3d import closest_point3d, grid3d, nodal_incidence3d
from .models.velocity import LinearInterpolation, velocity_profile
from .ops.circulant import resolve_device
from .solvers.bfm import prepare, solve_many
from .solvers.solve3d import (_auto_source_batch, prepare3d,
                              select_engine3d, solve3d)
from .utils.coords import spherical2cart

SOURCE_DEGREES = [(75.0, 75.0), (90.0, 90.0), (105.0, 105.0)]
RECEIVER_DEGREES = [(80.0, 80.0), (90.0, 75.0), (105.0, 95.0)]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs=3, default=[24, 24, 16],
                    metavar=("NT", "NP", "NR"))
    ap.add_argument("--depth", type=float, default=2000.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--engine", default="stencil", choices=["stencil", "ell"],
                    help="stencil = solve3d fast path; ell = generic ELL "
                         "BFM")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda)")
    return ap


def surface_nodes(g, degrees):
    """Closest grid node to each (theta, phi) surface point in degrees."""
    return [closest_point3d(g, *spherical2cart(np.deg2rad(a), np.deg2rad(b), R))
            for a, b in degrees]


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    c0 = (np.deg2rad(70.0), np.deg2rad(70.0), R - args.depth)
    c1 = (np.deg2rad(110.0), np.deg2rad(110.0), R)
    t0 = time.time()
    g = grid3d(c0, c1, args.n)
    print(f"grid: {g.nnods_total} nodes, {g.nel_total} hexa elements "
          f"({time.time()-t0:.1f}s)")

    prof = velocity_profile("ak135")
    U = LinearInterpolation(prof.r, prof.Vp)(g.r)
    cfg = SolverConfig(dtype=args.dtype)

    sources = surface_nodes(g, SOURCE_DEGREES)
    receivers = surface_nodes(g, RECEIVER_DEGREES)
    if args.engine == "stencil":
        packed = prepare3d(g, U, cfg, device=device)
        dtype = np.dtype(cfg.dtype)
        route = select_engine3d(packed, "auto", dtype)
        batch = (f", source batch {_auto_source_batch(packed.plan, dtype.itemsize, len(sources))}"
                 if route == "pallas" else "")
        t0 = time.time()
        table, iters = solve3d(g, U, sources, cfg, receivers=receivers,
                               _packed=packed, device=device)
        print(f"multi-source solve (stencil, engine {route}{batch}, on "
              f"{device}): {time.time()-t0:.2f}s ({iters} iterations)")
    else:
        A = nodal_incidence3d(g)
        print(f"graph: {A.nnz} edges")
        gdev = prepare(A, np.empty((0, 2), np.int64), g, U, cfg,
                       device=device)
        t0 = time.time()
        D = solve_many(gdev, sources, cfg)
        iters = None
        print(f"multi-source solve (ell, on {device}): "
              f"{time.time()-t0:.2f}s")
        table = D.dist[:, receivers]
    print("travel-time table (s):")
    for (a, b), row in zip(SOURCE_DEGREES, table):
        print(f"  src ({a:.0f},{b:.0f}) deg: " + "  ".join(f"{t:8.2f}" for t in row))
    return table, iters


if __name__ == "__main__":
    main()
