"""Earthquake location on the annulus, end to end (the port's driver).

The counterpart of the root `example_location.py`, through the port's
entry points (solvers/locate.py):

  1. K station solves give every node's time to every station
     (reciprocity: the harmonic-mean weights are symmetric),
  2. a synthetic catalogue of events is "observed" on a 2x finer
     forward grid (so every event sits OFF the locator's lattice, like
     real data),
  3. the whole catalogue is located by one grid search with the origin
     time eliminated analytically (one launch of the `gridsearch` kernel
     on the card), then each event is refined off-lattice by a
     Gauss-Newton step on the eikonal gradients.

Runs on the card unless `--device cpu` is given.

    python -m raytracer_tpu_torch.example_location [--ntheta 64 --nr 16
        --noise 0.2 --events 8 --bend --device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .config import R, SolverConfig
from .models.annulus import closest_point, init_annulus
from .models.velocity import (LinearInterpolation, interpolate_velocity,
                              velocity_profile)
from .solvers.api import AnnulusSolver
from .solvers.locate import locate_many, station_fields


def run(ntheta=64, nr=16, spacing=120.0, noise=0.2, n_events=8,
        verbose=True, seed=11, bend=False, device="cuda"):
    """Locate `n_events` synthetic events; returns the mean distance of
    the grid-search nodes and of the refined positions to the truth (km)."""
    cfg = SolverConfig(dtype="float64")
    station_degs = np.arange(0.0, 360.0, 30.0)

    t0 = time.time()
    gr, A, halo = init_annulus(ntheta, nr, spacing=spacing)
    prof = velocity_profile("ak135")
    interp = LinearInterpolation(prof.r, prof.Vp)
    solver = AnnulusSolver(gr, A, halo, interpolate_velocity(gr.r, interp),
                           cfg, device=device)
    stations = [closest_point(gr, np.deg2rad(d), R, system="polar")
                for d in station_degs]
    fields = station_fields(solver, stations)
    if verbose:
        print(f"locator grid {gr.nnods} nodes, {len(stations)} stations "
              f"({time.time() - t0:.1f}s incl. {len(stations)} solves, "
              f"{solver.method} on {solver.device})")

    # synthetic truth on a 2x finer forward grid: off-lattice events
    grf, Af, halof = init_annulus(2 * ntheta, 2 * nr, spacing=spacing / 2)
    fine = AnnulusSolver(grf, Af, halof, interpolate_velocity(grf.r, interp),
                         cfg, device=device)
    st_fine = [closest_point(grf, np.deg2rad(d), R, system="polar")
               for d in station_degs]
    fields_fine = station_fields(fine, st_fine)

    rng = np.random.default_rng(seed)
    degs = rng.uniform(0.0, 360.0, n_events)
    deps = rng.uniform(50.0, 2500.0, n_events)
    events = [closest_point(grf, np.deg2rad(d), R - h, system="polar")
              for d, h in zip(degs, deps)]
    T_obs = np.stack([fields_fine[:, e] for e in events])
    T_obs += rng.normal(0.0, noise, T_obs.shape)

    locs = locate_many(solver, stations, T_obs,
                       sigma=[max(noise, 1e-3)] * len(stations),
                       fields=fields, bend=bend,
                       profile=(prof.r, prof.Vp) if bend else None)
    errs_node, errs_ref = [], []
    for loc, e in zip(locs, events):
        truth = np.array([grf.x[e], grf.z[e]])
        en = np.linalg.norm(np.array([gr.x[loc.node], gr.z[loc.node]])
                            - truth)
        er = np.linalg.norm(np.array([loc.x, loc.z]) - truth)
        errs_node.append(en)
        errs_ref.append(er)
        if verbose:
            print(f"event depth {R - np.hypot(*truth):7.1f} km: "
                  f"node err {en:6.1f} km -> refined {er:6.1f} km, "
                  f"rms {loc.rms:.2f} s")
    out = {"node_err": float(np.mean(errs_node)),
           "refined_err": float(np.mean(errs_ref))}
    if verbose:
        print(f"mean error: grid search {out['node_err']:.1f} km, "
              f"refined {out['refined_err']:.1f} km")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntheta", type=int, default=64)
    ap.add_argument("--nr", type=int, default=16)
    ap.add_argument("--spacing", type=float, default=120.0)
    ap.add_argument("--noise", type=float, default=0.2)
    ap.add_argument("--events", type=int, default=8)
    ap.add_argument("--bend", action="store_true",
                    help="bend-refine the model times at the best node "
                         "(removes the graph bias from the residuals)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.ntheta, args.nr, args.spacing, args.noise, args.events,
               bend=args.bend, device=args.device)


if __name__ == "__main__":
    main()
