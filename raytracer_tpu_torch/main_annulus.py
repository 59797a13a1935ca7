"""End-to-end driver of the PyTorch port (the main path).

Builds the annulus with the O(M) circulant builder (with `--method ell`
or `banded`, `--phases` or `--cache-dir`, the materialised graph of
init_annulus, as the JAX driver builds it), samples the velocity of
`--model` (ak135, iasp91, ak135-true) and `--wave` (Vp, Vs) on its
nodes, solves the travel-time field from a surface source with the
chosen engine (`--method`, the JAX driver's choices; 'auto' takes the
directional sweep, or the JAX package's Jacobi route on a grid without
sweep support), reconstructs ray paths to the receiver fan (2..150 deg
both sides), writes the travel-time CSV and the npz archive to
`--out-prefix` and prints the sections' times (`utils.timing.Timer`).
Runs on the card unless `--device cpu` is given.

    python -m raytracer_tpu_torch.main_annulus --ntheta 180 --nr 63
    python -m raytracer_tpu_torch.main_annulus --method wrapped
    python -m raytracer_tpu_torch.main_annulus --nr 63 --method pallas
    python -m raytracer_tpu_torch.main_annulus --nr 63 --dtype float64
    python -m raytracer_tpu_torch.main_annulus --nr 63 --method ell
    python -m raytracer_tpu_torch.main_annulus --nr 63 --phases PcP,SKS
    python -m raytracer_tpu_torch.main_annulus --nr 63 --refine
    python -m raytracer_tpu_torch.main_annulus --nr 63 --refine --q 600
    python -m raytracer_tpu_torch.main_annulus --nr 63 --model iasp91 --wave Vs
    python -m raytracer_tpu_torch.main_annulus --nr 63 --cache-dir .cache --plot

`--cache-dir DIR` keeps the built grid (`utils.cache.init_annulus_cached`)
and the circulant stencil (`AnnulusSolver(cache_dir=)`) in DIR, with the
JAX package's file names and keys, so either package reads the other's.
`--plot` writes `<prefix>_ray_paths.png` (`utils.plotting.plot_paths`);
it needs matplotlib and refuses by name before any solve where that
cannot be imported.

`--refine` adds `<prefix>_travel_times_refined.csv` (header
`deg,refined_s`): the fan's paths bent to the continuous Fermat minimum
under the `--model` table of `--wave` (solvers/refine.py, the `bend`
kernel on the card), in the CLI's `--dtype`.

`--q Q` (with `--freq`, 1 Hz by default) adds `<prefix>_amplitude.csv`
(header `deg,tstar_s,spreading_km,rel_amp,pcp_p_ratio,valid`, the JAX
driver's): t* at the constant quality factor Q along the bent polylines
when `--refine` ran, along the graph backtraces otherwise
(models/amplitude.py); the geometrical spreading of the flattened
piecewise-linear model (models/flatearth.py, 8000 ray parameters,
diffracted past the CMB); the relative amplitude; the PcP/P amplitude
ratio (models/zoeppritz.py); NaN with valid = 0 in the core shadow,
where the first arrival is diffracted.  All of it under `--model` and
`--wave`, the spreading diffracted at that model's CMB.

`--phases` adds `<prefix>_phases.csv`: one first-arrival column per
named phase over the receiver fan (solvers/phases.py; NaN where the
phase has no arrival), the Vp or Vs table chosen per phase as the JAX
driver does, from the `--model` tables; it builds the materialised graph
the phases need.
"""
from __future__ import annotations

import argparse

import numpy as np

from .config import R, SolverConfig
from .models.annulus import closest_point, init_annulus
from .models.fast_annulus import init_annulus_circulant
from .models.velocity import (LinearInterpolation, interpolate_velocity,
                              velocity_profile)
from .solvers.api import AnnulusSolver
from .solvers.path import recontruct_path
from .utils.io import save_solution_npz, travel_times
from .utils.timing import Timer


def receiver_degrees() -> np.ndarray:
    """2..150 deg on both sides of the source."""
    degs = np.arange(2.0, 152.0, 2.0)
    return np.concatenate([degs, 360.0 - degs[::-1]])


def build_parser() -> argparse.ArgumentParser:
    """The CLI's options; each one the JAX package's main_annulus.py also
    has keeps its default (the 180x50 grid, AK135 Vp)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntheta", type=int, default=180)
    ap.add_argument("--nr", type=int, default=50)
    ap.add_argument("--spacing", type=float, default=20.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--model", default="ak135")
    ap.add_argument("--wave", default="Vp", choices=["Vp", "Vs"])
    ap.add_argument("--method", default="auto",
                    choices=["auto", "sweep", "stream", "twrapped", "wrapped",
                             "diag", "circulant", "pallas", "fused", "banded",
                             "ell"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-prefix", default="annulus_run")
    ap.add_argument("--plot", action="store_true",
                    help="write <prefix>_ray_paths.png (needs matplotlib)")
    ap.add_argument("--refine", action="store_true",
                    help="bend the receiver-fan paths to the continuous "
                         "Fermat minimum (solvers/refine.py) and write "
                         "<prefix>_travel_times_refined.csv")
    ap.add_argument("--q", type=float, default=None,
                    help="constant quality factor; writes "
                         "<prefix>_amplitude.csv with per-receiver t*, "
                         "geometrical spreading and relative amplitude "
                         "(models/amplitude.py)")
    ap.add_argument("--freq", type=float, default=1.0,
                    help="frequency (Hz) for the t* spectral decay")
    ap.add_argument("--phases", default=None,
                    help="comma-separated named phases (PcP,ScS,PP,SKS,"
                         "SKP,PKS,PKP,PKIKP,Pdiff,Sdiff,P,S); writes "
                         "<prefix>_phases.csv with one first-arrival "
                         "column per phase over the receiver fan "
                         "(solvers/phases.py; NaN where the phase has "
                         "no arrival)")
    ap.add_argument("--cache-dir", default=None,
                    help="disk cache for built grids and packed stencils "
                         "(e.g. .cache; the JAX package's file names)")
    return ap


def write_phases(args, gr, A, halo, source, receivers, degs, cfg):
    """The `--phases` table: one column per phase, Vs for the S phases,
    Vp and Vs for the converted ones, one `_reuse` dict across them."""
    from .solvers.phases import phase_travel_times

    prof = velocity_profile(args.model)
    Vp_tab = interpolate_velocity(gr.r, LinearInterpolation(prof.r, prof.Vp))
    Vs_tab = interpolate_velocity(gr.r, LinearInterpolation(prof.r, prof.Vs))
    reuse: dict = {}
    cols, names = [degs], ["deg"]
    for name in [s.strip() for s in args.phases.split(",") if s.strip()]:
        p = name.upper()
        Utab = Vs_tab if p in ("S", "SDIFF", "SCS") else Vp_tab
        Ustab = Vs_tab if p in ("SKS", "SKP", "PKS") else None
        t = np.asarray(phase_travel_times(
            A, halo, source, gr, Utab, name, cfg, receivers=receivers,
            device=args.device, Us=Ustab, _reuse=reuse), dtype=np.float64)
        cols.append(np.where(np.isfinite(t), t, np.nan))
        names.append(name)
    np.savetxt(f"{args.out_prefix}_phases.csv", np.stack(cols, axis=1),
               delimiter=",", header=",".join(names) + "\n# NaN = phase "
               "has no arrival at that receiver (outside its region or "
               "branch)", comments="")


def write_refined(args, gr, paths, degs):
    """The `--refine` CSV: the fan's SPM polylines bent at the JAX
    driver's defaults (`refine_paths_batch`: m 128, 800 steps, quad 8,
    lr 3) under the `--model` table of `--wave`, in the CLI's dtype, on
    its device; returns the bent polylines (n_paths, 128, 2), which `--q`
    integrates t* along, and the refined times."""
    from .solvers.refine import refine_paths_batch

    prof = velocity_profile(args.model)
    pts = [np.stack([gr.x[p], gr.z[p]], axis=1) for p in paths]
    pts_bent, t_ref = refine_paths_batch(pts, prof.r,
                                         getattr(prof, args.wave),
                                         dtype=args.dtype, device=args.device)
    np.savetxt(f"{args.out_prefix}_travel_times_refined.csv",
               np.stack([degs, t_ref], axis=1), delimiter=",",
               header="deg,refined_s", comments="")
    return pts_bent, t_ref


def write_amplitude(args, gr, paths, degs, pts_bent=None):
    """The `--q` CSV, as the JAX driver writes it: t* along the bent
    polylines when `--refine` gave them (so the amplitude and refined CSVs
    share one geometry), along the graph backtraces otherwise; the
    spreading of the flattened model with the branch diffracted at the
    model's CMB; NaN and valid = 0 where the first arrival is diffracted."""
    from .models.amplitude import attenuation_factor, tstar
    from .models.flatearth import RadialModel, cmb_radius
    from .models.zoeppritz import pcp_p_amplitude_ratio

    prof = velocity_profile(args.model)
    v = getattr(prof, args.wave)
    dd = np.minimum(degs, 360.0 - degs)   # mirrored fan side
    Rg = RadialModel(prof.r, v).spreading(
        dd, n_p=8000, diff_radii=(cmb_radius(args.model),))
    if pts_bent is not None:
        polylines = list(pts_bent)
    else:
        polylines = [np.stack([gr.x[p], gr.z[p]], axis=1) for p in paths]
    ts = np.array([tstar(pl, prof.r, v, args.q) for pl in polylines])
    valid = np.isfinite(Rg)
    amp = np.where(valid, attenuation_factor(ts, args.freq)
                   / np.where(valid, Rg, 1.0), np.nan)
    pcp_ratio = pcp_p_amplitude_ratio(dd, model=args.model, q_factor=args.q,
                                      freq_hz=args.freq)
    np.savetxt(
        f"{args.out_prefix}_amplitude.csv",
        np.stack([degs, ts, np.where(valid, Rg, np.nan), amp, pcp_ratio,
                  valid.astype(float)], axis=1), delimiter=",",
        header="deg,tstar_s,spreading_km,rel_amp,pcp_p_ratio,valid\n"
               "# spreading/rel_amp are NaN with valid=0 where the "
               "first arrival is interface-diffracted (core shadow); "
               "pcp_p_ratio is NaN beyond the PcP branch",
        comments="")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.plot:
        from .utils.plotting import require_matplotlib

        require_matplotlib()     # refuse before any solve

    timer = Timer()
    cfg = SolverConfig(dtype=args.dtype)
    with timer.section("velocity"):
        prof = velocity_profile(args.model)
        interp = LinearInterpolation(prof.r, getattr(prof, args.wave))

    if args.method in ("ell", "banded") or args.phases or args.cache_dir:
        with timer.section("init_annulus"):
            if args.cache_dir:
                from .utils.cache import init_annulus_cached

                gr, A, halo = init_annulus_cached(
                    args.ntheta, args.nr, spacing=args.spacing,
                    cache_dir=args.cache_dir)
            else:
                gr, A, halo = init_annulus(args.ntheta, args.nr,
                                           spacing=args.spacing)
        print(f"grid: {gr.nnods} nodes, {gr.nel} elements, {A.nnz} "
              f"directed edges")
        U = interpolate_velocity(gr.r, interp)
        cg = None   # the solver builds its layout from (A, halo)
    else:
        with timer.section("init_annulus_circulant"):
            gr, cg, U = init_annulus_circulant(
                args.ntheta, args.nr, spacing=args.spacing,
                velocity=lambda rr: interpolate_velocity(rr, interp),
                dtype=cfg.dtype)
        A = halo = None
        print(f"grid: {gr.nnods} nodes, {cg.M} slots per column")
    source = closest_point(gr, 0.0, R, system="polar")

    with timer.section("solver pack"):
        solver = AnnulusSolver(gr, A, halo, U, cfg, method=args.method,
                               cache_dir=args.cache_dir, circulant=cg,
                               device=args.device)
    print(f"solver method: {solver.method} on {solver.device}")

    with timer.section("solve (first)"):
        solver.solve(source, want_prev=False)
    with timer.section("solve (steady)"):
        solver.solve(source, want_prev=False)
    with timer.section("solve + prev recovery"):
        D = solver.solve(source)
    if solver.last_iterations:   # 'ell' keeps its count, as in the JAX driver
        unit = "rounds" if solver.method == "sweep" else "iterations"
        print(f"Converged in {solver.last_iterations} {unit}")

    degs = receiver_degrees()
    with timer.section("receivers+paths"):
        receivers = [closest_point(gr, np.deg2rad(d), R, system="polar")
                     for d in degs]
        paths = [recontruct_path(D.prev, source, rec) for rec in receivers]
    with timer.section("outputs"):
        tt = travel_times(D, gr, receivers, isave=True,
                          flname=f"{args.out_prefix}_travel_times.csv")
        save_solution_npz(f"{args.out_prefix}.npz", D, gr, source, paths)
        if args.plot:
            from .utils.plotting import plot_paths

            plot_paths(gr, paths, source, receivers,
                       fname=f"{args.out_prefix}_ray_paths.png")
    pts_bent = t_ref = None
    if args.refine:
        with timer.section("bending refinement"):
            pts_bent, t_ref = write_refined(args, gr, paths, degs)
    if args.q is not None:
        with timer.section("amplitude"):
            write_amplitude(args, gr, paths, degs, pts_bent)
    if args.phases:
        with timer.section("named phases"):
            write_phases(args, gr, A, halo, source, receivers, degs, cfg)

    print(timer.report())
    print(f"travel time at  60 deg: {tt[np.argmin(np.abs(degs - 60.0))]:.3f} s")
    print(f"travel time at 150 deg: {tt[np.argmin(np.abs(degs - 150.0))]:.3f} s")
    if t_ref is not None:
        print(f"refined     at  60 deg: "
              f"{t_ref[np.argmin(np.abs(degs - 60.0))]:.3f} s")
    return timer


if __name__ == "__main__":
    main()
