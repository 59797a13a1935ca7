"""Linearized travel-time tomography on the annulus, end to end (the port's
counterpart of the root `example_tomography.py`).

  1. forward-solve a perturbed Earth (checkerboard velocity anomaly) for
     "observed" first-arrival times over a source/receiver fan,
  2. trace rays in the AK135 background and assemble the exact
     sensitivity matrix G[ray, node] = dt/dU (solvers/sensitivity.py: the
     `paths` kernel on the card),
  3. invert the travel-time residuals with damped normal equations solved
     by conjugate gradients (the JAX example's `jax.scipy.sparse.linalg.cg`
     with maxiter 200, written out in torch; the products are
     `torch.matmul`).

Linearized (single-iteration) tomography: rays are traced in the
background model, exact to first order by Fermat's principle.  Runs on
the card unless `--device cpu` is given.

    python -m raytracer_tpu_torch.example_tomography [--ntheta 64 --nr 16
        --spacing 100 --device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .config import DISCONTINUITY_RADII, R, SolverConfig
from .models.annulus import closest_point, init_annulus
from .models.velocity import (LinearInterpolation, interpolate_velocity,
                              velocity_profile)
from .ops.circulant import resolve_device
from .solvers.api import AnnulusSolver
from .solvers.sensitivity import sensitivity_matrix

R_CMB = DISCONTINUITY_RADII[-1]        # 2891.5 km depth


def checkerboard(gr, amplitude=0.03, k_theta=6, n_r=4):
    """Multiplicative +-amplitude cells over the mantle (r > R_CMB);
    zero in the core where this fan has no coverage."""
    theta = np.asarray(gr.theta)
    r = np.asarray(gr.r)
    band = (r - R_CMB) / (R - R_CMB)
    cell = np.sign(np.sin(k_theta * theta) * np.sin(np.pi * n_r * band))
    return np.where(r > R_CMB, amplitude * cell, 0.0)


def forward(gr, A, halo, U, cfg, sources, receivers, device):
    """(n_src, n_rec) first-arrival times + per-source prev trees."""
    solver = AnnulusSolver(gr, A, halo, U, cfg, device=device)
    T = np.empty((len(sources), len(receivers)))
    prevs = []
    for i, s in enumerate(sources):
        D = solver.solve(s)
        T[i] = D.dist[receivers]
        prevs.append(D.prev)
    return T, prevs


def assemble_G(gr, halo, U, prevs, sources, receivers, max_len, device):
    """Stack per-source sensitivity matrices: (n_rays, n) on `device`."""
    blocks = [sensitivity_matrix(gr, U, prev, s, receivers, max_len, halo,
                                 device=device)
              for s, prev in zip(sources, prevs)]
    return torch.cat(blocks, dim=0)


def cg(A, b: torch.Tensor, maxiter: int, tol: float = 1e-5,
       atol: float = 0.0) -> torch.Tensor:
    """Conjugate gradients from x0 = 0 for the symmetric positive definite
    operator `A` (a function of a vector), the recurrences and stopping
    rule of `jax.scipy.sparse.linalg.cg` (no preconditioner): stop once
    r.r <= max(tol^2 b.b, atol^2) or after `maxiter` iterations."""
    bs = torch.dot(b, b)
    atol2 = max(tol ** 2 * float(bs), atol ** 2)
    x = torch.zeros_like(b)
    r = b - A(x)
    p = r
    gamma = torch.dot(r, r)
    k = 0
    while float(gamma) > atol2 and k < maxiter:
        Ap = A(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = torch.dot(r, r)
        beta = gamma_ / gamma
        p = r + beta * p
        gamma = gamma_
        k += 1
    return x


def invert(G: torch.Tensor, residual: torch.Tensor,
           damping: float) -> torch.Tensor:
    """Damped least squares dU = argmin ||G dU - r||^2 + damp^2||dU||^2
    via CG on the normal equations (all dense matmuls)."""
    GtG = G.T @ G
    rhs = G.T @ residual
    n = GtG.shape[0]
    Areg = GtG + (damping ** 2) * torch.eye(n, dtype=G.dtype,
                                            device=G.device)
    return cg(lambda v: Areg @ v, rhs, maxiter=200)


def run(ntheta=64, nr=16, spacing=100.0, amplitude=0.03, verbose=True,
        n_src=12, n_rec=36, device="cuda"):
    dev = resolve_device(device)
    cfg = SolverConfig(dtype="float64")
    t0 = time.time()
    gr, A, halo = init_annulus(ntheta, nr, spacing=spacing)
    prof = velocity_profile("ak135")
    interp = LinearInterpolation(prof.r, prof.Vp)
    U0 = interpolate_velocity(gr.r, interp)           # background
    anomaly = checkerboard(gr, amplitude)
    U_true = U0 * (1.0 + anomaly)

    degs_src = np.linspace(0.0, 330.0, n_src)
    degs_rec = np.linspace(5.0, 355.0, n_rec)
    sources = [closest_point(gr, np.deg2rad(d), R, system="polar")
               for d in degs_src]
    receivers = [closest_point(gr, np.deg2rad(d), R, system="polar")
                 for d in degs_rec]
    if verbose:
        print(f"grid {gr.nnods} nodes, {len(sources)} sources x "
              f"{len(receivers)} receivers  (build {time.time()-t0:.1f}s)")

    T_obs, _ = forward(gr, A, halo, U_true, cfg, sources, receivers, dev)
    T_bg, prevs = forward(gr, A, halo, U0, cfg, sources, receivers, dev)
    residual = torch.as_tensor((T_obs - T_bg).ravel(), device=dev)

    max_len = 4 * (ntheta + nr)
    G = assemble_G(gr, halo, U0, prevs, sources, receivers, max_len, dev)

    # scale damping to the problem: a few percent of the typical
    # diagonal keeps the checkerboard while suppressing null-space noise
    damping = 0.05 * float(torch.sqrt(torch.mean(torch.sum(G * G, dim=0))))
    dU = invert(G, residual, damping)

    pred = G @ dU
    mis0 = float(torch.linalg.norm(residual))
    mis1 = float(torch.linalg.norm(residual - pred))
    rec_frac = dU.cpu().numpy() / U0                  # recovered dU/U
    covered = (G != 0).sum(dim=0).cpu().numpy() >= 3
    corr = np.corrcoef(rec_frac[covered], anomaly[covered])[0, 1]
    if verbose:
        print(f"rays {G.shape[0]}, covered nodes {covered.sum()}/{gr.nnods}")
        print(f"misfit {mis0:.2f} -> {mis1:.2f} s "
              f"({100 * (1 - mis1 / mis0):.0f}% reduction)")
        print(f"checkerboard correlation (covered nodes): {corr:.2f}")
    return {"misfit0": mis0, "misfit1": mis1, "corr": corr,
            "covered": covered, "rec_frac": rec_frac, "anomaly": anomaly,
            "G": G}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntheta", type=int, default=64)
    ap.add_argument("--nr", type=int, default=16)
    ap.add_argument("--spacing", type=float, default=100.0)
    ap.add_argument("--amplitude", type=float, default=0.03)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.ntheta, args.nr, args.spacing, args.amplitude,
               device=args.device)


if __name__ == "__main__":
    main()
