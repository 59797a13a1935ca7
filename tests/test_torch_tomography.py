"""PyTorch port: the linearized tomography driver against the root one.

At 32x8 (spacing 250 km, 8 sources x 24 receivers, as
tests/test_tomography.py), float64: the port's sensitivity matrix G
(its `assemble_G` on its own background solves) equals the root
example's within 1e-12 relative to its largest entry; the misfit before
inversion equals the JAX run's within 1e-9 relative, the misfit after it
within 1e-6 relative, and the checkerboard correlation within 1e-4 (the
perturbed model has no circulant layout: the port's solver falls back to
'banded', the JAX package's off its accelerator to 'ell', whose fields
agree to rounding; and the 200 CG iterations stop short of convergence,
so the recovered dU carries that rounding as ~3e-5 of U).  The port's
CG equals `jax.scipy.sparse.linalg.cg` on a small system.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import example_tomography as je                            # noqa: E402
import raytracer_tpu as rt                                 # noqa: E402
from raytracer_tpu.config import SolverConfig as JC        # noqa: E402
from raytracer_tpu_torch import example_tomography as pe   # noqa: E402
from raytracer_tpu_torch.config import SolverConfig as PC  # noqa: E402
from jax_mappings import below_the_map_limit  # noqa: F401,E402

ARGS = (32, 8, 250.0)
KW = dict(verbose=False, n_src=8, n_rec=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = je.run(*ARGS, **KW)
        got = pe.run(*ARGS, device="cpu", **KW)
    return want, got


def test_sensitivity_matrix_equals_jax(runs):
    _, got = runs
    ntheta, nr, spacing = ARGS
    gr, A, halo = rt.init_annulus(ntheta, nr, spacing=spacing)
    prof = rt.velocity_profile("ak135")
    U0 = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                              prof.Vp))
    srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(0.0, 330.0, KW["n_src"])]
    recs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(5.0, 355.0, KW["n_rec"])]
    _, prevs = je.forward(gr, A, halo, U0, JC(dtype="float64"), srcs, recs)
    Gj = np.asarray(je.assemble_G(gr, halo, U0, prevs, srcs, recs,
                                  4 * (ntheta + nr)))
    Gp = got["G"].numpy()
    assert Gp.shape == Gj.shape == (KW["n_src"] * KW["n_rec"], gr.nnods)
    assert float(np.abs(Gp - Gj).max()) <= 1e-12 * float(np.abs(Gj).max())


def test_misfit_and_correlation_equal_jax(runs):
    want, got = runs
    np.testing.assert_allclose(got["misfit0"], want["misfit0"], rtol=1e-9)
    np.testing.assert_allclose(got["misfit1"], want["misfit1"], rtol=1e-6)
    assert abs(got["corr"] - want["corr"]) < 1e-4
    np.testing.assert_array_equal(got["covered"], want["covered"])
    # the root test's own bars
    assert got["misfit1"] < 0.1 * got["misfit0"]
    assert got["corr"] > 0.25 and got["covered"].sum() > 100


def test_cg_equals_jax():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(30, 30))
    A = M @ M.T / 30 + np.eye(30)     # well conditioned: no rounding blow-up
    b = rng.normal(size=30)
    for maxiter in (1, 3, 200):
        want = np.asarray(jax.scipy.sparse.linalg.cg(
            lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
            maxiter=maxiter)[0])
        At = torch.as_tensor(A)
        got = pe.cg(lambda v: At @ v, torch.as_tensor(b), maxiter=maxiter)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-14)
