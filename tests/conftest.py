"""Test harness config: run everything on a virtual 8-device CPU mesh.

Must set the env vars before jax initialises its backends, so this file
avoids importing jax at module scope until after os.environ is set.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

# A pytest plugin may import jax before this conftest runs, so the env var
# alone is not reliable; jax.config still works pre-backend-initialisation.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# Persistent on-disk compilation cache, shared by the xdist workers of a
# suite run (see run_tests.sh): repeated shapes compile once per run, not
# once per worker, and re-runs on the same machine skip compilation
# entirely.  Local to this machine (.cache is gitignored).
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache", "jax_test_cache")
jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np
import pytest

import raytracer_tpu as rt


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture(scope="session")
def tiny_annulus():
    """Small grid used across solver tests: ntheta=16, nr=6 (+7 forced)."""
    gr, A, halo = rt.init_annulus(16, 6, spacing=200.0)
    return gr, A, halo


@pytest.fixture(scope="session")
def tiny_velocity(tiny_annulus):
    gr, _, _ = tiny_annulus
    prof = rt.velocity_profile("ak135")
    interp = rt.LinearInterpolation(prof.r, prof.Vp)
    return rt.interpolate_velocity(gr.r, interp)
