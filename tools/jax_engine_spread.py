"""The JAX package's 'wrapped' and 'diag' engines against its 'stream'
engine, on the CPU, at the grids where `auto` takes them.

    JAX_PLATFORMS=cpu python tools/jax_engine_spread.py

Prints, for 'wrapped' at 183x63 and 'diag' at 127x63 (spacing 20 km,
AK135 Vp, a surface source at theta=0): the engine's iterations, its
largest |field - stream field| over every node, and how far the engine
and the default-tol stream sit above or below a cold stream solve run to
tol = 1e-5.  The Pallas kernels run in interpret mode (about a minute in
all).  chip_smoke.py holds the PyTorch port on the card to the first two
figures (`JAX_SPREAD`): the same iterations and the same spread show
that the port reproduces the JAX package's floats at full size, and the
rest shows that the spread from 'stream' is the reference's own
(the termination residual of ROADMAP C.5, and for 'diag' the ring scan's
rounding below the fixpoint, ROADMAP C.7).  Imports the JAX package
only, never the port.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracer_tpu as rt  # noqa: E402
from raytracer_tpu.config import SolverConfig  # noqa: E402
from raytracer_tpu.ops.diag_circulant import solve_circulant_diag  # noqa: E402
from raytracer_tpu.ops.diag_wrapped import solve_circulant_wrapped  # noqa: E402
from raytracer_tpu.ops.stream_t import solve_circulant_stream  # noqa: E402
from raytracer_tpu.ops.wrapped_t import pack_twrapped_stencil  # noqa: E402


def main():
    f32 = SolverConfig(dtype="float32")
    tight = SolverConfig(dtype="float32", tol=1e-5, max_iters=5000,
                         warm_levels=0)
    for name, ntheta, solve in (("wrapped", 183, solve_circulant_wrapped),
                                ("diag", 127, solve_circulant_diag)):
        gr, cg, _ = rt.init_annulus_circulant(ntheta, 63, 20.0)
        src = rt.closest_point(gr, 0.0, rt.R, system="polar")
        t0 = time.perf_counter()
        d, iters = solve(cg, [src], f32, interpret=True)
        ws = pack_twrapped_stencil(cg, dtype=np.float32,
                                   band_closure=f32.band_closure)
        ds, its = solve_circulant_stream(cg, [src], f32, interpret=True,
                                         band_closure=f32.band_closure,
                                         _packed=ws)
        dt, itt = solve_circulant_stream(cg, [src], tight, interpret=True,
                                         band_closure=tight.band_closure,
                                         _packed=ws)
        d, ds, dt = d[0], ds[0], dt[0]
        print(f"{name} {ntheta}x63: {iters} iterations; max |{name} - "
              f"stream| = {float(np.abs(d - ds).max())!r} s (stream "
              f"{its} iterations); against stream at tol=1e-5 ({itt} "
              f"iterations): {name} at most {float((d - dt).max())!r} s "
              f"above and {float(-(d - dt).min())!r} s below, stream "
              f"{float((ds - dt).max())!r} s above "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
