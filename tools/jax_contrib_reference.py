"""The JAX package's quarantined 'pallas' and 'fused' engines on the CPU at
180x63, against its 'twrapped' engine run to tol = 1e-5.

    JAX_PLATFORMS=cpu python tools/jax_contrib_reference.py

Prints, at 180x63 (spacing 20 km, AK135 Vp, the surface source at
theta=0): the iterations of `solve_circulant_pallas` (the fused engine
returns -1), each engine's travel times at 60 and 150 degrees, how far
each field sits above and below a cold 'twrapped' solve at tol = 1e-5,
how many of the 150 receivers of main_annulus's fan (2..150 degrees both
sides) have a predecessor path (`recover_prev_device`) that reaches the
source without a cycle, and the largest difference between the two
engines.  The Pallas kernels run in interpret mode (about a minute in
all).  chip_smoke.py holds the
PyTorch port on the card to these figures (`JAX_CONTRIB`): the same
iterations and the same spread show that the port reproduces the JAX
package's floats at full size.  The pallas field sits below the tight
solve because its ring scan's closed form rounds below the fixpoint
(ROADMAP C.7); the fused loop runs until no value falls and sits just
above it.  The rounding also leaves most predecessor paths of the
pallas field in cycles; zero-weight twin links with equal travel times
close a few 2-cycles in the other fields (ROADMAP C.9).  Imports the JAX
package only, never the port.
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
from raytracer_tpu.contrib.fused_circulant import solve_circulant_fused  # noqa: E402
from raytracer_tpu.contrib.pallas_circulant import solve_circulant_pallas  # noqa: E402
from raytracer_tpu.ops.circulant import recover_prev_device  # noqa: E402


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


def main():
    f32 = SolverConfig(dtype="float32")
    tight = SolverConfig(dtype="float32", tol=1e-5, max_iters=5000)
    gr, cg, U = rt.init_annulus_circulant(180, 63, 20.0)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    recs = {deg: rt.closest_point(gr, np.deg2rad(deg), rt.R, system="polar")
            for deg in (60.0, 150.0)}
    degs = np.arange(2.0, 152.0, 2.0)
    fan = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
           for d in np.concatenate([degs, 360.0 - degs[::-1]])]
    t0 = time.perf_counter()
    # the AnnulusSolver route, as chip_smoke.py takes it (band closure 1)
    twrapped = rt.AnnulusSolver(gr, None, None, U, tight, method="twrapped",
                                circulant=cg)
    dt = twrapped.solve(src, want_prev=False).dist
    itt = twrapped.last_iterations
    print(f"twrapped 180x63 at tol=1e-5: {itt} iterations "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    fields = {}
    for name, solve in (("pallas", solve_circulant_pallas),
                        ("fused", solve_circulant_fused)):
        t0 = time.perf_counter()
        d, iters = solve(cg, [src], f32, interpret=True)
        d = fields[name] = d[0]
        prev = np.asarray(recover_prev_device(cg, d))
        prev[src] = src
        print(f"{name} 180x63: {iters} iterations; t(60)={float(d[recs[60.0]])!r}"
              f" s, t(150)={float(d[recs[150.0]])!r} s; against twrapped at "
              f"tol=1e-5: at most {float((d - dt).max())!r} s above and "
              f"{float(-(d - dt).min())!r} s below; {reaching(prev, src, fan)} "
              f"of {len(fan)} receiver paths reach the source "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print("max |pallas - fused| = "
          f"{float(np.abs(fields['pallas'] - fields['fused']).max())!r} s",
          flush=True)


if __name__ == "__main__":
    main()
