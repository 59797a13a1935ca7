"""The JAX package's staged solvers on the CPU: the figures that
chip_smoke.py holds the PyTorch port's staged paths to on the card.

    JAX_PLATFORMS=cpu python tools/jax_staged_reference.py [--skip-ell]

On init_annulus(180, 63, spacing=20) with AK135 (Vp; Vs for the S legs),
float32, from the surface source at theta 0 (the sizes of the JAX
package's own record, benchmarks/tables.py bench_multistage), with the
Pallas kernels in interpret mode:
  * bfm_ms at levels (1, 15) on 'stream', 'sweep' and 'ell';
  * reflected_travel_times (PcP) on 'stream' and 'sweep';
  * phase_travel_times("SKS") (three packs) on 'stream' and 'sweep';
  * bfm_multiphase (3 levels, the boundary velocity swaps) on 'stream'
    and 'sweep', and on 'ell' at init_annulus(48, 12, spacing=150).
For each it prints one line: the staged solve's iteration count summed
over its stages (rounds on 'sweep'; on 'ell' each level's count), the
number of finite nodes, a sha256 of the finite mask and of `dist`
(float32 little-endian bytes; `prev` as int64 on 'ell'), and the times
at the surface receivers at 30, 60 and 90 degrees; then the same as one
Python dict, the constant `JAX_STAGED` of chip_smoke.py.  The iteration
counts are read by wrapping the JAX package's own staged solve entry
points, which the public functions call and then discard the count.
Takes about 10 minutes and ~6 GB on a CPU, most of it the compiles of
the interpret-mode sweep stages and the 180x63 ELL levels (`--skip-ell`
leaves the ELL levels out).  Imports the JAX package only, never the
port.
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
from raytracer_tpu.ops import stream_t as jst  # noqa: E402
from raytracer_tpu.ops import sweep_theta as jsw  # noqa: E402
from raytracer_tpu.solvers import multiphase as jmp  # noqa: E402
from raytracer_tpu.solvers import phases as jph  # noqa: E402

F32 = SolverConfig(dtype="float32")
DEGREES = (30.0, 60.0, 90.0)
_SEEN: list = []


def digest(a, dtype) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a), dtype=dtype).tobytes()).hexdigest()


def _spy(module, name):
    """Wrap module.name so that each call's second output (the iteration
    count) is appended to _SEEN."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        _SEEN.append(int(out[1]) if name != "_masked_solve_jit"
                     else int(out.it))
        return out

    setattr(module, name, wrapped)


for _mod, _name in ((jst, "solve_stream_staged"),
                    (jsw, "solve_sweep_staged"),
                    (jmp, "_masked_solve_jit")):
    _spy(_mod, _name)


def _tables(gr):
    prof = rt.velocity_profile("ak135")
    vp = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                              prof.Vp))
    vs = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                              prof.Vs))
    return prof, vp, vs


def _record(out, name, dist, receivers, t0, prev=None):
    its = list(_SEEN)
    _SEEN.clear()
    dist = np.asarray(dist)
    fin = np.isfinite(dist)
    it = its if name.endswith("ell") else sum(its)
    rec = (it, int(fin.sum()), digest(np.packbits(fin), "u1"),
           digest(dist, "<f4"),
           tuple(float(dist[r]) for r in receivers))
    if prev is not None:
        rec = rec + (digest(prev, "<i8"),)
    out[name] = rec
    print(f"{name}: iterations {it}, {rec[1]} finite, finite {rec[2]}, "
          f"dist {rec[3]}, t{DEGREES} = {rec[4]}"
          + (f", prev {rec[5]}" if prev is not None else "")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-ell", action="store_true")
    args = ap.parse_args(argv)
    out: dict = {}

    t0 = time.perf_counter()
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    prof, vp, vs = _tables(gr)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    rcv = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
           for d in DEGREES]
    print(f"init_annulus(180, 63): {gr.nnods} nodes, {A.nnz} edges, "
          f"{len(halo)} halo rows ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    levels = (1, 15)
    for method in ("stream", "sweep") + (() if args.skip_ell else ("ell",)):
        t0 = time.perf_counter()
        D = jmp.bfm_ms(A, halo, src, gr, vp, F32, levels=levels,
                       method=method, interpret=True, _reuse={})
        _record(out, f"bfm_ms {method}", D.dist, rcv, t0,
                prev=D.prev if method == "ell" else None)
    reuse: dict = {}
    for engine in ("stream", "sweep"):
        t0 = time.perf_counter()
        d = jph.reflected_travel_times(A, halo, src, gr, vp, "cmb", F32,
                                       interpret=True, _reuse=reuse,
                                       engine=engine)
        _record(out, f"PcP {engine}", d, rcv, t0)
    for engine in ("stream", "sweep"):
        t0 = time.perf_counter()
        d = jph.phase_travel_times(A, halo, src, gr, vp, "SKS", F32,
                                   interpret=True, Us=vs, _reuse=reuse,
                                   engine=engine)
        _record(out, f"SKS {engine}", d, rcv, t0)
    interp = rt.LinearInterpolation(prof.r, prof.Vp)
    for method in ("stream", "sweep"):
        t0 = time.perf_counter()
        D = jmp.bfm_multiphase(A, src, gr, vp, interpolant=interp,
                               config=F32, method=method, interpret=True)
        _record(out, f"bfm_multiphase {method}", D.dist, rcv, t0)
    t0 = time.perf_counter()
    gs, As, _ = rt.init_annulus(48, 12, spacing=150.0)
    _, vps, _ = _tables(gs)
    srcs = rt.closest_point(gs, 0.0, rt.R, system="polar")
    rcvs = [rt.closest_point(gs, np.deg2rad(d), rt.R, system="polar")
            for d in DEGREES]
    D = jmp.bfm_multiphase(As, srcs, gs, vps, interpolant=interp,
                           config=F32)
    _record(out, "bfm_multiphase 48x12 ell", D.dist, rcvs, t0, prev=D.prev)

    print("JAX_STAGED = {")
    for k, v in out.items():
        print(f"    {k!r}: {v!r},")
    print("}")


if __name__ == "__main__":
    main()
