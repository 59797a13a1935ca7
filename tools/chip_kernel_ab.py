"""Time two versions of the port's rsweep and sweep3d kernels in turns on
one NVIDIA GPU: the sources in the package's csrc/ and an earlier copy.

    python3 tools/chip_kernel_ab.py --old DIR [--reps N] [--tiles]
        [--breakdown] [--ptxas]

DIR holds an earlier `rsweep.cu` and `sweep3d.cu` with the earlier
launch interfaces - rsweep_launch(buf, wtab, taps, n_taps, s, mt, k8,
ntl, ntb, d, upward, stream) and sweep3d_launch(in, w4, out, scratch, s,
n1, br, nb, l0, t, is_double, stream) - unpacked from an earlier commit
(e.g. `git archive <commit> raytracer_tpu_torch/csrc`) into a directory
that .gitignore lists.  Both versions are built with the
package's nvcc flags into a temporary directory, run on the same inputs
and held bit-equal to the plain versions (`rsweep_reference`,
`sweep3d_reference`); then each shape is timed with CUDA events in the
order old, new, new, old, and the script prints one JSON object per
shape and the card's name and power limit.  Shapes: rsweep at 180x63
(the main path) and 1080x300, S=1, both directions; sweep3d at
128x128x64 (the 3-D path's wedge, T=8) at S=1 and S=7, and with
`--tiles` the new kernel at other tile shapes.  `--breakdown` times
the new rsweep at 180x63 with its near taps, or its far taps, left out
(edited copies of the source, timing only).  `--ptxas` prints the
register and shared-memory use of the new kernels (nvcc -Xptxas -v).
Imports torch and the port, never JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from raytracer_tpu_torch import kernels  # noqa: E402
import raytracer_tpu_torch as rt  # noqa: E402
from raytracer_tpu_torch.ops import sweep3d, sweep_theta  # noqa: E402
from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil  # noqa: E402
from raytracer_tpu_torch.solvers.solve3d import prepare3d  # noqa: E402


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def _build_old(src: str, out_dir: str) -> ctypes.CDLL:
    """`src` built with the package's nvcc flags into out_dir."""
    out = os.path.join(out_dir, os.path.basename(src)[:-3] + "_old.so")
    subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", out, src],
                   check=True)
    return ctypes.CDLL(out)


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _turns(old, new, reps):
    """old, new, new, old; returns (old ms pair, new ms pair)."""
    a = _ms(old, reps)
    b = _ms(new, reps)
    c = _ms(new, reps)
    d = _ms(old, reps)
    return [a, d], [b, c]


def _rsweep_field(rng, rst, nt, upward):
    buf = np.full((1, rst.MT + rst.K8, rst.NTL), np.inf, np.float32)
    vals = rng.uniform(0.0, 1500.0, (1, rst.MT, nt)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = np.inf
    off = rst.K8 if upward else 0
    buf[:, off: off + rst.MT, :nt] = vals
    return torch.from_numpy(buf).cuda()


def rsweep_ab(lib_old, reps, rows):
    fn = lib_old.rsweep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    rng = np.random.default_rng(0)
    for nth, nr in ((180, 63), (1080, 300)):
        _, cg, _ = rt.init_annulus_circulant(nth, nr, spacing=20.0)
        ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
        _, static, wdn, wup, rst = sweep_theta.device_tables(
            ws, cg, np.float32, "cuda")
        for up in (False, True):
            wtab = wup if up else wdn
            taps = rst.taps_up if up else rst.taps_dn
            taps_t = torch.tensor(taps, dtype=torch.int32, device="cuda")
            buf = _rsweep_field(rng, rst, static.nt, up)
            stream = torch.cuda.current_stream().cuda_stream

            def old(b=buf):
                rc = fn(b.data_ptr(), wtab.data_ptr(), taps_t.data_ptr(),
                        len(taps), 1, rst.MT, rst.K8, rst.NTL, rst.NTB,
                        wtab.shape[1], int(up), stream)
                assert rc == 0, rc

            def new(b=buf):
                sweep_theta.rsweep(b, wtab, rst, up)

            want = sweep_theta.rsweep_reference(buf.clone(), wtab, rst, up)
            for f in (old, new):
                b = buf.clone()
                f(b)
                torch.cuda.synchronize()
                assert torch.equal(b, want), (nth, nr, up, f.__name__)
            plan = sweep_theta._kernel_tables(wtab, rst, up)[0]
            o, n = _turns(old, new, reps)
            rows.append(dict(kernel="rsweep", grid=f"{nth}x{nr}", S=1,
                             upward=up, MT=rst.MT, K8=rst.K8, NTL=rst.NTL,
                             route="shared" if plan.shared else "global",
                             threads=plan.threads, entries=len(plan.ent),
                             old_ms=o, new_ms=n,
                             new_us_per_row=1e3 * min(n) / rst.MT,
                             bit_equal=True))
            print(json.dumps(rows[-1]), flush=True)


def sweep3d_ab(lib_old, reps, rows, tiles):
    fn = lib_old.sweep3d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    g = rt.grid3d((np.deg2rad(60.0), np.deg2rad(60.0), rt.R - 2500.0),
                  (np.deg2rad(120.0), np.deg2rad(120.0), rt.R),
                  (128, 128, 64))
    prof = rt.velocity_profile("ak135")
    U = rt.LinearInterpolation(prof.r, prof.Vp)(g.r)
    plan = prepare3d(g, U, rt.SolverConfig(dtype="float32")).plan
    W4 = torch.from_numpy(plan.W4).cuda()
    M13 = sweep3d.mirror_weights(W4, plan.n1)
    rng = np.random.default_rng(7)
    T = 8
    args = (W4, plan.n1, plan.BR, plan.NB, plan.L0, plan.H8, T)
    lib_new = sweep3d._sweep3d_lib()
    for S in (1, 7):
        v = rng.uniform(0.0, 1500.0, (S,) + plan.shape)
        v[rng.random(v.shape) < 0.3] = np.inf
        f = sweep3d.pack_field(torch.from_numpy(v.astype(np.float32)).cuda(),
                               plan)
        out = torch.empty_like(f)
        scr = torch.empty_like(f)
        stream = torch.cuda.current_stream().cuda_stream

        def old():
            rc = fn(f.data_ptr(), W4.data_ptr(), out.data_ptr(),
                    scr.data_ptr(), S, plan.n1, plan.BR, plan.NB, plan.L0, T,
                    0, stream)
            assert rc == 0, rc

        def new_at(tj, kc, sc, lc=plan.L0):
            def run():
                rc = lib_new.sweep3d_launch(
                    f.data_ptr(), M13.data_ptr(), out.data_ptr(),
                    scr.data_ptr(), S, plan.n1, plan.NB * plan.BR, plan.L0,
                    T, lc, tj, kc, sc, 0, stream)
                assert rc == 0, rc
            return run

        planes = -(-plan.NB * plan.BR // plan.n1)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        lc, tj, kc, sc, smem = sweep3d.sweep3d_tiling(plan.n1, plan.L0, S,
                                                      4, planes, sms)
        new = new_at(tj, kc, sc)
        want = sweep3d.sweep3d_reference(f, *args)
        for run in (old, new):
            run()
            torch.cuda.synchronize()
            assert torch.equal(out, want), (S, run.__name__)
        assert torch.equal(sweep3d.sweep3d_T_batched(f, *args), want)
        o, n = _turns(old, new, reps)
        rows.append(dict(kernel="sweep3d", grid="128x128x64", S=S, T=T,
                         tj=tj, kc=kc, sc=sc, smem=smem, old_ms=o, new_ms=n,
                         bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)
        if tiles:
            for tj2 in (2, 4, 8, 16):
                for kc2 in (1, 2, 4, 8, 16):
                    need = 4 * S * (tj2 + 2) * (plan.L0 + 8) * 4
                    if need > 227 * 1024:
                        continue
                    run = new_at(tj2, kc2, S)
                    run()
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (S, tj2, kc2)
                    print(json.dumps(dict(kernel="sweep3d", S=S, tj=tj2,
                                          kc=kc2, smem=need,
                                          new_ms=_ms(run, reps))), flush=True)


# text edits of the new rsweep source that leave out one pass (timing
# only: the results are not the sweep's)
_RSWEEP_PARTS = {
    "far pass and the chain's barriers": [(
        "        for (int d = 1; u + d < kB; ++d) {",
        "        for (int d = 1; u + d < 0; ++d) {")],
    "near chain and the far pass's barriers": [(
        "  for (int t = 0; t < n; ++t) {\n    const int2 q = e[t];",
        "  for (int t = 0; t < 0; ++t) {\n    const int2 q = e[t];")],
}


def rsweep_breakdown(tmp, reps, rows):
    """The new rsweep at 180x63 (down, S=1) with the far taps or the near
    taps left out, beside the whole kernel: how the time splits."""
    _, cg, _ = rt.init_annulus_circulant(180, 63, spacing=20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    _, static, wdn, _, rst = sweep_theta.device_tables(ws, cg, np.float32,
                                                       "cuda")
    plan, ent, binfo, near = sweep_theta._kernel_tables(wdn, rst, False)
    buf = _rsweep_field(np.random.default_rng(1), rst, static.nt, False)
    stream = torch.cuda.current_stream().cuda_stream
    with open(kernels.source_path("rsweep")) as f:
        src = f.read()
    out = {}
    for name, edits in [("whole", [])] + list(_RSWEEP_PARTS.items()):
        text = src
        for old, new in edits:
            assert old in text, name
            text = text.replace(old, new)
        path = os.path.join(tmp, f"rsweep_{len(out)}.cu")
        with open(path, "w") as f:
            f.write(text)
        fn = _build_old(path, tmp).rsweep_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]

        def run(fn=fn):
            rc = fn(buf.data_ptr(), ent.data_ptr(), binfo.data_ptr(),
                    near.data_ptr(), 1, rst.MT, rst.K8, rst.NTL, rst.NTB, 0,
                    int(plan.shared), plan.ent_cap, plan.threads,
                    plan.far_lanes, plan.near_lanes, stream)
            assert rc == 0, rc
        out[name] = _ms(run, reps)
    rows.append(dict(kernel="rsweep", grid="180x63", S=1, upward=False,
                     breakdown_ms=out))
    print(json.dumps(rows[-1]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier rsweep.cu and sweep3d.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: needs an NVIDIA GPU")
    print("device:", torch.cuda.get_device_name(0), "|", _smi(), flush=True)
    if a.ptxas:
        for name in ("rsweep", "sweep3d"):
            p = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS,
                                "-Xptxas", "-v", "-o", os.devnull,
                                kernels.source_path(name)],
                               capture_output=True, text=True)
            print(p.stderr, flush=True)
    rows: list = []
    with tempfile.TemporaryDirectory() as tmp:
        rsweep_ab(_build_old(os.path.join(a.old, "rsweep.cu"), tmp), a.reps,
                  rows)
        sweep3d_ab(_build_old(os.path.join(a.old, "sweep3d.cu"), tmp),
                   max(1, a.reps // 2), rows, a.tiles)
        if a.breakdown:
            rsweep_breakdown(tmp, a.reps, rows)
    print(_smi())


if __name__ == "__main__":
    main()
