"""Time two versions of the port's kernels in turns on one NVIDIA GPU: the
sources in the package's csrc/ and an earlier copy.

    python3 tools/chip_kernel_ab.py --old DIR [--kernels fused,band]
        [--reps N] [--breakdown] [--ptxas] [--tiles]

DIR holds the earlier sources, unpacked from an earlier commit (e.g.
`git archive <commit> raytracer_tpu_torch/csrc`) into a directory that
.gitignore lists.  --kernels picks among
  fused   the whole-solve kernel at 180x63 S=1, 24x12 S=2 and 180x63
          S=8, per solve (the earlier fused.cu with the launch interface
          fused_launch(state, cen, old, src, offs, u_of, idx, w, ring_w,
          pdn, pup, fan_w, flags, iters, t_tiles, nt, ntp, s_count,
          max_iters, is_double, stream));
  band    the stream engine's band sweep at 1080x300 S=1 and S=2 and at
          its warm level's coarse grid (the earlier band.cu with
          band_launch(stack, wrows, out, s, nt, ml, maxdm, stream), timed
          with the 5-page stack its caller built);
  rsweep  at 180x63 and 1080x300, S=1, both directions, and
  sweep3d at 128x128x64 (T=8) at S=1 and S=7 (the earlier interfaces
          rsweep_launch(buf, wtab, taps, n_taps, s, mt, k8, ntl, ntb, d,
          upward, stream) and sweep3d_launch(in, w4, out, scratch, s, n1,
          br, nb, l0, t, is_double, stream); with --tiles the new sweep3d
          at other tile shapes).
Both versions are built with the package's nvcc flags into a temporary
directory, run on the same inputs and held bit-equal to the plain
versions (fused with the same iterations); then each shape is timed
with CUDA events in the order old, new, new, old, and the script prints
one JSON object per shape and the card's name and power limit.
`--breakdown` splits the fused kernel's iteration by phase, for both
versions at 180x63 S=1 and 24x12 S=2: builds with a pre-included header
that defines fused.cu's timing hook FUSED_SPLIT (block 0 stamps
%globaltimer after every grid sync; an earlier source without the hook
gets it after each grid sync), and a kernel of grid syncs alone at the
fused kernel's grid for their own cost (timing only); with rsweep, it
times the new rsweep at 180x63 without its near or far taps.
`--ptxas` prints the register and shared-memory use of the new kernels
(nvcc -Xptxas -v).  Imports torch and the port, never JAX.
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


def _build(src: str, out_dir: str, name: str, *flags) -> ctypes.CDLL:
    """`src` built with the package's nvcc flags and `flags` into
    out_dir/name.so; its headers are looked up beside it."""
    out = os.path.join(out_dir, name + ".so")
    subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, *flags, "-o",
                    out, src], check=True)
    return ctypes.CDLL(out)


def _old_lib(old_dir: str, name: str, tmp: str) -> ctypes.CDLL:
    return _build(os.path.join(old_dir, name + ".cu"), tmp, name + "_old")


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
        fn = _build(path, tmp, f"rsweep_{len(out)}", "-I",
                    kernels.CSRC_DIR).rsweep_launch
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


# The fused kernel's phase split.  A header pre-included by the build
# (nvcc -include) defines the timing hook FUSED_SPLIT(k) of csrc/fused.cu:
# block 0 stamps %globaltimer after grid sync k of an iteration and adds
# the time since the last stamp to slot k (the package's build defines
# the hook empty).  An earlier source without the hook (the four-sync
# loop) gets it after each of its grid syncs.  The header also brings a kernel that
# runs grid syncs alone at the fused kernel's grid, for their own cost.
_SPLIT_HEADER = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
__device__ unsigned long long g_split[16];  // [13], [14]: grid and block size
__device__ __forceinline__ void split_stamp(int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (k >= 0) {
      g_split[k] += t - g_split[15];
    } else {
      g_split[13] = gridDim.x;
      g_split[14] = blockDim.x;
    }
    g_split[15] = t;
  }
}
#define FUSED_SPLIT(k) split_stamp(k)
__global__ void split_syncs(int n) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  split_stamp(-1);
  for (int i = 0; i < n; ++i) {
    grid.sync();
    split_stamp(0);
  }
}
extern "C" int fused_split_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_split, sizeof(g_split)));
}
extern "C" int fused_split_clear() {
  unsigned long long z[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_split, z, sizeof(z)));
}
extern "C" int fused_split_syncs(int blocks, int threads, int n) {
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(split_syncs),
                                              dim3(blocks), dim3(threads), args, 0, 0);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}
"""
# the phases between grid syncs: with the hook (one sync fewer; the first
# phase runs once more than the iterations) and in the earlier four-sync
# loop
_SPLIT_NAMES = {
    True: ("fan+flag+snapshot+ring", "chain", "relax"),
    False: ("ring+snapshot", "chain", "relax+fan-reduce", "fan+flag"),
}


def _split_build(tmp, label, csrc):
    """The fused.cu of `csrc` built with the timing header; returns the
    library and its phase names."""
    header = os.path.join(tmp, "fused_split.cuh")
    with open(header, "w") as f:
        f.write(_SPLIT_HEADER)
    path = os.path.join(csrc, "fused.cu")
    with open(path) as f:
        text = f.read()
    hooked = "FUSED_SPLIT(" in text
    if not hooked:
        head, tail = text.split("cg::grid_group grid = cg::this_grid();", 1)
        parts = tail.split("grid.sync();")
        tail = "".join(p + f"grid.sync(); FUSED_SPLIT({i});"
                       for i, p in enumerate(parts[:-1])) + parts[-1]
        path = os.path.join(tmp, f"fused_split_{label}.cu")
        with open(path, "w") as f:
            f.write(head + "cg::grid_group grid = cg::this_grid(); "
                    "FUSED_SPLIT(-1);" + tail)
    names = _SPLIT_NAMES[hooked]
    if not hooked:
        assert len(parts) == len(names) + 1, (len(parts), names)
    lib = _build(path, tmp, f"fused_split_{label}", "-I", csrc,
                 "-include", header)
    lib.fused_split_syncs.argtypes = [ctypes.c_int] * 3
    return lib, names


_FUSED_GRIDS = {"180x63": (180, 63, 20.0), "24x12": (24, 12, 150.0)}


def _fused_case(grid, S):
    """Initial state, centre, tables and static of a fused solve of S
    surface sources spread around the ring."""
    from raytracer_tpu_torch.contrib import fused_circulant as pfc
    from raytracer_tpu_torch.contrib import pallas_circulant as ppc

    nth, nr, spacing = _FUSED_GRIDS[grid]
    gr, cg, _ = rt.init_annulus_circulant(nth, nr, spacing=spacing)
    ts = ppc.pack_tiled_stencil(cg, np.float32)
    nt, T = ts.ntheta, ts.T
    ntp = -(-nt // 8) * 8
    srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(0.0, 360.0, S, endpoint=False)]
    d0, c0 = ppc.initial_state(cg, srcs, T, ntp, np.float32)
    x0 = torch.from_numpy(d0.reshape(T, S * ntp, 128)).cuda()
    cen0 = torch.from_numpy(c0).cuda()
    tbl = pfc.device_fused_tables(ts, "cuda")
    return x0, cen0, tbl, pfc.FusedStatic(T, nt, ntp, S), ts


def _fused_launcher(lib, label, tbl, st):
    """launch(x0, c0, max_iters, reps) -> iterations of the last of
    `reps` solves from (x0, c0); the result stays in launch.out.  The
    "old" build takes the earlier interface fused_launch(state, cen, old,
    src, offs, u_of, idx, w, ring_w, pdn, pup, fan_w, flags, iters,
    t_tiles, nt, ntp, s_count, max_iters, is_double, stream); any other
    the package's (fused_circulant._fused_launch)."""
    from raytracer_tpu_torch.contrib import fused_circulant as pfc

    T, nt, ntp, S = st
    if label == "old":
        fn = lib.fused_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]

    def once(x, c, max_iters):
        if label != "old":
            return pfc._fused_launch(x, c, tbl, st, max_iters, lib)
        old = torch.empty_like(x)
        src = torch.empty_like(x)
        flags = torch.zeros(2, dtype=torch.int32, device="cuda")
        iters = torch.zeros((), dtype=torch.int32, device="cuda")
        rc = fn(x.data_ptr(), c.data_ptr(), old.data_ptr(), src.data_ptr(),
                tbl.offs.data_ptr(), tbl.u_of.data_ptr(), tbl.idx.data_ptr(),
                tbl.w.data_ptr(), tbl.ring_w.data_ptr(), tbl.pdn.data_ptr(),
                tbl.pup.data_ptr(), tbl.fan_w.data_ptr(), flags.data_ptr(),
                iters.data_ptr(), T, nt, ntp, S, max_iters, 0,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return iters

    def launch(x0, c0, max_iters, reps=1):
        for _ in range(reps):
            x = x0.clone()
            c = c0.clone()
            iters = once(x, c, max_iters)
        torch.cuda.synchronize()
        launch.out = (x, c)
        return int(iters)

    launch.once = once
    return launch


def fused_breakdown(tmp, csrc_dirs, reps, rows):
    """Per version in `csrc_dirs` (label -> directory), the mean us per
    iteration of each phase of the fused kernel (the time from one grid
    sync to the next, as block 0 sees it) and of one grid sync alone at
    the kernel's grid, at 180x63 S=1 and 24x12 S=2."""
    libs = {label: _split_build(tmp, label, csrc)
            for label, csrc in csrc_dirs.items()}
    for grid, S in (("180x63", 1), ("24x12", 2)):
        x0, c0, tbl, st, _ = _fused_case(grid, S)
        for label, (lib, names) in libs.items():
            launch = _fused_launcher(lib, label, tbl, st)
            buf = (ctypes.c_ulonglong * 16)()
            iters = launch(x0, c0, 100_000, reps=1)
            assert lib.fused_split_clear() == 0
            launch(x0, c0, 100_000, reps=reps)
            assert lib.fused_split_read(buf) == 0
            out = {n: buf[i] / (reps * iters) / 1e3
                   for i, n in enumerate(names)}
            blocks, threads = int(buf[13]), int(buf[14])
            n = iters * len(names)
            assert lib.fused_split_syncs(blocks, threads, n) == 0  # warm-up
            assert lib.fused_split_clear() == 0
            for _ in range(reps):
                assert lib.fused_split_syncs(blocks, threads, n) == 0
            assert lib.fused_split_read(buf) == 0
            out["one grid sync"] = buf[0] / (reps * n) / 1e3
            out["syncs"] = out["one grid sync"] * len(names)
            rows.append(dict(kernel="fused", version=label, grid=grid, S=S,
                             iters=iters, blocks=blocks,
                             split_us_per_iteration=out))
            print(json.dumps(rows[-1]), flush=True)


def fused_ab(lib_old, reps, rows):
    """The earlier fused kernel and the package's, in turns, per solve, at
    180x63 S=1, 24x12 S=2 and 180x63 S=8, both held bit-equal (state,
    centre, iterations) to fused_reference first."""
    from raytracer_tpu_torch.contrib import fused_circulant as pfc

    for grid, S in (("180x63", 1), ("24x12", 2), ("180x63", 8)):
        x0, c0, tbl, st, ts = _fused_case(grid, S)
        x_r, c_r, it_r = pfc.fused_reference(x0, c0, tbl, st, 100_000)
        old = _fused_launcher(lib_old, "old", tbl, st)
        it_o = old(x0, c0, 100_000)
        assert it_o == it_r and all(map(torch.equal, old.out, (x_r, c_r))), \
            ("old", grid, S)
        x_n, c_n, it_n = pfc.fused(x0, c0, tbl, st, 100_000)
        torch.cuda.synchronize()
        assert int(it_n) == it_r and torch.equal(x_n, x_r) \
            and torch.equal(c_n, c_r), ("new", grid, S)
        o, n = _turns(lambda: old.once(x0.clone(), c0.clone(), 100_000),
                      lambda: pfc.fused(x0, c0, tbl, st, 100_000), reps)
        rows.append(dict(kernel="fused", grid=grid, S=S, T=ts.T, iters=it_r,
                         chunks=int(tbl.ck_info.shape[0]), old_ms=o,
                         new_ms=n, old_us_per_iteration=1e3 * min(o) / it_r,
                         new_us_per_iteration=1e3 * min(n) / it_r,
                         bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)


def band_ab(lib_old, reps, rows):
    """The earlier band kernel with the 5-page stack its caller built, and
    the package's field-form kernel, in turns at 1080x300 S=1 and S=2 and
    at the warm level's coarse grid (S=1), both held bit-equal to
    band_reference first."""
    from raytracer_tpu_torch.ops import stream_t
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    fn = lib_old.band_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    _, cg, _ = rt.init_annulus_circulant(1080, 300, spacing=20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=1)
    coarse = stream_t._warm_stencils(ws, cg, np.float32, 1, 1)[0]
    rng = np.random.default_rng(4)
    for name, w_, S in (("1080x300", ws, 1), ("1080x300", ws, 2),
                        ("1080x300 coarse", coarse, 1)):
        wrows = torch.tensor(w_.wrows, device="cuda")
        v = rng.uniform(0.0, 1500.0, (S, w_.nt, w_.ML)).astype(np.float32)
        v[rng.random(v.shape) < 0.5] = np.inf
        v[..., w_.Mp:] = np.inf
        v = torch.from_numpy(v).cuda()
        out = torch.empty_like(v)

        def old():
            stack = stream_t._band_stack(v)
            rc = fn(stack.data_ptr(), wrows.data_ptr(), out.data_ptr(), S,
                    w_.nt, w_.ML, w_.maxdm,
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        def new():
            return stream_t.band(v, wrows, w_.maxdm)

        want = stream_t.band_reference(stream_t._band_stack(v), wrows,
                                       w_.maxdm)
        old()
        torch.cuda.synchronize()
        assert torch.equal(out, want), ("old", name, S)
        assert torch.equal(new(), want), ("new", name, S)
        o, n = _turns(old, new, reps)
        rows.append(dict(kernel="band", grid=name, S=S, nt=w_.nt, ML=w_.ML,
                         maxdm=w_.maxdm, old_with_stack_ms=o, new_ms=n,
                         bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier kernel sources")
    ap.add_argument("--kernels", default="fused,band",
                    help="comma-separated: rsweep, sweep3d, fused, band")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--breakdown", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_ab: needs an NVIDIA GPU")
    print("device:", torch.cuda.get_device_name(0), "|", _smi(), flush=True)
    if a.ptxas:
        for name in a.kernels.split(","):
            p = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS,
                                "-Xptxas", "-v", "-o", os.devnull,
                                kernels.source_path(name)],
                               capture_output=True, text=True)
            print(p.stderr, flush=True)
    rows: list = []
    want = set(a.kernels.split(","))
    with tempfile.TemporaryDirectory() as tmp:
        if "rsweep" in want:
            rsweep_ab(_old_lib(a.old, "rsweep", tmp), a.reps, rows)
        if "sweep3d" in want:
            sweep3d_ab(_old_lib(a.old, "sweep3d", tmp), max(1, a.reps // 2),
                       rows, a.tiles)
        if "fused" in want:
            fused_ab(_old_lib(a.old, "fused", tmp), max(1, a.reps // 4),
                     rows)
        if "band" in want:
            band_ab(_old_lib(a.old, "band", tmp), a.reps, rows)
        if a.breakdown and "rsweep" in want:
            rsweep_breakdown(tmp, a.reps, rows)
        if a.breakdown and "fused" in want:
            fused_breakdown(tmp, {"old": a.old, "new": kernels.CSRC_DIR},
                            max(1, a.reps // 4), rows)
    print(_smi())


if __name__ == "__main__":
    main()
