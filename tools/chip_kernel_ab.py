"""Time two versions of the port's kernels in turns on one NVIDIA GPU: the
sources in the package's csrc/ and an earlier copy.

    python3 tools/chip_kernel_ab.py --old DIR [--kernels titer,diag]
        [--old-pkg ROOT] [--reps N] [--breakdown] [--ptxas]

DIR holds the earlier sources, unpacked from an earlier commit (e.g.
`git archive <commit> raytracer_tpu_torch/csrc`) into a directory that
.gitignore lists.  --kernels picks among
  titer   the twrapped engine's 4 iterations at 180x63 S=1 and S=2 and
          176x40 S=2 (dup 0), per launch, and the new kernel alone in
          float64 at 180x63 S=1 and 176x40 S=2 (the earlier titer.cu with
          titer_launch(dist, cen, wrows, ring_f, ring_b, cfl, cbl, fan,
          out, scratch, cen_out, s, ml, ntt, nt, maxdm, n_ring_statics,
          n_ring, n_chain_statics, chain_rep, n_chain, iters, stream);
          with --breakdown both versions' device time by kernel at 180x63
          S=1, torch.profiler);
  diag    the diag engine at 127x63 and 183x63: one sweep (the earlier
          diag.cu with diag_launch(dist, taps, wT, out, d, mp, ntl, nt,
          stream), the diagonals as (D, 2) int32 (dm, dc) and a (D, Mp)
          weight table), the ring and chain scans (earlier: the torch ops
          _ring_scan and _chain_scan) and one whole iteration (earlier:
          those scans, the earlier sweep and the fan and changed test as
          torch ops, with the host read of the flag; now diag_step with
          the scans, one launch call, and the read of its flag), the new
          kernels alone in float64;
          with --breakdown both iterations' device time by kernel at
          127x63;
  witer   the wrapped engine's 4 iterations at 183x63 S=1 and S=2 and
          256x63 S=2, per launch, and the new kernel alone in float64 at
          183x63 S=1 (the earlier witer.cu with witer_launch(dist, cen,
          taps, wpT, ring_f, ring_b, cfl, cbl, fan, out, scratch, cen_out,
          s, mp, ntl, nt, dp, wstride, n_ring, n_chain_statics, chain_rep,
          n_chain, iters, stream); with --breakdown both versions' device
          time by kernel at 183x63 S=1, torch.profiler);
  relax   one lane-gather sweep at 180x63 S=1 and S=8 and 24x12 S=2
          float64 (the earlier relax.cu with relax_launch(dist, offs,
          u_of, idx, w, out, t_tiles, nt, s_count, ntp, is_double,
          stream));
  fused   the whole-solve kernel at 180x63 S=1, 24x12 S=2 and 180x63
          S=8, per solve (both with the package's launch interface);
  plane3d one directional pass of the 3-D sweep engine at 128x128x64
          (star 1, down): along each axis at S=1 and along axis 0 at S=8
          in float32, along axis 0 in float64 (both with the package's
          launch interface); with --breakdown the package's source built
          with one step of a pass left out at a time (the cross taps, the
          in-plane taps, the scans, the L2 prefetch, and all three steps:
          timing only, each computes another function), along axes 0
          and 1.
Both versions are built with the package's nvcc flags into a temporary
directory, run on the same inputs and held bit-equal to the plain
versions (fused with the same iterations); then each shape is timed
with CUDA events in the order old, new, new, old, and the script prints
one JSON object per shape and the card's name and power limit.
With fused, `--breakdown` splits the kernel's iteration by phase, for
both versions at 180x63 S=1 and 24x12 S=2: builds with a pre-included
header that defines fused.cu's timing hook FUSED_SPLIT (block 0 stamps
%globaltimer after every grid sync), and a kernel of grid syncs alone
at the fused kernel's grid for their own cost (timing only).
`--old-pkg ROOT` (a directory holding an earlier commit's
raytracer_tpu_torch package, e.g. `git archive <commit>
raytracer_tpu_torch`) also times whole solves, each version in its own
process in the order old, new, new, old: twrapped at 180x63 and auto
(diag) at 127x63 from the surface source at theta 0, host clock around
each solve with a synchronize, medians of 5 and 3 after a warm-up, with
the iteration counts.
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

import chip_smoke  # noqa: E402
from raytracer_tpu_torch import kernels  # noqa: E402
import raytracer_tpu_torch as rt  # noqa: E402


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


# The fused kernel's phase split.  A header pre-included by the build
# (nvcc -include) defines the timing hook FUSED_SPLIT(k) of csrc/fused.cu:
# block 0 stamps %globaltimer after grid sync k of an iteration and adds
# the time since the last stamp to slot k (the package's build defines
# the hook empty).  The header also brings a kernel that runs grid syncs
# alone at the fused kernel's grid, for their own cost.
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
# the phases between grid syncs (the first runs once more than the
# iterations)
_SPLIT_NAMES = ("fan+flag+snapshot+ring", "chain", "relax")


def _split_build(tmp, label, csrc):
    """The fused.cu of `csrc` built with the timing header."""
    header = os.path.join(tmp, "fused_split.cuh")
    with open(header, "w") as f:
        f.write(_SPLIT_HEADER)
    lib = _build(os.path.join(csrc, "fused.cu"), tmp, f"fused_split_{label}",
                 "-I", csrc, "-include", header)
    lib.fused_split_syncs.argtypes = [ctypes.c_int] * 3
    return lib


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


def _fused_launcher(lib, tbl, st):
    """launch(x0, c0, max_iters, reps) -> iterations of the last of
    `reps` solves from (x0, c0) by the build `lib` of a fused.cu
    (fused_circulant._fused_launch); the result stays in launch.out."""
    from raytracer_tpu_torch.contrib import fused_circulant as pfc

    def once(x, c, max_iters):
        return pfc._fused_launch(x, c, tbl, st, max_iters, lib)

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
    names = _SPLIT_NAMES
    for grid, S in (("180x63", 1), ("24x12", 2)):
        x0, c0, tbl, st, _ = _fused_case(grid, S)
        for label, lib in libs.items():
            launch = _fused_launcher(lib, tbl, st)
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
        old = _fused_launcher(lib_old, tbl, st)
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


def _witer_case(ntheta, S, dtype, rng):
    """Tables, static, field and centre values of a witer launch at
    ntheta x 63 (phase 3b of chip_smoke.py)."""
    from raytracer_tpu_torch.ops import diag_wrapped as pdw

    _, cg, _ = rt.init_annulus_circulant(ntheta, 63, spacing=20.0)
    ws = pdw.pack_wrapped_stencil(cg, dtype=dtype)
    st = pdw.WStatic(ws.rho_starts, ws.Mp, ws.NTL, ws.pad2, ws.nt)
    tbl = pdw.device_wrapped_tables(ws, "cuda")
    d = rng.uniform(0.0, 1500.0, (ws.Mp, S * ws.NTL))
    d[rng.random(d.shape) < 0.3] = np.inf
    cen = rng.uniform(0.0, 1500.0, S)
    return (ws, st, tbl, torch.from_numpy(d.astype(dtype)).cuda(),
            torch.from_numpy(cen.astype(dtype)).cuda())


def _witer_old(lib_old, ws, st, tbl, S):
    """run(dist, cen) of the earlier witer.cu, launch interface
    witer_launch(dist, cen, taps, wpT, ring_f, ring_b, cfl, cbl, fan, out,
    scratch, cen_out, s, mp, ntl, nt, dp, wstride, n_ring,
    n_chain_statics, chain_rep, n_chain, iters, stream): float32, the
    diagonals as (Dp, 2) int32 (dm, dc) and the weights as rows of wpT."""
    from raytracer_tpu_torch.ops import diag_wrapped as pdw

    fn = lib_old.witer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    taps = torch.tensor(pdw.wrapped_taps(ws), device="cuda")
    _, n_ring = pdw._ring_plan(ws.NTL)
    statics, rep, n_chain = pdw._chain_plan(ws.Mp)

    def run(dist, cen, iters=4):
        out = torch.empty_like(dist)
        scratch = torch.empty_like(dist)
        cen_out = torch.empty_like(cen)
        rc = fn(dist.data_ptr(), cen.data_ptr(), taps.data_ptr(),
                tbl.wpT.data_ptr(), tbl.ring_f.data_ptr(),
                tbl.ring_b.data_ptr(), tbl.cfl.data_ptr(), tbl.cbl.data_ptr(),
                tbl.fan_w.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                cen_out.data_ptr(), S, ws.Mp, ws.NTL, ws.nt, ws.D,
                tbl.wpT.shape[1], n_ring, len(statics), rep, n_chain, iters,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out, cen_out
    return run


def witer_ab(lib_old, reps, rows, breakdown):
    """The earlier witer kernel and the package's, in turns, per launch of
    4 iterations at 183x63 S=1 and S=2 and 256x63 S=2 (dup 0), both held
    bit-equal to witer_reference first; the package's in float64 at
    183x63 S=1 (the earlier one has no float64 build).  With
    `breakdown`, each version's device time by kernel (torch.profiler)."""
    from raytracer_tpu_torch.ops import diag_wrapped as pdw

    rng = np.random.default_rng(6)
    for ntheta, S, dtype in ((183, 1, np.float32), (183, 2, np.float32),
                             (256, 2, np.float32), (183, 1, np.float64)):
        ws, st, tbl, dist, cen = _witer_case(ntheta, S, dtype, rng)
        want = pdw.witer_reference(st, dist, cen, tbl, 4)

        def new():
            return pdw.witer(st, dist, cen, tbl, 4)

        got = new()
        torch.cuda.synchronize()
        assert all(map(torch.equal, got, want)), ("new", ntheta, S, dtype)
        row = dict(kernel="witer", grid=f"{ntheta}x63", S=S,
                   dtype=np.dtype(dtype).name, dup=ws.NTL - ws.nt,
                   bit_equal=True)
        if dtype == np.float32:
            old_run = _witer_old(lib_old, ws, st, tbl, S)

            def old():
                return old_run(dist, cen)

            got = old()
            torch.cuda.synchronize()
            assert all(map(torch.equal, got, want)), ("old", ntheta, S)
            row["old_ms"], row["new_ms"] = _turns(old, new, reps)
            if breakdown and ntheta == 183 and S == 1:
                row["old_split_ms"] = chip_smoke._kernel_split_ms(old, 5)
                row["new_split_ms"] = chip_smoke._kernel_split_ms(new, 5)
        else:
            row["new_ms"] = [_ms(new, reps), _ms(new, reps)]
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)


def relax_ab(lib_old, reps, rows):
    """The earlier relax kernel and the package's, in turns, per sweep at
    180x63 S=1 and S=8 (float32) and 24x12 S=2 (float64), both held
    bit-equal to relax_reference first.  The earlier source takes
    relax_launch(dist, offs, u_of, idx, w, out, t_tiles, nt, s_count, ntp,
    is_double, stream)."""
    from raytracer_tpu_torch.contrib import pallas_circulant as ppc

    fn = lib_old.relax_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    rng = np.random.default_rng(8)
    for (nth, nr, spacing), S, dtype in (((180, 63, 20.0), 1, np.float32),
                                         ((180, 63, 20.0), 8, np.float32),
                                         ((24, 12, 150.0), 2, np.float64)):
        _, cg, _ = rt.init_annulus_circulant(nth, nr, spacing=spacing)
        ts = ppc.pack_tiled_stencil(cg, dtype)
        tb = ppc.device_pallas_tables(ts, "cuda")
        nt = ts.ntheta
        ntp = -(-nt // 8) * 8
        d = rng.uniform(0.0, 1500.0, (ts.T, S, ntp, 128))
        d[rng.random(d.shape) < 0.3] = np.inf
        x = torch.from_numpy(d.astype(dtype)).cuda()
        args = (tb.offs, tb.u_of, tb.idx, tb.w, ts.T, nt, S, ntp)
        out = torch.empty_like(x)

        def old():
            rc = fn(x.data_ptr(), tb.offs.data_ptr(), tb.u_of.data_ptr(),
                    tb.idx.data_ptr(), tb.w.data_ptr(), out.data_ptr(), ts.T,
                    nt, S, ntp, int(dtype == np.float64),
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        def new():
            return ppc.relax(x, *args)

        want = ppc.relax_reference(x, *args)
        old()
        torch.cuda.synchronize()
        assert torch.equal(out, want), ("old", nth, S)
        assert torch.equal(new(), want), ("new", nth, S)
        o, n = _turns(old, new, reps)
        rows.append(dict(kernel="relax", grid=f"{nth}x{nr}", S=S,
                         dtype=np.dtype(dtype).name, T=ts.T,
                         chunks=int(ppc._kernel_chunks(*args[:5])[0].shape[0]),
                         old_ms=o, new_ms=n,
                         bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)


# --breakdown for plane3d: the (anchor, replacement) pairs in
# csrc/plane3d.cu that leave one step of a pass out
_PLANE3D_SKIP = {
    "no cross taps": [("      for (int t = 0; t < n_cross; ++t) {\n",
                       "      for (int t = 0; t < 0; ++t) {\n")],
    "no in-plane taps": [
        ("    for (int t = n_cross; t < n_cross + n_inpl; ++t) {\n",
         "    for (int t = n_cross; t < n_cross; ++t) {\n")],
    "no scans": [
        ("    // 3. the scans along plane axis 0, then along plane axis 1\n",
         "    if (false) {\n"),
        ("    // 4. the output plane", "    }\n    // 4. the output plane")],
    "no prefetch": [("    if (!can_prefetch || threadIdx.x", "    if (true || "
                     "!can_prefetch || threadIdx.x")],
}


def _plane3d_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.plane3d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p] * 2)
    return lib


def _plane3d_variants(tmp: str) -> dict:
    """The package's plane3d.cu with the steps of _PLANE3D_SKIP left out,
    one at a time and the three of a plane together, built in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    with open(kernels.source_path("plane3d")) as f:
        text = f.read()
    variants = {"full": []}
    variants.update({k: [k] for k in _PLANE3D_SKIP})
    variants["only the write"] = ["no cross taps", "no in-plane taps",
                                  "no scans"]

    def make(item):
        name, skips = item
        t = text
        for k in skips:
            for anchor, repl in _PLANE3D_SKIP[k]:
                assert anchor in t, (k, anchor)
                t = t.replace(anchor, repl, 1)
        tag = "plane3d_" + name.replace(" ", "_").replace("-", "_")
        src = os.path.join(tmp, tag + ".cu")
        with open(src, "w") as f:
            f.write(t)
        return name, _plane3d_bind(_build(src, tmp, tag, "-I",
                                          kernels.CSRC_DIR))

    with ThreadPoolExecutor(len(variants)) as ex:
        return dict(ex.map(make, variants.items()))


def plane3d_ab(lib_old, reps, rows, breakdown, tmp):
    """The earlier plane3d kernel and the package's, in turns, one pass
    at chip_smoke's 128x128x64 wedge: along each axis (S=1) and along
    axis 0 at S=8 in float32, along axis 0 in float64, both held
    bit-equal to plane_sweep3d_reference first.  The wrapper
    plane_sweep3d launches both (its library swapped in turn), so both
    versions take the package's launch interface."""
    from raytracer_tpu_torch.ops import plane3d as p3
    from raytracer_tpu_torch.solvers import solve3d as s3

    own = p3._plane3d_lib
    libs = {"old": _plane3d_bind(lib_old), "new": own()}
    rng = np.random.default_rng(14)
    g, U = chip_smoke._wedge3d(chip_smoke.WEDGE_DIMS, 60.0, 120.0, 2500.0)
    dev = torch.device("cuda")

    def field(S, shape, dtype):
        v = rng.uniform(0.0, 500.0, (S,) + shape).astype(dtype)
        v[rng.random(v.shape) < 0.3] = np.inf
        return torch.from_numpy(v).cuda()

    def pass_of(lib, d, lay, axis, shifts):
        def run():
            p3._plane3d_lib = lambda: lib
            return p3.plane_sweep3d(d, lay, axis, True, None, shifts)
        return run

    try:
        for dtype, cases in ((np.float32, ((0, 1), (1, 1), (2, 1), (0, 8))),
                             (np.float64, ((0, 1),))):
            pk = rt.prepare3d(g, U, rt.SolverConfig(dtype=np.dtype(dtype)
                                                    .name))
            lays = s3._device_layout(pk, "sweep", dev)
            for axis, S in cases:
                d = field(S, pk.shape, dtype)
                runs = {k: pass_of(lib, d, lays[axis], axis, pk.shifts)
                        for k, lib in libs.items()}
                want = p3.plane_sweep3d_reference(d, lays[axis], axis, True,
                                                  None, pk.shifts)
                for k, run in runs.items():
                    got = run()
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (k, axis, S, dtype)
                o, n = _turns(runs["old"], runs["new"], reps)
                rows.append(dict(kernel="plane3d", grid="128x128x64",
                                 axis=axis, S=S, dtype=np.dtype(dtype).name,
                                 planes=int(lays[axis].W.shape[0]),
                                 old_ms=o, new_ms=n, bit_equal=True))
                print(json.dumps(rows[-1]), flush=True)
            if breakdown and dtype == np.float32:
                variants = _plane3d_variants(tmp)
                for rep in range(2):
                    for name, lib in variants.items():
                        ms = [_ms(pass_of(lib, field(1, pk.shape, dtype),
                                          lays[ax], ax, pk.shifts), reps)
                              for ax in (0, 1)]
                        rows.append(dict(kernel="plane3d", split=name,
                                         turn=rep, axis0_ms=ms[0],
                                         axis1_ms=ms[1]))
                        print(json.dumps(rows[-1]), flush=True)
            pk.dcache.clear()
    finally:
        p3._plane3d_lib = own


def _titer_case(ntheta, nr, S, dtype, rng):
    """Tables, static, field and centre values of a titer launch (phase
    3a of chip_smoke.py)."""
    from raytracer_tpu_torch.ops import wrapped_t as pwt

    _, cg, _ = rt.init_annulus_circulant(ntheta, nr, spacing=20.0)
    ws = pwt.pack_twrapped_stencil(cg, dtype=dtype, band_closure=1)
    st = pwt.TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)
    tbl = pwt.device_twrapped_tables(ws, "cuda")
    d = rng.uniform(0.0, 1500.0, (S * ws.NTT, ws.ML))
    d[rng.random(d.shape) < 0.5] = np.inf
    d[:, ws.Mp:] = np.inf
    cen = rng.uniform(0.0, 1500.0, S)
    return (ws, st, tbl, torch.from_numpy(d.astype(dtype)).cuda(),
            torch.from_numpy(cen.astype(dtype)).cuda())


def _titer_old(lib_old, st, tbl, S):
    """run(dist, cen) of the earlier titer.cu (float32 only), launch
    interface titer_launch(dist, cen, wrows, ring_f, ring_b, cfl, cbl,
    fan, out, scratch, cen_out, s, ml, ntt, nt, maxdm, n_ring_statics,
    n_ring, n_chain_statics, chain_rep, n_chain, iters, stream)."""
    from raytracer_tpu_torch.ops import wrapped_t as pwt

    fn = lib_old.titer_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    statics, n_ring, chain_statics, rep, n_chain = pwt._scan_plan(st)

    def run(dist, cen, iters=4):
        out = torch.empty_like(dist)
        scratch = torch.empty_like(dist)
        cen_out = torch.empty_like(cen)
        rc = fn(dist.data_ptr(), cen.data_ptr(), tbl.wrows.data_ptr(),
                tbl.ring_f.data_ptr(), tbl.ring_b.data_ptr(),
                tbl.cfl.data_ptr(), tbl.cbl.data_ptr(), tbl.fan_w.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), cen_out.data_ptr(), S,
                st.ML, st.NTT, st.nt, st.maxdm, len(statics), n_ring,
                len(chain_statics), rep, n_chain, iters,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out, cen_out
    return run


def titer_ab(lib_old, reps, rows, breakdown):
    """The earlier titer kernel and the package's, in turns, per launch of
    4 iterations at 180x63 S=1 and S=2 and 176x40 S=2 (dup 0), both held
    bit-equal to titer_reference first; the package's alone in float64.
    With `breakdown`, each version's device time by kernel at 180x63
    S=1 (torch.profiler)."""
    from raytracer_tpu_torch.ops import wrapped_t as pwt

    rng = np.random.default_rng(5)
    for ntheta, nr, S, dtype in ((180, 63, 1, np.float32),
                                 (180, 63, 2, np.float32),
                                 (176, 40, 2, np.float32),
                                 (180, 63, 1, np.float64),
                                 (176, 40, 2, np.float64)):
        ws, st, tbl, dist, cen = _titer_case(ntheta, nr, S, dtype, rng)
        want = pwt.titer_reference(st, dist, cen, tbl, 4)

        def new():
            return pwt.titer(st, dist, cen, tbl, 4)

        got = new()
        torch.cuda.synchronize()
        assert all(map(torch.equal, got, want)), ("new", ntheta, S, dtype)
        row = dict(kernel="titer", grid=f"{ntheta}x{nr}", S=S,
                   dtype=np.dtype(dtype).name, dup=ws.NTT - ws.nt,
                   bit_equal=True)
        if dtype == np.float32:
            old_run = _titer_old(lib_old, st, tbl, S)

            def old():
                return old_run(dist, cen)

            got = old()
            torch.cuda.synchronize()
            assert all(map(torch.equal, got, want)), ("old", ntheta, S)
            row["old_ms"], row["new_ms"] = _turns(old, new, reps)
            if breakdown and ntheta == 180 and S == 1:
                row["old_split_ms"] = chip_smoke._kernel_split_ms(old, 5)
                row["new_split_ms"] = chip_smoke._kernel_split_ms(new, 5)
        else:
            row["new_ms"] = [_ms(new, reps), _ms(new, reps)]
        rows.append(row)
        print(json.dumps(rows[-1]), flush=True)


def diag_ab(lib_old, reps, rows, breakdown):
    """The diag engine's pieces, earlier and new, in turns at 127x63 and
    183x63: the sweep kernels, the scans (earlier: torch ops), and one
    iteration of the loop (earlier: the torch scans, the earlier sweep,
    the fan and changed test as torch ops and the host read of the flag;
    new: diag_step with the scans and the read of its flag), all
    held bit-equal to the plain versions first; float64 new alone.  With
    `breakdown`, both iterations' device time by kernel at 127x63."""
    from raytracer_tpu_torch.ops import diag_circulant as pdc

    fn = lib_old.diag_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    rng = np.random.default_rng(6)
    for ntheta, dtype in ((127, np.float32), (183, np.float32),
                          (127, np.float64)):
        _, cg, _ = rt.init_annulus_circulant(ntheta, 63, spacing=20.0)
        ds = pdc.pack_diag_stencil(cg, dtype=dtype)
        st = pdc.DiagStatic(ds.D, ds.Mp, ds.NTL, ds.pad, ds.ntheta)
        tbl = pdc.device_diag_tables(ds, "cuda")
        sc = pdc.device_diag_scan_tables(ds, "cuda")
        d = rng.uniform(0.0, 1500.0, (ds.Mp, ds.NTL))
        d[rng.random(d.shape) < 0.3] = np.inf
        x = torch.from_numpy(d.astype(dtype)).cuda()
        old_x = x + 1.0
        dcen = torch.tensor(400.0, dtype=x.dtype, device="cuda")
        tol = torch.tensor(1e-3, dtype=x.dtype, device="cuda")
        d_ids = np.arange(ds.D)
        taps = torch.tensor(pdc.diag_taps(ds), device="cuda")
        wT = torch.tensor(np.ascontiguousarray(
            ds.wp[d_ids // pdc.LANES, :, d_ids % pdc.LANES]), device="cuda")

        def old_sweep(v):
            out = torch.empty_like(v)
            rc = fn(v.data_ptr(), taps.data_ptr(), wT.data_ptr(),
                    out.data_ptr(), ds.D, ds.Mp, ds.NTL, ds.ntheta,
                    torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
            return out

        def old_iter():
            v = pdc._chain_scan(pdc._ring_scan(x, sc.ring_f, sc.ring_b,
                                               ds.ntheta),
                                sc.chain_f, sc.chain_b)
            v = old_sweep(v)
            c = torch.minimum(dcen, (v + sc.fan_w).min())
            v = torch.minimum(v, c + sc.fan_w + sc.lane_mask)
            return v, c, bool(((v < old_x - tol).any()
                               | (c < dcen - tol)).item())

        def new_iter():
            v, c, flag = pdc.diag_step(st, x, tbl, sc, old_x, dcen, tol, True)
            return v, c, bool(flag.item())

        name = f"{ntheta}x63"
        want_sweep = pdc.diag_sweep_reference(st, x, tbl)
        want_iter = pdc.diag_step_reference(
            st, pdc._chain_scan(pdc._ring_scan(x, sc.ring_f, sc.ring_b,
                                               ds.ntheta),
                                sc.chain_f, sc.chain_b),
            tbl, sc, old_x, dcen, tol)
        pieces = (
            ("sweep", lambda: old_sweep(x) if dtype == np.float32 else None,
             lambda: pdc.diag_sweep(st, x, tbl), want_sweep),
            ("ring_scan",
             lambda: pdc._ring_scan(x, sc.ring_f, sc.ring_b, ds.ntheta),
             lambda: pdc.ring_scan(x, sc, ds.ntheta), None),
            ("chain_scan", lambda: pdc._chain_scan(x, sc.chain_f, sc.chain_b),
             lambda: pdc.chain_scan(x, sc), None),
            ("iteration", old_iter if dtype == np.float32 else None,
             new_iter, want_iter))
        for piece, old, new, want in pieces:
            got = new()
            if want is None:
                want = old()
            torch.cuda.synchronize()
            if piece == "iteration":
                assert torch.equal(got[0], want[0]) \
                    and torch.equal(got[1], want[1]) \
                    and got[2] == bool(want[2]), ("new", name, piece)
            else:
                assert torch.equal(got, want), ("new", name, piece)
            row = dict(kernel="diag", piece=piece, grid=name,
                       dtype=np.dtype(dtype).name, bit_equal=True)
            if dtype == np.float32:
                got = old()
                torch.cuda.synchronize()
                same = (torch.equal(got[0], want[0]) and got[2] == bool(
                    want[2]) if piece == "iteration" else torch.equal(got,
                                                                      want))
                assert same, ("old", name, piece)
                row["old_ms"], row["new_ms"] = _turns(old, new, reps)
                if breakdown and piece == "iteration" and ntheta == 127:
                    row["old_split_ms"] = chip_smoke._kernel_split_ms(old, 5)
                    row["new_split_ms"] = chip_smoke._kernel_split_ms(new, 5)
            else:
                row["new_ms"] = [_ms(new, reps), _ms(new, reps)]
            rows.append(row)
            print(json.dumps(rows[-1]), flush=True)


_SOLVES = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import raytracer_tpu_torch as rt
assert rt.__file__.startswith(sys.argv[1]), rt.__file__
out = {}
for name, (nth, method, n) in {"twrapped 180x63": (180, "twrapped", 5),
                               "diag 127x63": (127, "auto", 3)}.items():
    gr, cg, U = rt.init_annulus_circulant(nth, 63, spacing=20.0)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    solver = rt.AnnulusSolver(gr, None, None, U, method=method, circulant=cg)
    solver.solve(src, want_prev=False)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(src, want_prev=False)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out[name] = dict(method=solver.method, iterations=solver.last_iterations,
                     median_ms=statistics.median(times), ms=times)
print(json.dumps(out))
"""


def solves_ab(old_root, rows):
    """The twrapped solve at 180x63 and the diag solve at 127x63 of the
    package in `old_root` and of this one, each in its own process, in
    the order old, new, new, old."""
    for label, root in (("old", old_root), ("new", ROOT), ("new", ROOT),
                        ("old", old_root)):
        p = subprocess.run([sys.executable, "-c", _SOLVES,
                            os.path.abspath(root)], check=True,
                           capture_output=True, text=True)
        rows.append(dict(solves=label, **json.loads(p.stdout.splitlines()[-1])))
        print(json.dumps(rows[-1]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True,
                    help="directory with the earlier kernel sources")
    ap.add_argument("--kernels", default="titer,diag",
                    help="comma-separated: titer, diag, witer, relax, fused, "
                         "plane3d")
    ap.add_argument("--old-pkg", default=None,
                    help="directory holding an earlier raytracer_tpu_torch, "
                         "to time whole solves against")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
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
        if "titer" in want:
            titer_ab(_old_lib(a.old, "titer", tmp), a.reps, rows,
                     a.breakdown)
        if "diag" in want:
            diag_ab(_old_lib(a.old, "diag", tmp), a.reps, rows, a.breakdown)
        if "fused" in want:
            fused_ab(_old_lib(a.old, "fused", tmp), max(1, a.reps // 4), rows)
        if "witer" in want:
            witer_ab(_old_lib(a.old, "witer", tmp), a.reps, rows,
                     a.breakdown)
        if "relax" in want:
            relax_ab(_old_lib(a.old, "relax", tmp), a.reps, rows)
        if "plane3d" in want:
            plane3d_ab(_old_lib(a.old, "plane3d", tmp), a.reps, rows,
                       a.breakdown, tmp)
        if a.breakdown and "fused" in want:
            fused_breakdown(tmp, {"old": a.old, "new": kernels.CSRC_DIR},
                            max(1, a.reps // 4), rows)
        if a.old_pkg:
            solves_ab(a.old_pkg, rows)
    print(_smi())


if __name__ == "__main__":
    main()
