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
          (star 1, down): along each axis at S=1 and S=8 in float32,
          along axis 0 in float64 (the earlier plane3d.cu, one block a
          source, with plane3d_launch(din, dout, W, t0f, t0b, t1f, t1b,
          carry, xbuf, S, nA, p0, p1, ns, nc, n_cross, n_inpl, down,
          planes, smem, is_double, taps, stream); the package's through
          its wrapper); with --breakdown both built with one step of a
          pass left out at a time (timing only: each computes another
          function), and the package's on clusters of 4, 8 and 16
          blocks (8 and 16 also at S=8), along axes 0 and 1;
  tsweep  one theta-column sweep of the xla engine at 180x63: S=1 and S=8
          in float32 and S=1 in float64, forward and backward, with and
          without carry_init, and S=1 float32 without col_relax (the
          earlier tsweep.cu with tsweep_launch(v, out, carry1, carry2,
          w1, w2, w0, cfp, cbp, offs, S, nt, ML, n1, n2, n0, L, reverse,
          col_relax, threads, is_double, stream)); with --breakdown the
          earlier one with one piece of its in-column step left out
          (the weight load, the `%`, the neighbour read, the barrier),
          the package's at 1, 2 and 4 lanes a thread, with one weight
          row, batches of half and twice the rows and without the step
          barrier, and one dependent step alone in a block of 896 threads
          and in clusters of 2 and 4 (distributed shared memory, a
          cluster barrier a step), with the us a step;
  banded_gs one Gauss-Seidel direction on the production Delaunay
          annulus (RCM, B = 512, P = 2): the mean over solve_banded_gs's
          66 directions and the 33-round solve, float32 S=1 and S=8 and
          float64 S=1 (the earlier banded.cu with banded_gs_launch(din,
          dtmp, dout, toff, tcol, tw, didx, hoff, hsrc, n_dest, S, n_pad,
          B, P, forward, smem, is_double, stream); the package's window
          route); with --breakdown the package's with one piece of a pass
          left out (the taps, the ring gather, the pass barriers), with
          the next block's staging waited at once, and with P = 1 and 0;
  bfm_step one BFM step, each step of a whole solve from the plain
          version's states: 180x63 S=1 and S=8 float32, 48x12 float64,
          and bfm_ms level 1's masked step at 180x63 (the earlier
          ell_bfm.cu's two launches, ell_bfm_step_launch; the package's
          push route, and its pull route); with --breakdown the push
          route with the flags' push, the state's copy or the grid sync
          left out;
  bend    a whole bend in one launch: the --refine fan (150 x 128 x 2,
          quad 8, 800 steps) in float32 and float64 and a table-shaped
          sub-batch (1,024 x 384 x 2, quad 16, 1,600 steps, float64), and
          the package's kernel at eleven other plans (threads x lanes)
          (the earlier bend.cu with bend_launch(P, mu, nu, bestP, bestT,
          ts, tab, n_tab, r0, inv_dr, lr, r_max, count0, iters, quad, B,
          m, d, flags, is_double, stream)); with --breakdown the
          package's with one piece of a step left out (the vertex update,
          the gradient, the warps' sum, the barriers, the shuffles, all
          but a lane's first point, the eval, the eval and the update),
          with IEEE divisions and square roots, the points unrolled by 8,
          by 4 or not at all, and the slowness table in shared memory;
  paths   the walk of the 150-receiver fan on the 180x63 sweep prev
          (max_len 972) as nodes, COO rows and dense rows in float64 and
          dense rows in float32, each version as its wrapper calls it
          (the earlier paths.cu with paths_launch(prev, source,
          receivers, n_rec, max_len, nodes, coords, ndim, n, U, partners,
          P, ids, vals, dense, is_double, stream) after torch.zeros of
          the dense matrix); with --breakdown the package's with the
          column sums, the dense writes, the jump levels, the pair terms
          or the rows' lam and mu left out, the earlier one's forms, and
          the device time by kernel;
  banded_sweep the Jacobi solve of the production Delaunay annulus as
          solve_banded runs it: the earlier kernel an iteration a launch
          with a host read every 8 (banded_sweep_launch(dist0, dist1,
          toff, tcol, tw, didx, hoff, hsrc, it_in, changed_in, it_out,
          changed_out, S, n_pad, max_iters, is_double, stream)), the
          package's the whole solve in one launch; float32 S=1 and S=8,
          float64; with --breakdown launches of 1 and 8 iterations, the
          global route, a fixed 214 iterations with one piece left out,
          the window's loads one at a time, and two blocks of 256 an SM;
  gridsearch a call at the location path's shape (K 12, 150,121 nodes):
          64 events in both formulas and types, and `locate`'s one
          event (the earlier gridsearch_launch(T, K, n, obs, E, w2, W2, A,
          s1, expanded, pm, pj, j, t0, m, is_double, stream) behind its
          wrapper's torch ops); with --breakdown the package's with one
          piece left out, in three other shapes, and at E = 8 to 512.
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
import time

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


# --breakdown for plane3d: the (anchor, replacement) pairs that leave one
# step of a pass out (timing only: each computes another function).  The
# earlier csrc/plane3d.cu (one block a source, scans with a block barrier
# a level):
_PLANE3D_OLD_SKIP = {
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
# the package's (a cluster of blocks a source, warp-owned line scans):
_PLANE3D_GATHER = "    for (int e = threadIdx.x; e < p0 * ncols; e += nth) {\n"
_PLANE3D_NEW_SKIP = {
    "no cross taps": _PLANE3D_OLD_SKIP["no cross taps"],
    "no in-plane taps": [("    for (int t = n_cross; t < te; t += 2) {\n",
                          "    for (int t = n_cross; t < n_cross; t += 2) {\n")],
    "no axis-0 levels": [("    for (int c = warp; c < ncols; c += nwarps)\n",
                          "    for (int c = warp; c < 0; c += nwarps)\n")],
    "no axis-0 exchange": [(_PLANE3D_GATHER, _PLANE3D_GATHER.replace(
        "p0 * ncols", "0"))] * 2,
    "no axis-1 levels": [("      scan_line(Fl, Gl, p1,",
                          "      if (false) scan_line(Fl, Gl, p1,")],
    "no cluster barrier": [
        ("    if (cs == 1)\n      __syncthreads();\n    else\n      cl.sync();\n",
         "    __syncthreads();\n"),
        ('      asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: '
         '"memory");\n      f();\n      asm volatile("barrier.cluster.wait.'
         'acquire.aligned;\\n" ::: "memory");\n',
         "      f();\n      __syncthreads();\n")],
    "no tree copies": [("      cp_async_commit();\n    }\n",
                        "    }\n"),
                       ("        copy_async(tr0f", "        if (false) "
                        "copy_async(tr0f"),
                       ("        copy_async(tr0b", "        if (false) "
                        "copy_async(tr0b"),
                       ("        copy_async(tr1f", "        if (false) "
                        "copy_async(tr1f"),
                       ("        copy_async(tr1b", "        if (false) "
                        "copy_async(tr1b")],
    "no prefetch": [("    if (!can_prefetch || threadIdx.x", "    if (true || "
                     "!can_prefetch || threadIdx.x")],
}


def _plane3d_old_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.plane3d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p] * 2)
    return lib


def _plane3d_new_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.plane3d_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                   + [ctypes.c_void_p] * 2)
    return lib


def _plane3d_old_pass(lib, d, lay, axis, shifts):
    """run() of one pass (down) of the earlier plane3d.cu: one block of
    1,024 threads a source, up to three planes in shared memory (launch
    interface plane3d_launch(din, dout, W, t0f, t0b, t1f, t1b, carry,
    xbuf, S, nA, p0, p1, ns, nc, n_cross, n_inpl, down, planes, smem,
    is_double, taps, stream))."""
    from raytracer_tpu_torch.ops import plane3d as p3

    xs = torch.movedim(d, 1 + axis, 1).contiguous()
    S, nA, p0, p1 = xs.shape
    one = p0 * p1 * d.element_size()
    planes = min(3, kernels.BLOCK_SMEM // one)
    _, cross, inpl, _ = p3.plane_taps(shifts, axis, True)
    taps = p3._tap_table(shifts, axis, True, d.device)
    xbuf = torch.empty((S, p0 * p1), dtype=d.dtype, device=d.device)
    t0f, t0b, t1f, t1b = lay.trees

    def run():
        out = torch.empty_like(xs)
        rc = lib.plane3d_launch(
            xs.data_ptr(), out.data_ptr(), lay.W.data_ptr(), t0f.data_ptr(),
            t0b.data_ptr(), t1f.data_ptr(), t1b.data_ptr(), 0,
            xbuf.data_ptr() if planes == 1 else 0, S, nA, p0, p1,
            len(shifts), 0, sum(len(c) for c in cross), len(inpl), 1, planes,
            planes * one, int(d.dtype == torch.float64), taps.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return torch.movedim(out, 1, 1 + axis)
    return run


def plane3d_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier plane3d kernel and the package's, in turns, one pass
    (down) at chip_smoke's 128x128x64 wedge: along each axis at S=1 and
    S=8 in float32, along axis 0 in float64, both held bit-equal to
    plane_sweep3d_reference first; the package's through the wrapper
    plane_sweep3d (its route as plane3d_plan picks it), the earlier
    through its own launch interface.  With `breakdown`, both sources
    built with one step of a pass left out at a time (and the three taps
    and scans together, the earlier's), and the package's at clusters of
    4, 8 and 16 blocks (8 and 16 also at S=8), along axes 0 and 1 in
    float32."""
    from raytracer_tpu_torch.ops import plane3d as p3
    from raytracer_tpu_torch.solvers import solve3d as s3

    with open(os.path.join(old_dir, "plane3d.cu")) as f:
        old_text = f.read()
    old_lib = _plane3d_old_bind(_old_lib(old_dir, "plane3d", tmp))
    own = p3._plane3d_lib
    rng = np.random.default_rng(14)
    g, U = chip_smoke._wedge3d(chip_smoke.WEDGE_DIMS, 60.0, 120.0, 2500.0)
    dev = torch.device("cuda")

    def field(S, shape, dtype):
        v = rng.uniform(0.0, 500.0, (S,) + shape).astype(dtype)
        v[rng.random(v.shape) < 0.3] = np.inf
        return torch.from_numpy(v).cuda()

    def new_pass(lib, d, lay, axis, shifts):
        def run():
            p3._plane3d_lib = lambda: lib
            return p3.plane_sweep3d(d, lay, axis, True, None, shifts)
        return run

    try:
        new_lib = _plane3d_new_bind(own())
        for dtype, cases in ((np.float32, ((0, 1), (1, 1), (2, 1), (0, 8),
                                           (1, 8), (2, 8))),
                             (np.float64, ((0, 1),))):
            pk = rt.prepare3d(g, U, rt.SolverConfig(dtype=np.dtype(dtype)
                                                    .name))
            lays = s3._device_layout(pk, "sweep", dev)
            for axis, S in cases:
                d = field(S, pk.shape, dtype)
                runs = {"old": _plane3d_old_pass(old_lib, d, lays[axis], axis,
                                                 pk.shifts),
                        "new": new_pass(new_lib, d, lays[axis], axis,
                                        pk.shifts)}
                want = p3.plane_sweep3d_reference(d, lays[axis], axis, True,
                                                  None, pk.shifts)
                for k, run in runs.items():
                    got = run()
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (k, axis, S, dtype)
                o, n = _turns(runs["old"], runs["new"], reps)
                pl = p3.plane3d_plan(*want.movedim(1 + axis, 1).shape[2:],
                                     d.element_size())
                rows.append(dict(kernel="plane3d", grid="128x128x64",
                                 axis=axis, S=S, dtype=np.dtype(dtype).name,
                                 planes=int(lays[axis].W.shape[0]),
                                 cluster=pl.cluster, threads=pl.threads,
                                 smem=pl.smem, old_ms=o, new_ms=n,
                                 bit_equal=True))
                print(json.dumps(rows[-1]), flush=True)
            if breakdown and dtype == np.float32:
                with open(kernels.source_path("plane3d")) as f:
                    new_text = f.read()
                old_skip = dict(_PLANE3D_OLD_SKIP)
                old_skip["only the write"] = [
                    pair for k in ("no cross taps", "no in-plane taps",
                                   "no scans") for pair in old_skip[k]]
                old_vars = _variants(old_text, old_skip, tmp, "plane3d_old",
                                     _plane3d_old_bind)
                new_vars = _variants(new_text, _PLANE3D_NEW_SKIP, tmp,
                                     "plane3d_new", _plane3d_new_bind)
                d1 = field(1, pk.shape, dtype)
                d8 = field(8, pk.shape, dtype)
                for rep in range(2):
                    split = {}
                    for ax in (0, 1):
                        lay = lays[ax]
                        split[f"old full axis {ax}"] = _ms(_plane3d_old_pass(
                            old_lib, d1, lay, ax, pk.shifts), reps)
                        for name, lib in old_vars.items():
                            split[f"old {name} axis {ax}"] = _ms(
                                _plane3d_old_pass(lib, d1, lay, ax,
                                                  pk.shifts), reps)
                        split[f"new full axis {ax}"] = _ms(new_pass(
                            new_lib, d1, lay, ax, pk.shifts), reps)
                        for name, lib in new_vars.items():
                            split[f"new {name} axis {ax}"] = _ms(new_pass(
                                lib, d1, lay, ax, pk.shifts), reps)
                        keep = p3.PLANE3D_CLUSTER
                        try:
                            for c, S in ((4, 1), (8, 1), (16, 1), (8, 8),
                                         (16, 8)):
                                p3.PLANE3D_CLUSTER = c
                                key = f"new cluster {c} S={S} axis {ax}"
                                try:
                                    split[key] = _ms(new_pass(
                                        new_lib, d1 if S == 1 else d8, lay,
                                        ax, pk.shifts), reps)
                                except RuntimeError as e:  # a refused launch
                                    split[key] = str(e)
                        finally:
                            p3.PLANE3D_CLUSTER = keep
                    rows.append(dict(kernel="plane3d", split_ms=split,
                                     turn=rep))
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


# --breakdown for tsweep: the (anchor, replacement) pairs that leave one
# piece of an in-column step out of the earlier csrc/tsweep.cu (the
# one-block, one-barrier-a-step design; timing only: each computes
# another function but "no %", whose wrap is the same)
_TSWEEP_OLD_STEP = ("          nxt[m] = min_of(cur[m], add_rn(cur[wrap(m + d, "
                    "ML)], w[m]));\n")
_TSWEEP_OLD_SKIP = {
    "no weight load": [(_TSWEEP_OLD_STEP, _TSWEEP_OLD_STEP.replace(
        "w[m]", "T(1)"))],
    "no %": [("  i %= n;\n  return i < 0 ? i + n : i;\n",
              "  return i < 0 ? i + n : (i >= n ? i - n : i);\n")],
    "no neighbour read": [(_TSWEEP_OLD_STEP, _TSWEEP_OLD_STEP.replace(
        "cur[wrap(m + d, ML)]", "cur[m]"))],
    "no barrier": [("        __syncthreads();\n        T* tmp = cur;\n",
                    "        T* tmp = cur;\n")],
    "barrier only": [("        for (int m = threadIdx.x; m < ML; m += nth)\n"
                      + _TSWEEP_OLD_STEP, "")],
}
# the package's csrc/tsweep.cu without the barrier of an in-column step,
# with every row reading the first weight row (timing only), and with
# batches of half and twice the rows
_TSWEEP_NEW_SKIP = {
    "no chain barrier": [("          __syncthreads();\n          T* tmp = A;\n",
                          "          T* tmp = A;\n")],
    "one weight row": [("    wrow[i] = p;\n", "    wrow[i] = w1;\n")],
    "batches of half": [("  constexpr int K = 8 / LPT > 0 ? 8 / LPT : 1;",
                         "  constexpr int K = 4 / LPT > 0 ? 4 / LPT : 1;")],
    "batches of twice": [("  constexpr int K = 8 / LPT > 0 ? 8 / LPT : 1;",
                          "  constexpr int K = 16 / LPT;")],
}

# the cost of one dependent step alone: a neighbour read, a min-plus
# update, a write and a barrier, in one block of `threads` threads (a
# lane each) or in a cluster of `cs` blocks each holding ML / cs lanes,
# the neighbour read through distributed shared memory and a cluster
# barrier a step (timing only)
_STEP_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void step_block(float* out, int n, int ml, int off) {
  extern __shared__ float buf[];
  float* A = buf;
  float* B = buf + ml;
  const int m = threadIdx.x;
  float r = static_cast<float>(m);
  A[m] = r;
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    int j = m + off;
    j = j >= ml ? j - ml : j;
    r = fminf(r, __fadd_rn(A[j], 1.0f));
    B[m] = r;
    __syncthreads();
    float* t = A;
    A = B;
    B = t;
  }
  out[blockIdx.x * blockDim.x + m] = r;
}
__global__ void step_cluster(float* out, int n, int ml, int off) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float buf[];
  const int loc = blockDim.x, rank = static_cast<int>(cl.block_rank());
  float* A = buf;
  float* B = buf + loc;
  const int m = rank * loc + threadIdx.x;
  float r = static_cast<float>(m);
  A[threadIdx.x] = r;
  cl.sync();
  for (int i = 0; i < n; ++i) {
    int j = m + off;
    j = j >= ml ? j - ml : j;
    const float* src = cl.map_shared_rank(A, j / loc);
    r = fminf(r, __fadd_rn(src[j % loc], 1.0f));
    B[threadIdx.x] = r;
    cl.sync();
    float* t = A;
    A = B;
    B = t;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}
extern "C" int step_block_run(float* out, int n, int ml, int off) {
  step_block<<<1, ml, 2 * ml * sizeof(float)>>>(out, n, ml, off);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int step_cluster_run(float* out, int n, int ml, int off, int cs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(ml / cs);
  cfg.dynamicSmemBytes = 2 * (ml / cs) * sizeof(float);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, step_cluster, out, n, ml, off));
}
"""


def _variants(text: str, skips: dict, tmp: str, tag: str, bind) -> dict:
    """`text` with each entry of `skips` applied (the entries whose anchors
    it lacks are left out), built in parallel with the package's flags;
    name -> the bound library."""
    from concurrent.futures import ThreadPoolExecutor

    todo = {}
    for name, pairs in skips.items():
        t = text
        if all(a in t for a, _ in pairs):
            for a, b in pairs:
                t = t.replace(a, b, 1)
            todo[name] = t

    def make(item):
        name, t = item
        stem = f"{tag}_" + "".join(c if c.isalnum() else "_" for c in name)
        src = os.path.join(tmp, stem + ".cu")
        with open(src, "w") as f:
            f.write(t)
        return name, bind(_build(src, tmp, stem, "-I", kernels.CSRC_DIR))

    with ThreadPoolExecutor(max(1, len(todo))) as ex:
        return dict(ex.map(make, todo.items()))


def _tsweep_old_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.tsweep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    return lib


def _tsweep_new_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.tsweep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    return lib


def _tsweep_tables(nt, nr, sp, dtype):
    from raytracer_tpu_torch.ops import sweep_theta as sw
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    _, cg, _ = rt.init_annulus_circulant(nt, nr, sp, dtype=dtype)
    ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
    t, st = sw.pack_sweep_tables(ws, cg, dtype)
    return sw.tables_to_device(t, "cuda"), st


def _tsweep_old_run(lib, v, tbl, st, reverse, col_relax, carry):
    """run() of the earlier tsweep.cu (launch interface tsweep_launch(v,
    out, carry1, carry2, w1, w2, w0, cfp, cbp, offs, S, nt, ML, n1, n2,
    n0, L, reverse, col_relax, threads, is_double, stream))."""
    from raytracer_tpu_torch.ops import sweep_theta as sw

    g1_w, g1_d, g2_w, g2_d, w0, d0 = sw._tap_groups(tbl, st, reverse)
    offs = torch.tensor(g1_d + g2_d + d0 + st.chain_spans,
                        dtype=torch.int32, device="cuda")
    threads = min(1024, -(-st.ML // 32) * 32)
    L = len(st.chain_spans)

    def run():
        out = torch.empty_like(v)
        rc = lib.tsweep_launch(
            v.data_ptr(), out.data_ptr(),
            carry[0].data_ptr() if carry else 0,
            carry[1].data_ptr() if carry else 0, g1_w.data_ptr(),
            g2_w.data_ptr(), w0.data_ptr(), tbl.cfp.data_ptr(),
            tbl.cbp.data_ptr(), offs.data_ptr(), v.shape[0], st.nt, st.ML,
            len(g1_d), len(g2_d), len(d0), L, int(reverse), int(col_relax),
            threads, int(v.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out
    return run


def _tsweep_new_run(lib, v, tbl, st, reverse, col_relax, carry, lpt=None):
    """run() of the package's tsweep.cu build `lib` on the plan of
    tsweep_plan (its lanes a thread forced when given)."""
    from raytracer_tpu_torch.ops import sweep_theta as sw

    g1_w, g1_d, g2_w, g2_d, w0, d0 = sw._tap_groups(tbl, st, reverse)
    keep = sw.TSWEEP_THREADS
    try:  # the thread cap that gives `lpt` lanes a thread
        if lpt:
            sw.TSWEEP_THREADS = (-(-st.ML // lpt) + 31) // 32 * 32
        plan = sw.tsweep_plan(st.ML, v.element_size(), g1_d, g2_d, d0,
                              st.chain_spans, col_relax)
    finally:
        sw.TSWEEP_THREADS = keep
    assert lpt is None or plan.lpt == lpt, (lpt, plan.lpt)
    offs = torch.from_numpy(plan.offs).cuda()
    L = len(st.chain_spans)

    def run():
        out = torch.empty_like(v)
        rc = lib.tsweep_launch(
            v.data_ptr(), out.data_ptr(),
            carry[0].data_ptr() if carry else 0,
            carry[1].data_ptr() if carry else 0, g1_w.data_ptr(),
            g2_w.data_ptr(), w0.data_ptr(), tbl.cfp.data_ptr(),
            tbl.cbp.data_ptr(), offs.data_ptr(), v.shape[0], st.nt, st.ML,
            len(g1_d), len(g2_d), len(d0), L, plan.halo, int(reverse),
            int(col_relax), plan.lpt, plan.threads, plan.smem,
            int(v.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out
    run.plan = plan
    return run


def tsweep_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier tsweep kernel and the package's, in turns, one sweep at
    180x63 (the xla engine's column): S=1 and S=8 float32 and S=1 float64,
    forward and backward, with and without carry_init, with col_relax;
    and S=1 float32 forward without col_relax; both held bit-equal to
    _sweep first.  With `breakdown`: the earlier kernel built with one
    piece of its in-column step left out at a time, the package's at
    each lanes-a-thread route, with every row on the first weight row (no
    weight stream), with batches of half and twice the rows and without
    the barrier of an in-column step, and one
    dependent step alone (a shared-memory neighbour read, update, write
    and barrier) in one block of 896 threads and in clusters of 2 and 4
    blocks through distributed shared memory, all at S=1 float32
    forward; per-step figures are ms over the sweep's nt * (n0 + 2L)
    in-column steps."""
    from raytracer_tpu_torch.ops import sweep_theta as sw

    with open(os.path.join(old_dir, "tsweep.cu")) as f:
        old_text = f.read()
    old_lib = _tsweep_old_bind(_old_lib(old_dir, "tsweep", tmp))
    new_lib = _tsweep_new_bind(sw._tsweep_lib())
    rng = np.random.default_rng(20)
    cases = [(np.float32, 1, rev, c, True) for rev in (False, True)
             for c in (False, True)]
    cases += [(np.float32, 8, rev, c, True) for rev in (False, True)
              for c in (False, True)]
    cases += [(np.float64, 1, rev, c, True) for rev in (False, True)
              for c in (False, True)]
    cases += [(np.float32, 1, False, False, False)]
    tabs = {}
    for dtype, S, rev, with_carry, col_relax in cases:
        if dtype not in tabs:
            tabs[dtype] = _tsweep_tables(180, 63, 20.0, dtype)
        tbl, st = tabs[dtype]
        v = rng.uniform(0.0, 1500.0, (S, st.nt, st.ML)).astype(dtype)
        v[rng.random(v.shape) < 0.4] = np.inf
        v = torch.from_numpy(v).cuda()
        carry = tuple(torch.from_numpy(rng.uniform(0.0, 1500.0, (
            S, st.ML)).astype(dtype)).cuda() for _ in range(2)) \
            if with_carry else None
        want = sw._sweep(v, tbl, st, rev, col_relax, carry)
        old = _tsweep_old_run(old_lib, v, tbl, st, rev, col_relax, carry)
        new = _tsweep_new_run(new_lib, v, tbl, st, rev, col_relax, carry)
        for k, run in (("old", old), ("new", new)):
            got = run()
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, dtype, S, rev, with_carry)
        o, n = _turns(old, new, reps)
        rows.append(dict(kernel="tsweep", grid="180x63", S=S,
                         dtype=np.dtype(dtype).name, reverse=rev,
                         carry=with_carry, col_relax=col_relax,
                         lpt=new.plan.lpt, threads=new.plan.threads,
                         old_ms=o, new_ms=n, bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)
    if not breakdown:
        return
    tbl, st = tabs[np.float32]
    n0 = len(sw._tap_groups(tbl, st, False)[5])
    steps = st.nt * (n0 + 2 * len(st.chain_spans))
    v = torch.from_numpy(rng.uniform(0.0, 1500.0, (1, st.nt, st.ML)).astype(
        np.float32)).cuda()
    with open(kernels.source_path("tsweep")) as f:
        new_text = f.read()
    old_vars = _variants(old_text, _TSWEEP_OLD_SKIP, tmp, "tsweep_old",
                         _tsweep_old_bind)
    new_vars = _variants(new_text, _TSWEEP_NEW_SKIP, tmp, "tsweep_new",
                         _tsweep_new_bind)
    probe = _build_probe(tmp)
    out = torch.empty(4096, device="cuda")
    for turn in range(2):
        split = {"old full": _ms(_tsweep_old_run(old_lib, v, tbl, st, False,
                                                 True, None), reps),
                 "old without col_relax": _ms(_tsweep_old_run(
                     old_lib, v, tbl, st, False, False, None), reps)}
        for name, lib in old_vars.items():
            split["old " + name] = _ms(_tsweep_old_run(lib, v, tbl, st, False,
                                                       True, None), reps)
        for lpt in (1, 2, 4):
            split[f"new lpt {lpt}"] = _ms(_tsweep_new_run(
                new_lib, v, tbl, st, False, True, None, lpt), reps)
        split["new without col_relax"] = _ms(_tsweep_new_run(
            new_lib, v, tbl, st, False, False, None), reps)
        for name, lib in new_vars.items():
            split["new " + name] = _ms(_tsweep_new_run(lib, v, tbl, st, False,
                                                       True, None), reps)
        def step(cs):
            def run():
                rc = (probe.step_block_run(out.data_ptr(), steps, st.ML, 7)
                      if cs == 1 else probe.step_cluster_run(
                          out.data_ptr(), steps, st.ML, 7, cs))
                assert rc == 0, (cs, rc)
            return run

        split["step alone, one block"] = _ms(step(1), reps)
        for cs in (2, 4):
            split[f"step alone, cluster of {cs}"] = _ms(step(cs), reps)
        rows.append(dict(kernel="tsweep", split_ms=split, turn=turn,
                         steps=steps, us_per_step={
                             k: 1e3 * x / steps for k, x in split.items()}))
        print(json.dumps(rows[-1]), flush=True)


# ---- banded_gs: the window route against the earlier kernel ----

# pieces of csrc/banded.cu gs_window_kernel left out (timing only: each
# computes another function)
_GS_NEW_SKIP = {
    "no taps": [("          for (int u = 0; u < 8; u += 2) {\n            v0 = min_of(v0, add_rn(r[u], w[u]));\n            v1 = min_of(v1, add_rn(r[u + 1], w[u + 1]));\n          }",
                 "          for (int u = 0; u < 8; u += 2) {\n          }"),
                ("        for (; k < D; ++k) v0 = min_of(v0, add_rn(ring[ip[32 * k]], wp[32 * k]));\n", "")],
    "no ring gather": [("#pragma unroll\n          for (int u = 0; u < 8; ++u) r[u] = ring[j[u]];",
                        "#pragma unroll\n          for (int u = 0; u < 8; ++u) r[u] = w[u] + j[u];"),
                       ("add_rn(ring[ip[32 * k]], wp[32 * k])",
                        "add_rn(wp[32 * k], wp[32 * k])")],
    "staging waited at once": [("      stage_taps(q + 1, rb_of(q + 1), n0, n1);\n      cp_async_commit();\n",
                                "      stage_taps(q + 1, rb_of(q + 1), n0, n1);\n      cp_async_commit();\n      cp_async_wait_all();\n")],
    "no pass barriers": [("      __syncthreads();\n      const bool last = p + 1 == P;",
                          "      const bool last = p + 1 == P;"),
                         ("      if (!last) __syncthreads();\n", "")],
}


def _gs_old_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.banded_gs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    return lib


def _gs_new_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.banded_gs_window_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    return lib


def _gs_old_call(lib, d, bg, forward, passes=2):
    """One direction of the earlier banded_gs (launch interface
    banded_gs_launch(din, dtmp, dout, toff, tcol, tw, didx, hoff, hsrc,
    n_dest, S, n_pad, B, P, forward, smem, is_double, stream))."""
    S, n_pad = d.shape
    out = torch.empty_like(d)
    n_dest = int(bg.hoff.shape[0]) - 1
    tmp = torch.empty_like(d) if n_dest > 0 else out
    rc = lib.banded_gs_launch(
        d.data_ptr(), tmp.data_ptr(), out.data_ptr(), bg.toff.data_ptr(),
        bg.tcol.data_ptr(), bg.tw.data_ptr(), bg.didx.data_ptr(),
        bg.hoff.data_ptr(), bg.hsrc.data_ptr(), n_dest, S, n_pad, 512,
        passes, int(forward), 2 * 512 * d.element_size(),
        int(d.dtype == torch.float64), torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def _gs_new_call(lib, d, bg, forward, passes=2):
    """One direction of a build `lib` of the package's banded.cu on the
    window route (its layout from the package)."""
    from raytracer_tpu_torch.ops import banded as pb

    lay = pb._gs_route(bg, 512)
    p = lay.plan
    S, n_pad = d.shape
    out = torch.empty_like(d)
    n_dest = int(bg.hoff.shape[0]) - 1
    tmp = torch.empty_like(d) if n_dest > 0 else out
    rc = lib.banded_gs_window_launch(
        d.data_ptr(), tmp.data_ptr(), out.data_ptr(), lay.meta.data_ptr(),
        lay.idx.data_ptr(), lay.w.data_ptr(), lay.blk.data_ptr(),
        bg.didx.data_ptr(), bg.hoff.data_ptr(), bg.hsrc.data_ptr(), n_dest,
        S, n_pad, 512, passes, int(forward), p.K, p.Wr, p.G32, p.nmax,
        p.smem, int(d.dtype == torch.float64),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def _gs_solve(call, d, rounds):
    """`rounds` Gauss-Seidel rounds (forward then backward) with the host
    read of solve_banded_gs's changed flag after each."""
    for _ in range(rounds):
        n = call(call(d, True), False)
        bool((n < d).any())
        d = n
    return d


def banded_gs_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier banded_gs and the package's (the window route), in
    turns, on the production Delaunay annulus (the RCM order, B = 512,
    P = 2): a direction's mean over the 66 directions of solve_banded_gs
    (33 rounds from the surface source), float32 S=1, float64 S=1 and
    float32 S=8 (the sources of chip_smoke.py phase 16), and the solve
    itself (the 33 rounds with their host reads); both held bit-equal to
    banded_gs_reference after every direction first.  With `breakdown`:
    the package's built with one piece of a pass left out (the taps, the
    ring gather, the pass barriers) and run with P = 1 and P = 0, float32
    S=1 (timing only), and one that
    waits for the next block's staging as soon as it starts (the
    copies' time not hidden)."""
    from raytracer_tpu_torch.ops import banded as pb

    old = _gs_old_bind(_old_lib(old_dir, "banded", tmp))
    new = _gs_new_bind(pb._banded_lib())
    dg = rt.add_midpoints(rt.triangle_annulus_2d(**chip_smoke.DELAUNAY))
    dA = rt.node_adjacency(dg, star=0)
    U = chip_smoke._ak135_vp(dg)
    src = rt.closest_point(dg, 0.0, rt.R, system="polar")
    srcs8 = [rt.closest_point(dg, np.deg2rad(d), rt.R, system="polar")
             for d in np.linspace(0.0, 175.0, 8)]
    rounds = chip_smoke.JAX_BANDED["gs"][0]
    bgs = {}
    for dtype, srcs in (("float32", [src]), ("float64", [src]),
                        ("float32", srcs8)):
        cfg = rt.SolverConfig(dtype=dtype)
        if dtype not in bgs:
            bgs[dtype] = rt.prepare_banded(dA, chip_smoke._no_halo(), dg, U,
                                           cfg)
        bg = bgs[dtype]
        twin = chip_smoke._dense_on_card(bg)
        d0 = pb._sources(bg, srcs, cfg)
        d = d0
        for k in range(2 * rounds):      # bit-equal after every direction
            fwd = k % 2 == 0
            want = pb.banded_gs_reference(d, twin, fwd)
            for name, lib, call in (("old", old, _gs_old_call),
                                    ("new", new, _gs_new_call)):
                got = call(lib, d, bg, fwd)
                assert torch.equal(got, want), (name, dtype, len(srcs), k)
            d = want

        def dirs(lib, call):
            def run():
                x = d0
                for k in range(2 * rounds):
                    x = call(lib, x, bg, k % 2 == 0)
            return run

        o, n = _turns(dirs(old, _gs_old_call), dirs(new, _gs_new_call),
                      max(1, reps // 4))
        so, sn = _turns(lambda: _gs_solve(lambda x, f: _gs_old_call(
            old, x, bg, f), d0, rounds), lambda: _gs_solve(
            lambda x, f: _gs_new_call(new, x, bg, f), d0, rounds),
            max(1, reps // 4))
        rows.append(dict(kernel="banded_gs", mesh="Delaunay nr=60",
                         dtype=dtype, S=len(srcs),
                         old_ms=[x / (2 * rounds) for x in o],
                         new_ms=[x / (2 * rounds) for x in n],
                         old_solve_ms=so, new_solve_ms=sn,
                         plan=pb._gs_route(bg, 512).plan._asdict(),
                         bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)
    if not breakdown:
        return
    bg = bgs["float32"]
    d0 = pb._sources(bg, [src], rt.SolverConfig())
    with open(kernels.source_path("banded")) as f:
        text = f.read()
    libs = {"new": new, **_variants(text, _GS_NEW_SKIP, tmp, "gs_new",
                                    _gs_new_bind)}

    def dirs(lib, passes):
        def run():
            x = d0
            for k in range(2 * rounds):
                x = _gs_new_call(lib, x, bg, k % 2 == 0, passes)
        return run

    for turn in range(2):
        split = {name: _ms(dirs(lib, 2), max(1, reps // 4)) / (2 * rounds)
                 for name, lib in libs.items()}
        for passes in (1, 0):
            split[f"P={passes}"] = _ms(dirs(new, passes),
                                       max(1, reps // 4)) / (2 * rounds)
        split["old"] = _ms(lambda: [_gs_old_call(old, d0, bg, k % 2 == 0)
                                    for k in range(2 * rounds)],
                           max(1, reps // 4)) / (2 * rounds)
        rows.append(dict(kernel="banded_gs", split_ms=split, turn=turn,
                         phases=186))
        print(json.dumps(rows[-1]), flush=True)


# ---- bfm_step: the push route against the earlier two launches ----

_BFM_NEW_SKIP = {
    "no push": [("      for (int k = lane; k < dg; k += 32) {\n        const int j = nbr[row + k];",
                 "      for (int k = lane; k < 0; k += 32) {\n        const int j = nbr[row + k];")],
    "no state copy": [("    dist1[e] = dist0[e];\n    prev1[e] = prev0[e];\n", "")],
    "no grid sync": [("  cg::this_grid().sync();\n", "")],
}


def _bfm_bind(lib: ctypes.CDLL, push: bool) -> ctypes.CDLL:
    fn = lib.ell_bfm_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    if push:
        fn = lib.ell_bfm_push_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return lib


def _bfm_call(lib, st, g, mask, push):
    """One step of build `lib` on state st (fields (S, n_pad)): the push
    route (ell_bfm_push_launch) or the pull (ell_bfm_step_launch, the
    earlier build's only route)."""
    from raytracer_tpu_torch.ops.relax import _INT32_MAX

    d0, p0 = st.dist, st.prev
    f0 = st.front.view(torch.uint8)
    S, n_pad = d0.shape
    d1, p1, f1 = torch.empty_like(d0), torch.empty_like(p0), torch.empty_like(f0)
    it_out = torch.empty((), dtype=torch.int32, device=d0.device)
    live_out = torch.zeros((), dtype=torch.int32, device=d0.device)
    head = (d0.data_ptr(), p0.data_ptr(), f0.data_ptr(), g.nbr.data_ptr(),
            g.w.data_ptr(), g.deg.data_ptr(), g.didx.data_ptr(),
            g.hoff.data_ptr(), g.hsrc.data_ptr(),
            None if mask is None else mask.data_ptr(), st.it.data_ptr(),
            st.live.data_ptr(), d1.data_ptr(), p1.data_ptr())
    tail = (S, n_pad, g.nbr.shape[1], _INT32_MAX,
            int(d0.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if push:
        rc = lib.ell_bfm_push_launch(*head, f1.data_ptr(), it_out.data_ptr(),
                                     live_out.data_ptr(), *tail)
    else:
        imp = torch.empty_like(f0)
        rc = lib.ell_bfm_step_launch(*head, imp.data_ptr(), f1.data_ptr(),
                                     it_out.data_ptr(), live_out.data_ptr(),
                                     *tail)
    assert rc == 0, rc
    return st._replace(dist=d1, prev=p1, front=f1.view(torch.bool), it=it_out,
                       live=live_out)


def _bfm_states(g, st, mask):
    """The states of a whole solve from `st` (the plain version), each
    field (S, n_pad): every step's input."""
    from raytracer_tpu_torch.ops import relax

    out = []
    while int(st.live):
        out.append(st)
        st = relax.bfm_step_reference(st, g, None, mask)
    return out


def bfm_step_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier bfm_step (two launches: the relaxation, then the pulled
    frontier) and the package's push route (one cooperative launch), in
    turns, each step of a whole solve timed from the plain version's
    states: 180x63 S=1 and S=8 float32 (the surface source; chip_smoke.py
    phase 3f's eight), 48x12 S=1 float64, and the level-masked step of
    bfm_ms's level 1 at 180x63 float32; both held bit-equal to
    bfm_step_reference on every state first.  Also the package's pull
    route on the same states, and each version's device time a step by
    kernel (torch.profiler: a step's host call outlasts its kernels).
    With `breakdown`: the push route built with one piece left out (the
    flags' push, the state's copy, the grid sync; timing only), by its
    device time a step."""
    from raytracer_tpu_torch.models.partition import partition_grid
    from raytracer_tpu_torch.ops import relax
    from raytracer_tpu_torch.solvers.multiphase import _level_mask_t

    old = _bfm_bind(_old_lib(old_dir, "ell_bfm", tmp), False)
    new = _bfm_bind(relax._ell_bfm_lib(), True)
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    G = rt.prepare(A, halo, gr, chip_smoke._ak135_vp(gr))
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    srcs8 = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
             for d in np.linspace(0.0, 315.0, 8)]
    gs, As, hs = rt.init_annulus(48, 12, spacing=150.0)
    g48 = rt.prepare(As, hs, gs, chip_smoke._ak135_vp(gs),
                     rt.SolverConfig(dtype="float64"))
    src48 = rt.closest_point(gs, 0.0, rt.R, system="polar")
    mask = _level_mask_t(partition_grid(gr), 1, gr, G.nbr.shape[0], "cuda")
    two = lambda s: s if s.dist.dim() == 2 else s._replace(
        dist=s.dist[None], prev=s.prev[None], front=s.front[None])
    cases = [("180x63", "float32", G, [src], None),
             ("180x63", "float32", G, srcs8, None),
             ("48x12", "float64", g48, [src48], None),
             ("180x63 bfm_ms level 1", "float32", G, [src], mask)]
    states_s1 = None
    for grid, dtype, g, srcs, m in cases:
        assert g.symmetric
        st = relax.init_state(g, srcs, dtype, mask=m)
        states = [two(s) for s in _bfm_states(g, st, m)]
        if grid == "180x63" and len(srcs) == 1:
            states_s1 = states
        for s in states:                  # bit-equal on every state
            want = two(relax.bfm_step_reference(s, g, None, m))
            for name, lib, push in (("old", old, False), ("new", new, True)):
                got = _bfm_call(lib, s, g, m, push)
                for f in got._fields:
                    assert torch.equal(getattr(got, f), getattr(want, f)), (
                        name, grid, f)

        def steps(lib, push):
            return lambda: [_bfm_call(lib, s, g, m, push) for s in states]

        o, n = _turns(steps(old, False), steps(new, True), max(1, reps // 4))
        pull = _ms(steps(new, False), max(1, reps // 4))
        dev = {k: {name: t / len(states) for name, t in
                   chip_smoke._kernel_split_ms(fn, 1).items()}
               for k, fn in (("old", steps(old, False)),
                             ("new push", steps(new, True)),
                             ("new pull", steps(new, False)))}
        host = {}                    # the host's time to enqueue a step
        for k, fn in (("old", steps(old, False)),
                      ("new push", steps(new, True)),
                      ("new pull", steps(new, False)),
                      ("package bfm_step", lambda: [relax.bfm_step(
                          s, g, None, m) for s in states])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host[k] = 1e3 * (time.perf_counter() - t0) / len(states)
            torch.cuda.synchronize()
        rows.append(dict(kernel="bfm_step", grid=grid, dtype=dtype,
                         S=len(srcs), masked=m is not None, steps=len(states),
                         old_ms=[x / len(states) for x in o],
                         new_ms=[x / len(states) for x in n],
                         new_pull_ms=pull / len(states),
                         device_ms_by_kernel=dev, host_ms_a_call=host,
                         bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)
    if not breakdown:
        return
    with open(kernels.source_path("ell_bfm")) as f:
        text = f.read()
    libs = {"push": new, **_variants(text, _BFM_NEW_SKIP, tmp, "bfm_new",
                                     lambda lib: _bfm_bind(lib, True))}
    for turn in range(2):    # device ms a step (torch.profiler)
        split = {name: sum(chip_smoke._kernel_split_ms(
            lambda: [_bfm_call(lib, s, G, None, True) for s in states_s1],
            1).values()) / len(states_s1) for name, lib in libs.items()}
        split["old (pull, two launches)"] = sum(chip_smoke._kernel_split_ms(
            lambda: [_bfm_call(old, s, G, None, False) for s in states_s1],
            1).values()) / len(states_s1)
        rows.append(dict(kernel="bfm_step", split_ms=split, turn=turn,
                         steps=len(states_s1)))
        print(json.dumps(rows[-1]), flush=True)


# ---- bend: the lane-shared design against the earlier one ----

_BEND_NEW_SKIP = {
    "no update": [("    for (int v = threadIdx.x; v < m; v += blockDim.x) {\n      const T fr",
                   "    for (int v = threadIdx.x; v < 0; v += blockDim.x) {\n      const T fr")],
    "no gradient": [("    const T t = path_time<T, D, true>(P, m, ts, quad, lanes, pf, gA, gB, red);",
                     "    const T t = path_time<T, D, false>(P, m, ts, quad, lanes, pf, gA, gB, red);")],
    "no sum of warps": [("  for (int o = 1; o < p2; o <<= 1) t = add_rn(t, __shfl_xor_sync(kFull, t, o));", "")],
    "no step barriers": [("    }\n    __syncthreads();\n  }\n", "    }\n  }\n"),
                         ("  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = tpart;\n  __syncthreads();",
                          "  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = tpart;")],
    "no shuffles in a group": [("  for (int o = 1; o < width; o <<= 1) v = add_rn(v, __shfl_xor_sync(kFull, v, o));",
                                "")],
    "one point a lane": [("  for (int k = lane; k < quad; k += lanes) {", "  for (int k = lane; k < lane + 1; k += lanes) {")],
    "IEEE divisions and square roots": [
        ("  const T y = recip(b);\n  const T q = mul_rn(a, y);\n  return fma(fma(-q, b, a), y, q);",
         "  return a / b;"),
        ("  const float y = rsqrtf(fmaxf(x, kFloatMin));", "  return sqrtf(x);\n  const float y = 0;"),
        ("  double y = static_cast<double>(rsqrtf(fmaxf(static_cast<float>(x), kFloatMin)));",
         "  return sqrt(x);\n  double y = 0;")],
    "no eval": [("  for (int j0 = 0; j0 < m - 1; j0 += groups) {",
                 "  for (int j0 = 0; j0 < 0; j0 += groups) {")],
    "no eval or update": [
        ("  for (int j0 = 0; j0 < m - 1; j0 += groups) {",
         "  for (int j0 = 0; j0 < 0; j0 += groups) {"),
        ("    for (int v = threadIdx.x; v < m; v += blockDim.x) {\n      const T fr",
         "    for (int v = threadIdx.x; v < 0; v += blockDim.x) {\n      const T fr")],
    "points unrolled by 8": [("#pragma unroll (sizeof(T) == 4 ? 4 : 2)\n  for (int k = lane; k < quad; k += lanes) {",
                              "#pragma unroll 8\n  for (int k = lane; k < quad; k += lanes) {")],
    "points unrolled by 4": [("#pragma unroll (sizeof(T) == 4 ? 4 : 2)\n  for (int k = lane; k < quad; k += lanes) {",
                              "#pragma unroll 4\n  for (int k = lane; k < quad; k += lanes) {")],
    "points not unrolled": [("#pragma unroll (sizeof(T) == 4 ? 4 : 2)\n  for (int k = lane; k < quad; k += lanes) {",
                             "#pragma unroll 1\n  for (int k = lane; k < quad; k += lanes) {")],
    "table in shared": [
        ("  T* win = red + kMaxWarps;\n",
         "  T* win = red + kMaxWarps;\n  T* stab = win + 2 * kBiasWindow;\n"
         "  for (int i = threadIdx.x; i < pf.n; i += blockDim.x) stab[i] = pf.tab[i];\n"
         "  pf.tab = stab;\n"),
        ("  const size_t smem = smem_bytes(m, D, quad, sizeof(T));",
         "  const size_t smem = smem_bytes(m, D, quad, sizeof(T)) + sizeof(T) * n_tab;")],
}


def _bend_old_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.bend_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_double] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return lib


def _bend_new_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.bend_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                   + [ctypes.c_double] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return lib


def _bend_call(lib, P, tab, iters, quad, plan=None, lr=3.0):
    """One whole bend of the (B, m, d) stack P in one launch (init, the
    steps, the final selection) by build `lib`: the earlier interface
    when `plan` is None, else the package's with plan (threads, lanes);
    returns (points, times)."""
    from raytracer_tpu_torch.ops import bend as OB

    Bn, m, d = P.shape
    P = P.clone()
    mu, nu, bestP = torch.zeros_like(P), torch.zeros_like(P), P.clone()
    bestT = torch.empty(Bn, dtype=P.dtype, device=P.device)
    ts = OB.quad_points(quad, P.dtype, P.device)
    head = (P.data_ptr(), mu.data_ptr(), nu.data_ptr(), bestP.data_ptr(),
            bestT.data_ptr(), ts.data_ptr())
    prof = (tab.tab.data_ptr(), tab.tab.shape[0], float(tab.r0),
            float(tab.inv_dr), lr, float(rt.R))
    st = torch.cuda.current_stream().cuda_stream
    dbl = int(P.dtype == torch.float64)
    if plan is None:
        rc = lib.bend_launch(*head, *prof, 0, iters, quad, Bn, m, d, 3, dbl,
                             st)
    else:
        bias = OB.bias_table(0, iters, P.dtype, P.device)
        rc = lib.bend_launch(*head, bias.data_ptr(), *prof, iters, quad, Bn,
                             m, d, plan[0], plan[1], 3, dbl, st)
    assert rc == 0, rc
    return bestP, bestT


def _bend_inputs():
    """The --refine fan of chip_smoke.py phase 3i (the 150 sweep paths of
    180x63 at m 128) and its table-shaped sub-batch (chip_smoke.py
    _table_batch: 1,024 candidates at m 384), with the AK135 slowness
    table."""
    from raytracer_tpu_torch.solvers import refine as RF

    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    U = chip_smoke._ak135_vp(gr)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    D = rt.AnnulusSolver(gr, A, halo, U).solve(src)
    _, recs = chip_smoke._fan(gr)
    fan = [rt.recontruct_path(D.prev, src, r) for r in recs]
    fan = [np.stack([gr.x[p], gr.z[p]], axis=1) for p in fan]
    s128 = np.stack([RF.resample_path(p, 128) for p in fan])
    prof = rt.velocity_profile("ak135")
    return (s128, chip_smoke._table_batch(fan),
            RF._uniform_slowness(prof.r, prof.Vp))


def bend_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier bend (one block of 128 threads a path, a segment a
    thread) and the package's (bend_plan's block, a segment's quadrature
    points over lanes, the bias corrections from the host), in turns:
    the --refine fan (150 x 128 x 2, quad 8, 800 steps) in float32 and
    float64 and a table-shaped sub-batch (1,024 x 384 x 2, quad 16, 1,600
    steps, float64), a whole bend a launch; both held against
    bend_reference first (chip_smoke.py phase 3i's gate on the fan in
    float64, the package's one launch equal to four chunks bit for bit).  Also
    the package's kernel at other plans (threads, lanes) on the same
    inputs.  With `breakdown`: the package's built with one piece of a
    step left out (the vertex update, the gradient, the sum of the warps'
    times; timing only) and with the slowness table staged in shared
    memory, on the fan (in float32 also at 512 x 4 and 256 x 2) and the
    sub-batch."""
    from raytracer_tpu_torch.ops import bend as OB

    old = _bend_old_bind(_old_lib(old_dir, "bend", tmp))
    new = _bend_new_bind(OB._bend_lib())
    s128, tiles, (r0, inv_dr, tab) = _bend_inputs()
    tabs = {dt: OB.uniform_table(r0, inv_dr, tab, getattr(torch, dt), "cuda")
            for dt in ("float32", "float64")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the gates: chip_smoke.py phase 3i's on the fan in float64 (800
    # steps within twice the JAX package's spread of the twin, every time
    # at or below its input's), chunks bit-equal
    P = torch.as_tensor(s128, device="cuda")
    want = OB.bend_reference(P, tabs["float64"], 3.0, rt.R, 800, 8)[1]
    t_in = OB.ttime(P, tabs["float64"], 8)
    plan = OB.bend_plan(*P.shape, 8, 8, sms)
    for name, got in (("old", _bend_call(old, P, tabs["float64"], 800, 8)),
                      ("new", _bend_call(new, P, tabs["float64"], 800, 8,
                                         plan[:2]))):
        et = float((got[1] - want).abs().max())
        assert et <= 2.0 * chip_smoke.JAX_REFINE_SPREAD64, (name, et)
        assert bool((got[1] <= t_in + 1e-6).all()), name
    one = OB.bend(P, tabs["float64"], 3.0, rt.R, 120, 8)
    cut = OB.bend(P, tabs["float64"], 3.0, rt.R, 120, 8, chunk=35)
    assert torch.equal(one[0], cut[0]) and torch.equal(one[1], cut[1])
    cases = [("--refine fan", s128, "float32", 8, 800),
             ("--refine fan", s128, "float64", 8, 800),
             ("table sub-batch", tiles, "float64", 16, 1600)]
    others = [(1024, 8), (512, 4), (512, 8), (256, 1), (256, 2), (256, 4),
              (128, 1), (128, 2), (128, 4), (64, 1), (64, 2), (32, 1)]
    for what, stack, dt, quad, iters in cases:
        P = torch.as_tensor(stack, dtype=getattr(torch, dt), device="cuda")
        tb = tabs[dt]
        plan = OB.bend_plan(*P.shape, quad, P.element_size(), sms)
        n_reps = max(1, reps // (20 if what == "table sub-batch" else 4))
        o, n = _turns(lambda: _bend_call(old, P, tb, iters, quad),
                      lambda: _bend_call(new, P, tb, iters, quad, plan[:2]),
                      n_reps)
        alt = {f"{t}x{ln}": _ms(lambda: _bend_call(new, P, tb, iters, quad,
                                                   (t, ln)), n_reps)
               for t, ln in others if (t, ln) != tuple(plan[:2])}
        bytes_, ops = OB.bend_work(*P.shape, quad, iters, P.element_size())
        rows.append(dict(kernel="bend", case=what, shape=list(P.shape),
                         dtype=dt, quad=quad, iters=iters, old_ms=o,
                         new_ms=n, plan=plan._asdict(), other_plans_ms=alt,
                         bound_ms=chip_smoke._bound_ms(
                             bytes_, ops, chip_smoke.H100_F64_OPS_PER_S
                             if dt == "float64" else
                             chip_smoke.H100_F32_OPS_PER_S)[0]))
        print(json.dumps(rows[-1]), flush=True)
    if not breakdown:
        return
    with open(kernels.source_path("bend")) as f:
        text = f.read()
    libs = {"new": new, **_variants(text, _BEND_NEW_SKIP, tmp, "bend_new",
                                    _bend_new_bind)}
    for what, stack, dt, quad, iters in cases:
        P = torch.as_tensor(stack, dtype=getattr(torch, dt), device="cuda")
        plans = [tuple(OB.bend_plan(*P.shape, quad, P.element_size(),
                                    sms)[:2])]
        if what == "--refine fan" and dt == "float32":
            plans += [pl for pl in ((512, 4), (256, 2)) if pl != plans[0]]
        n_reps = max(1, reps // (20 if what == "table sub-batch" else 4))
        for plan in plans:
            for turn in range(2):
                split = {name: _ms(lambda: _bend_call(
                    lib, P, tabs[dt], iters, quad, plan), n_reps)
                    for name, lib in libs.items()}
                rows.append(dict(kernel="bend", case=what, dtype=dt,
                                 plan=plan, split_ms=split, turn=turn))
                print(json.dumps(rows[-1]), flush=True)


# ---- paths: jump tables and whole rows against the earlier walk ----

_PATHS_NEW_SKIP = {
    "no column sums": [("  if (!((sg.bits[i >> 5] >> (i & 31)) & 1u)) return T(0);", "  return T(0);")],
    "no dense writes": [("  write_columns(drow, c0, c1, sg);", "")],
    "no jump levels": [("  for (int j = 0; j + 1 < lv; j += kLevelsALaunch) {",
                        "  for (int j = 0; j + 1 < 1; j += kLevelsALaunch) {")],
    "no pair terms": [("    const T g = pair_g(tm, n, a, b);", "    const T g = T(a);")],
    "no lam and mu": [("  const int lam = s_lam == INT_MAX ? 0 : s_lam;", "  const int lam = 0;")],
    "zeros only": [("  if (!((sg.bits[i >> 5] >> (i & 31)) & 1u)) return T(0);", "  return T(0);")],
    "plain stores": [("  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));",
                      "  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);"),
                     ("  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));",
                      "  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);")],
    "16 chunks an SM": [("    const int want = (4 * sms + n_rec - 1) / n_rec;",
                         "    const int want = (16 * sms + n_rec - 1) / n_rec;")],
}


def _paths_old_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.paths_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _paths_new_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.paths_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _paths_call(lib, prev, src, recs, max_len, terms, form, new):
    """One call as its wrapper makes it: the outputs allocated (the
    earlier one's dense matrix zeroed by torch.zeros, the package's
    jump-table scratch), one paths_launch of build `lib`; form is
    "nodes", "coo" or "dense"."""
    from raytracer_tpu_torch.ops import paths as OP

    dev = prev.device
    n, n_rec = prev.shape[0], recs.shape[0]
    coords, U, partners = terms
    nodes = torch.empty((n_rec, max_len), dtype=torch.int32, device=dev)
    w = 2 * (max_len - 1)
    ids = torch.empty((n_rec, w), dtype=torch.int32, device=dev)
    vals = torch.empty((n_rec, w), dtype=U.dtype, device=dev)
    mat = None
    if form == "dense":
        mat = (torch.empty if new else torch.zeros)((n_rec, n), dtype=U.dtype,
                                                    device=dev)
    with_terms = form != "nodes"
    ptr = lambda t: None if t is None else t.data_ptr()
    args = [prev.data_ptr(), int(src), recs.data_ptr(), n_rec, max_len,
            nodes.data_ptr(), ptr(coords) if with_terms else None,
            coords.shape[0], n, U.data_ptr(), partners.data_ptr(),
            partners.shape[1], ids.data_ptr(), vals.data_ptr(), ptr(mat)]
    if new:
        jumps = torch.empty((OP.jump_levels(max_len), n), dtype=torch.int32,
                            device=dev)
        args.append(jumps.data_ptr())
    args += [int(U.dtype == torch.float64),
             torch.cuda.current_stream().cuda_stream]
    rc = lib.paths_launch(*args)
    assert rc == 0, rc
    return nodes, ids, vals, mat


def paths_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier paths (a thread a receiver walking its row and adding
    its dense row in place, the matrix zeroed by torch.zeros first) and
    the package's (jump tables, a block a row writing it whole), each as
    its wrapper calls it, in turns: chip_smoke.py phase 3i's call (the
    180x63 sweep prev, the 150-receiver fan, max_len 972) in the three
    forms (nodes, COO rows, dense rows) in float64 and the dense form in
    float32, and the package's wrapper `paths` itself; nodes and ids
    bit-equal to paths_reference, the vals and dense rows of both
    versions bit-equal to each other and within 1e-12 (float64) / 1e-6
    (float32) of the twin's, two launches of the package's equal.  With
    `breakdown`: the package's built with one piece left out (the column
    sums, the whole dense writes, the jump levels beyond the first, the
    pair terms, the rows' lam and mu; timing only), dense float64."""
    from raytracer_tpu_torch.ops import paths as OP
    from raytracer_tpu_torch.solvers import sensitivity as S

    old = _paths_old_bind(_old_lib(old_dir, "paths", tmp))
    new = _paths_new_bind(OP._paths_lib())
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    U = chip_smoke._ak135_vp(gr)
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    D = rt.AnnulusSolver(gr, A, halo, U).solve(src)
    _, recs = chip_smoke._fan(gr)
    max_len = 4 * (180 + 63)
    prev = torch.as_tensor(np.asarray(D.prev, np.int32), device="cuda")
    rt_ = torch.as_tensor(np.asarray(recs, np.int32), device="cuda")
    for dtype, forms in ((np.float64, ("nodes", "coo", "dense")),
                         (np.float32, ("dense",))):
        terms = S._device_terms(gr, np.asarray(U, dtype), halo, "cuda")
        want = OP.paths_reference(prev, src, rt_, max_len, terms, dense=True)
        for form in forms:
            got = {}
            for name, lib, is_new in (("old", old, False), ("new", new, True)):
                got[name] = _paths_call(lib, prev, src, rt_, max_len, terms,
                                        form, is_new)
                assert torch.equal(got[name][0], want.nodes), (name, form)
                if form != "nodes":
                    assert torch.equal(got[name][1], want.ids), (name, form)
                    verr = float((got[name][2] - want.vals).abs().max())
                    assert verr <= (1e-12 if dtype == np.float64 else 1e-6) \
                        * float(want.vals.abs().max()), (name, form, verr)
            if form != "nodes":
                assert torch.equal(got["old"][2], got["new"][2]), form
            if form == "dense":
                assert torch.equal(got["old"][3], got["new"][3]), dtype
                again = _paths_call(new, prev, src, rt_, max_len, terms,
                                    form, True)[3]
                assert torch.equal(again, got["new"][3]), dtype
                err = float((got["new"][3] - want.dense).abs().max()) / float(
                    want.vals.abs().max())
                assert err <= (1e-12 if dtype == np.float64 else 1e-6), err
            o, n = _turns(lambda: _paths_call(old, prev, src, rt_, max_len,
                                              terms, form, False),
                          lambda: _paths_call(new, prev, src, rt_, max_len,
                                              terms, form, True), reps)
            wrapper = _ms(lambda: OP.paths(
                prev, src, rt_, max_len, None if form == "nodes" else terms,
                dense=form == "dense"), reps)
            rows.append(dict(kernel="paths", grid="180x63", form=form,
                             dtype=np.dtype(dtype).name, receivers=len(recs),
                             max_len=max_len, old_ms=o, new_ms=n,
                             new_wrapper_ms=wrapper,
                             levels=OP.jump_levels(max_len), bit_equal=True))
            print(json.dumps(rows[-1]), flush=True)
    if not breakdown:
        return
    terms = S._device_terms(gr, np.asarray(U, np.float64), halo, "cuda")
    with open(kernels.source_path("paths")) as f:
        text = f.read()
    libs = {"new": new, **_variants(text, _PATHS_NEW_SKIP, tmp, "paths_new",
                                    _paths_new_bind)}
    for turn in range(2):
        split = {name: _ms(lambda: _paths_call(lib, prev, src, rt_, max_len,
                                               terms, "dense", True), reps)
                 for name, lib in libs.items()}
        dm = torch.empty((len(recs), gr.nnods), dtype=torch.float64,
                         device="cuda")
        split["zero_ of the matrix"] = _ms(lambda: dm.zero_(), reps)
        split["torch.empty + torch.zeros of the matrix"] = _ms(
            lambda: torch.zeros((len(recs), gr.nnods), dtype=torch.float64,
                                device="cuda"), reps)
        split.update({f"old {form}": _ms(lambda: _paths_call(
            old, prev, src, rt_, max_len, terms, form, False), reps)
            for form in ("nodes", "coo", "dense")})
        split.update({f"new {form}": _ms(lambda: _paths_call(
            new, prev, src, rt_, max_len, terms, form, True), reps)
            for form in ("nodes", "coo")})
        split["device by kernel, new dense"] = chip_smoke._kernel_split_ms(
            lambda: _paths_call(new, prev, src, rt_, max_len, terms, "dense",
                                True), 5)
        rows.append(dict(kernel="paths", split_ms=split, turn=turn))
        print(json.dumps(rows[-1]), flush=True)


def _sweep_old_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.banded_sweep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return lib


def _sweep_old_solve(lib, bg, d0, check=8):
    """The earlier solve_banded on the card: one launch of the earlier
    banded_sweep an iteration (launch interface banded_sweep_launch(dist0,
    dist1, toff, tcol, tw, didx, hoff, hsrc, it_in, changed_in, it_out,
    changed_out, S, n_pad, max_iters, is_double, stream)), a host read of
    the flag every `check` launches; returns (field, iterations)."""
    it = torch.zeros((), dtype=torch.int32, device="cuda")
    ch = torch.ones((), dtype=torch.int32, device="cuda")
    d = d0
    stream = torch.cuda.current_stream().cuda_stream
    while True:
        for _ in range(check):
            out = torch.empty_like(d)
            it_out = torch.empty((), dtype=torch.int32, device="cuda")
            ch_out = torch.zeros((), dtype=torch.int32, device="cuda")
            rc = lib.banded_sweep_launch(
                d.data_ptr(), out.data_ptr(), bg.toff.data_ptr(),
                bg.tcol.data_ptr(), bg.tw.data_ptr(), bg.didx.data_ptr(),
                bg.hoff.data_ptr(), bg.hsrc.data_ptr(), it.data_ptr(),
                ch.data_ptr(), it_out.data_ptr(), ch_out.data_ptr(),
                d.shape[0], bg.n_pad, 2 ** 31 - 1,
                int(d.dtype == torch.float64), stream)
            assert rc == 0, rc
            d, it, ch = out, it_out, ch_out
        changed, iters = torch.stack([ch, it]).tolist()
        if not changed:
            return d, iters


# csrc/banded.cu's Jacobi kernel run for a fixed number of iterations
# (the changed flag not obeyed), and so with one piece of an iteration
# left out (timing only): the grid sync, the window's loads, the taps
_FIXED = ("    if (!(go && changed)) break;  // the same in every thread\n",
          "    if (!go) break;\n")
_JACOBI_NEW_SKIP = {
    "fixed count": [_FIXED],
    "no grid sync": [_FIXED, ("    grid.sync();\n    ++it;", "    ++it;")],
    "no window loads": [_FIXED, ("    if (kShared && go)  //",
                                 "    if (kShared && go && s < 0)  //")],
    "window loads one at a time": [_FIXED, (
        "constexpr int kBatch = 8;", "constexpr int kBatch = 1;")],
    "no taps": [_FIXED, ("        for (; k + 2 <= D; k += 2) {",
                         "        for (; k + 2 <= 0; k += 2) {"),
                ("        if (k < D) v0 = min_of", "        if (k < 0) v0 = min_of")],
}


# another shape of the same Jacobi kernel: two blocks of 256 threads an SM
# (twice the blocks at the grid sync, the same threads an SM)
_JACOBI_NEW_SHAPES = {
    "two blocks of 256 an SM": [
        ("constexpr int kJacobiThreads = 512;", "constexpr int kJacobiThreads = 256;"),
        ("__launch_bounds__(kJacobiThreads, 1) banded_jacobi_kernel",
         "__launch_bounds__(kJacobiThreads, 2) banded_jacobi_kernel")],
}


def _jacobi_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.banded_jacobi_launch.restype = ctypes.c_int
    lib.banded_jacobi_launch.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    return lib


def banded_sweep_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier banded_sweep (an iteration a launch, the host read
    every 8 launches) and the package's (the whole solve in one
    cooperative launch), in turns, each as solve_banded runs it, on the
    production Delaunay annulus (RCM): float32 S=1, float64 S=1 and
    float32 S=8 (chip_smoke.py phase 16's sources); both held bit-equal
    to the plain version's fixpoint and its iterations first.  Each
    version's device time a solve by kernel (torch.profiler).  With
    `breakdown`: the package's in launches of 1 and 8 iterations (the
    host read after each), on its global route (forced), and by device
    time for a fixed 214 iterations with one piece left out (the grid
    sync, the window's loads, the taps; timing only), with the window's
    loads one at a time, and as two blocks of 256 threads an SM (held
    bit-equal)."""
    from raytracer_tpu_torch.ops import banded as pb

    old = _sweep_old_bind(_old_lib(old_dir, "banded", tmp))
    dg = rt.add_midpoints(rt.triangle_annulus_2d(**chip_smoke.DELAUNAY))
    dA = rt.node_adjacency(dg, star=0)
    U = chip_smoke._ak135_vp(dg)
    src = rt.closest_point(dg, 0.0, rt.R, system="polar")
    srcs8 = [rt.closest_point(dg, np.deg2rad(d), rt.R, system="polar")
             for d in np.linspace(0.0, 175.0, 8)]
    bgs = {}
    for dtype, srcs in (("float32", [src]), ("float64", [src]),
                        ("float32", srcs8)):
        cfg = rt.SolverConfig(dtype=dtype)
        if dtype not in bgs:
            bgs[dtype] = rt.prepare_banded(dA, chip_smoke._no_halo(), dg, U,
                                           cfg)
        bg = bgs[dtype]
        states = chip_smoke._banded_twin_states(bg, srcs, cfg)
        want = states[-1]
        st0 = states[0]
        cap = cfg.max_iters

        def new_solve(count=cap, g=bg):
            s = st0
            while True:
                s = pb.banded_step(s, g, cap, count)
                changed, iters = torch.stack([s.changed, s.it]).tolist()
                if not changed:
                    return s.dist, iters

        od, oi = _sweep_old_solve(old, bg, st0.dist)
        nd, ni = new_solve()
        assert torch.equal(od, want.dist) and oi == int(want.it), dtype
        assert torch.equal(nd, want.dist) and ni == int(want.it), dtype
        o, n = _turns(lambda: _sweep_old_solve(old, bg, st0.dist),
                      new_solve, reps)
        split_old = chip_smoke._kernel_split_ms(
            lambda: _sweep_old_solve(old, bg, st0.dist), 3)
        split_new = chip_smoke._kernel_split_ms(new_solve, 3)
        rows.append(dict(kernel="banded_sweep", mesh="Delaunay nr=60",
                         dtype=dtype, S=len(srcs), iterations=ni,
                         old_solve_ms=o, new_solve_ms=n,
                         old_device_ms=split_old, new_device_ms=split_new,
                         route=chip_smoke._jacobi_route(bg, len(srcs)),
                         bit_equal=True))
        print(json.dumps(rows[-1]), flush=True)
        if not breakdown or dtype != "float32" or len(srcs) != 1:
            continue
        split = {f"count {c}": _ms(lambda: new_solve(c), max(1, reps // 4))
                 for c in (1, 8)}
        keep = pb.BLOCK_SMEM
        try:
            pb.BLOCK_SMEM = 0
            bgw = bg._replace(jacobi={})
            assert chip_smoke._jacobi_route(bgw, 1) == "global"
            gd, gi = new_solve(g=bgw)
            assert torch.equal(gd, want.dist) and gi == ni
            split["global route"] = _ms(lambda: new_solve(g=bgw), reps)
            split["global route, device by kernel"] = \
                chip_smoke._kernel_split_ms(lambda: new_solve(g=bgw), 3)
        finally:
            pb.BLOCK_SMEM = keep
        with open(kernels.source_path("banded")) as f:
            text = f.read()
        libs = _variants(text, _JACOBI_NEW_SKIP, tmp, "jacobi_new",
                         _jacobi_bind)
        keep = pb._banded_lib
        try:
            for name, lib in libs.items():
                pb._banded_lib = lambda lib=lib: lib
                split[f"{ni} iterations, {name}"] = \
                    chip_smoke._kernel_split_ms(
                        lambda: pb.banded_step(st0, bg, cap, ni), 5).get(
                            "banded_jacobi_kernel")
        finally:
            pb._banded_lib = keep
        shapes = _variants(text, _JACOBI_NEW_SHAPES, tmp, "jacobi_shape",
                           _jacobi_bind)
        keep = pb._banded_lib
        try:
            for name, lib in shapes.items():    # twice the blocks, each half
                pb._banded_lib = lambda lib=lib: lib
                g = bg._replace(jacobi={})
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                g.jacobi[(1, str(bg.tw.dtype))] = pb.jacobi_layout(
                    bg.toff, bg.tcol, bg.tw, bg.n_pad, 1,
                    bg.tw.element_size(), "cuda", 2 * sms)
                sd, si = new_solve(g=g)
                assert torch.equal(sd, want.dist) and si == ni, name
                split[name] = _ms(lambda: new_solve(g=g), reps)
                split[f"{name}, device"] = chip_smoke._kernel_split_ms(
                    lambda: new_solve(g=g), 3).get("banded_jacobi_kernel")
        finally:
            pb._banded_lib = keep
        rows.append(dict(kernel="banded_sweep", split_ms=split))
        print(json.dumps(rows[-1]), flush=True)


# csrc/gridsearch.cu with one piece left out (timing only: each computes
# another function): the product's sums, the tile's column prep (its
# finiteness and demeaning), the running bests (the misfits still
# formed), the next tile's copy (the tile's times left as they were)
_SEARCH_NEW_SKIP = {
    "no product": [("            accumulate(acc, msum, K, b, walk);\n", "")],
    "no column prep": [("        prepare(c0, b);\n", "")],
    "no running bests": [(
        "            keep_first(fin ? m : inf_of<T>(), c, bm[i], bj[i]);\n",
        "            bm[i] = fin ? bm[i] + m : bm[i];\n")],
    "no next-tile copy": [(
        "        if (tile + gridDim.x < tiles) stage_tile(c0 + gridDim.x * kTile, 0, b ^ 1);\n",
        "")],
}


# other shapes of csrc/gridsearch.cu's design, each computing the same
# function: one block an SM (no register cap below 255), two columns a
# lane (64-column tiles), four events a warp in the expanded formula
_SEARCH_NEW_SHAPES = {
    "one block an SM": [("__launch_bounds__(kThreads, 2)\n    search_kernel",
                         "__launch_bounds__(kThreads, 1)\n    search_kernel")],
    "two columns a lane": [("constexpr int kCT = 4;", "constexpr int kCT = 2;")],
    "four events a warp": [("constexpr int kEPT = kExpanded ? 8 : 4;",
                            "constexpr int kEPT = 4;")],
}


def _search_new_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.gridsearch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    lib.gridsearch_blocks.restype = ctypes.c_int
    lib.gridsearch_blocks.argtypes = [ctypes.c_int] * 3
    return lib


def _search_old_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.gridsearch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_void_p])
    lib.gridsearch_blocks.restype = ctypes.c_int
    lib.gridsearch_blocks.argtypes = [ctypes.c_int]
    return lib


def _search_old_call(lib, T, O, w2, mode):
    """One call of the earlier grid search as its wrapper made it (launch
    interface gridsearch_launch(T, K, n, obs, E, w2, W2, A, s1, expanded,
    pm, pj, j, t0, m, is_double, stream), its partials sized by
    gridsearch_blocks(n))."""
    from raytracer_tpu_torch.ops import gridsearch as GS

    K, n = T.shape
    E = O.shape[0]
    A = s1 = None
    if mode == "expanded":
        W2, s1, obs, A = GS._catalogue_obs(O, w2)
        obs, A, s1 = obs.contiguous(), A.contiguous(), s1.contiguous()
    else:
        W2, obs = torch.sum(w2), O
    W2 = W2.reshape(1)
    nb = lib.gridsearch_blocks(n)
    pm = torch.empty(max(E * nb, 1), dtype=T.dtype, device="cuda")
    pj = torch.empty(max(E * nb, 1), dtype=torch.int32, device="cuda")
    j = torch.empty(E, dtype=torch.int64, device="cuda")
    t0 = torch.empty(E, dtype=T.dtype, device="cuda")
    m = torch.empty(E, dtype=T.dtype, device="cuda")
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.gridsearch_launch(
        T.data_ptr(), K, n, obs.data_ptr(), E, w2.data_ptr(), W2.data_ptr(),
        ptr(A), ptr(s1), int(mode == "expanded"), pm.data_ptr(),
        pj.data_ptr(), j.data_ptr(), t0.data_ptr(), m.data_ptr(),
        int(T.dtype == torch.float64), torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return j, t0, m


def gridsearch_ab(old_dir, reps, rows, breakdown, tmp):
    """The earlier grid search (a thread a column, a warp and block
    reduction an event) and the package's (a lane's column tile and
    event chunk, one reduction an (event, block)), in turns, a call with
    its wrapper, at the location path's shape (K 12, n 150,121 station
    fields of the 180x63 grid, 64 events; the fields from the auto solver
    as chip_smoke.py phase 3j takes them): float64 and float32, expanded
    and direct, and the one-event direct call of `locate`; both held to
    the plain version's rows under the tie rule first.  Each version's
    device time a call by kernel (torch.profiler).  With `breakdown`: the
    package's built with one piece left out (the product, the column
    prep, the running bests, the next tile's copy; timing only) and in
    three other shapes of the design (one block an SM, two columns a
    lane, four events a warp; held to the tie rule), float64 E = 64 in
    both formulas, and the package's at E = 8, 16, 32, 128 and
    512 expanded float64."""
    from raytracer_tpu_torch.ops import gridsearch as GS
    from raytracer_tpu_torch.ops import gridsearch_check as GC

    old = _search_old_bind(_old_lib(old_dir, "gridsearch", tmp))
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    solver = rt.AnnulusSolver(gr, A, halo, chip_smoke._ak135_vp(gr))
    stations = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                for d in chip_smoke.LOCATE_STATION_DEGS]
    fields = rt.station_fields(solver, stations)
    rng = np.random.default_rng(0)
    K, n = fields.shape
    ev = rng.integers(0, n, size=64)
    T_obs = fields[:, ev].T + rng.normal(0.0, 0.2, (64, K))
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(dt, mode, 64) for dt in (torch.float64, torch.float32)
             for mode in ("expanded", "direct")] + [
        (torch.float64, "direct", 1)]
    for dt, mode, E in cases:
        T = torch.as_tensor(fields, dtype=dt, device="cuda")
        O = torch.as_tensor(T_obs[:E], dtype=dt, device="cuda")
        w2 = torch.full((K,), 25.0, dtype=dt, device="cuda")
        rows_ = chip_smoke._search_rows(T, O, w2, mode)
        GC.search_agreement(rows_, *_search_old_call(old, T, O, w2, mode))
        GC.search_agreement(rows_, *GS.grid_search(T, O, w2, mode))
        o, nw = _turns(lambda: _search_old_call(old, T, O, w2, mode),
                       lambda: GS.grid_search(T, O, w2, mode), reps)
        split_old = chip_smoke._kernel_split_ms(
            lambda: _search_old_call(old, T, O, w2, mode), 10)
        split_new = chip_smoke._kernel_split_ms(
            lambda: GS.grid_search(T, O, w2, mode), 10)
        rows.append(dict(kernel="gridsearch", dtype=str(dt).split(".")[-1],
                         mode=mode, K=K, n=n, E=E, old_call_ms=o,
                         new_call_ms=nw, old_device_ms=split_old,
                         new_device_ms=split_new, tie_rule=True))
        print(json.dumps(rows[-1]), flush=True)
    if not breakdown:
        return
    T = torch.as_tensor(fields, device="cuda")
    w2 = torch.full((K,), 25.0, dtype=torch.float64, device="cuda")
    O = torch.as_tensor(T_obs, device="cuda")
    with open(kernels.source_path("gridsearch")) as f:
        text = f.read()
    libs = {"new": GS._lib(), **_variants(text, _SEARCH_NEW_SKIP, tmp,
                                          "search_new", _search_new_bind)}
    shapes = _variants(text, _SEARCH_NEW_SHAPES, tmp, "search_shape",
                       _search_new_bind)
    keep = GS._lib
    try:
        for name, lib in shapes.items():       # the same function: checked
            GS._lib = lambda lib=lib: lib
            for mode in ("expanded", "direct"):
                rows_ = chip_smoke._search_rows(T, O, w2, mode)
                GC.search_agreement(rows_, *GS.grid_search(T, O, w2, mode))
        libs.update(shapes)
    finally:
        GS._lib = keep
    keep = GS._lib
    try:
        for turn in range(2):
            split = {}
            for name, lib in libs.items():
                GS._lib = lambda lib=lib: lib
                for mode in ("expanded", "direct"):
                    dev = chip_smoke._kernel_split_ms(
                        lambda: GS.grid_search(T, O, w2, mode), 10)
                    split[f"{name} {mode}"] = dev.get("search_kernel")
            rows.append(dict(kernel="gridsearch", float64_E64_search_ms=split,
                             turn=turn))
            print(json.dumps(rows[-1]), flush=True)
    finally:
        GS._lib = keep
    split = {}
    for E in (8, 16, 32, 128, 512):
        e = rng.integers(0, n, size=E)
        O = torch.as_tensor(fields[:, e].T + rng.normal(0.0, 0.2, (E, K)),
                            device="cuda")
        dev = chip_smoke._kernel_split_ms(
            lambda: GS.grid_search(T, O, w2, "expanded"), 10)
        split[f"E={E}"] = dev
    rows.append(dict(kernel="gridsearch", split_ms=split))
    print(json.dumps(rows[-1]), flush=True)


def _build_probe(tmp):
    src = os.path.join(tmp, "step_probe.cu")
    with open(src, "w") as f:
        f.write(_STEP_PROBE)
    lib = _build(src, tmp, "step_probe")
    lib.step_block_run.restype = ctypes.c_int
    lib.step_block_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.step_cluster_run.restype = ctypes.c_int
    lib.step_cluster_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    return lib


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
                         "plane3d, tsweep, banded_gs, bfm_step, bend, "
                         "paths, banded_sweep, gridsearch")
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
    print("clocks:", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
        flush=True)
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
        if "tsweep" in want:
            tsweep_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if "plane3d" in want:
            plane3d_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if "banded_gs" in want:
            banded_gs_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if "bfm_step" in want:
            bfm_step_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if "bend" in want:
            bend_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if "paths" in want:
            paths_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if "banded_sweep" in want:
            banded_sweep_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if "gridsearch" in want:
            gridsearch_ab(a.old, a.reps, rows, a.breakdown, tmp)
        if a.breakdown and "fused" in want:
            fused_breakdown(tmp, {"old": a.old, "new": kernels.CSRC_DIR},
                            max(1, a.reps // 4), rows)
        if a.old_pkg:
            solves_ab(a.old_pkg, rows)
    print(_smi())
    print("clocks:", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
        flush=True)


if __name__ == "__main__":
    main()
