"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises and
the exit code is non-zero):
  1. environment: torch, CUDA, nvcc release, ninja, the card's name and
     power limit;
  2. build: every CUDA kernel of the port, one nvcc per source, all
     started together;
  3. every kernel against its plain PyTorch version on the card, with
     both timed, at the shapes of the paths below (bit equality: each
     candidate is one f32 add followed by a min, and the scans keep the
     TPU kernels' span schedules): rsweep at 180x63 (S=1 and 4 both
     directions, two lane blocks, and one 1,280-lane block, which takes
     the kernel's device-memory route), with its microseconds per row;
     titer at 180x63
     (S=1 and S=2, dup 4) and at 176x40 (S=2, dup 0), in float32 and
     (180x63 S=1, 176x40 S=2) float64, with its device time by kernel;
     band, which takes
     the field and rolls theta itself, against its plain version on the
     5 rolled pages at 1080x300 (S=1 and S=2), at the warm level's
     coarse grid (540 theta rows) and on 5 theta rows, where the wrap
     folds the rows onto each other; (3b) witer at 183x63 (S=1 and S=2,
     dup 73), at 256x63 (S=2, dup 0) and in float64 at 183x63 (S=1),
     with its device time by kernel, at 128x100 and 1080x300 (S=1),
     where a chain column or a ring row spans several warps, and in
     float64 at 1080x300, 47x63 (the band's 32-lane tile) and 31x63 (its
     taps read from global memory); diag at
     127x63 (dup 1) and at 183x63 in float32 and float64, alone and as
     diag_step (the fan and the changed flag), and the diag engine's
     ring and chain scans at 127x63 (float32, float64) and on its first
     1,031 rows (an odd count); (3c)
     sweep3d (T sweeps of the 26-tap 3-D stencil) in float32 at (7,5,4)
     S=1 and (130,6,3) S=3 (256 lanes), in float64 at (8,8,3) and at
     (600,4,3) S=8 (640 lanes in chunks of 128), and at
     the 3-D path's 128x128x64 at S=1 and S=7 (T=8), with the bytes a
     call reads from device memory in this design (13 weights a node a
     sweep) and in one that reads all 26 each sweep; (3d) relax at
     180x63 (S=1 and S=8, finite pad rows in the input) and in float64
     at 24x12 (S=2), fused (the whole
     solve in one cooperative launch) at 24x12 (S=2, T=3: ntheta 24 takes
     the modular ring shifts; float32 and float64), at 48x12 and 180x63
     with S=8 (the table's width) and at 180x63 with S=1, each with the
     same iterations as its plain version;
  4. the main path through the user entry points: init_annulus_circulant
     (180, 63, 20) -> AnnulusSolver(method="auto") on cuda -> solve with
     prev -> receiver fan -> paths -> travel-time CSV, held against the
     JAX package's anchors and the same solve on the CPU; the device time
     of three steady solves by kernel (torch.profiler) and the device's
     busy and idle share of the steady solve;
  5. the port's main_annulus CLI on the 180x63 grid into a temporary
     directory;
  6. AnnulusSolver(method="twrapped") at 180x63 (the titer kernel),
     held to the anchors and to phase 4's sweep field at every node; a
     float64 twrapped solve at 48x12 equal to the same solve on the CPU;
  7. rsweep at the 1080x300 sweep solve's tables (S=1, both directions)
     against its plain version, timed; then AnnulusSolver(method=
     "stream") at 1080x300 with warm level 1 (the
     band kernel), held to the same solve on the CPU at every node, and
     to the sweep solve of the same grid at the surface receivers
     (2e-3 s) and at every node (ENGINE_ATOL, see there);
  8. travel_time_table of 8 sources x 150 receivers at 180x63 on
     'sweep' and 'twrapped', each row held to its single-source solve;
  9. AnnulusSolver(method="auto") at 183x63, which routes to 'wrapped'
     (the witer kernel), held to the JAX package's iteration count and
     spread from 'stream', to a tol=1e-5 stream solve at every node
     (2e-3 s), to 'stream' at the surface receivers (2e-3 s) and at every
     node (ENGINE_ATOL); explicit 'wrapped' at 180x63 held to the anchors
     and to the sweep field at every node; an 8 x 150 table; a
     device-resident result through the travel-time CSV and the npz;
 10. AnnulusSolver(method="auto") at 127x63, which routes to 'diag' (the
     diag kernel and its scans, an iteration in one launch call), held
     to the JAX package's iteration count and spread from 'stream', and
     to 'stream' and a tol=1e-5 stream solve at every node
     (ENGINE_ATOL); a float64 diag solve at 47x6 equal to the same solve
     on the CPU; explicit 'diag' at 180x63 held to the anchors and to
     the sweep field (ENGINE_ATOL);
 11. the 3-D path at 128x128x64 (1,048,576 nodes) on the chip-campaign
     wedge of benchmarks/chip_dsweep3d.py: grid3d -> prepare3d ->
     solve3d(engine="auto"), which takes the kernel engine (the sweep3d
     kernel): the 3x3 surface table held to the JAX package's (JAX_WEDGE,
     0.01 s); a single-source full-field solve held bit-equal, with the
     same iterations, to the same route on the CPU (the plain twin); the
     64-source x 1024-receiver table (source batch 7), three of its rows
     held to single-source solves (5e-3 s); recover_prev3d equal to the
     CPU recovery, three backtraces descending to the source;
 12. the port's example_grid3d CLI at its defaults on the card, its
     table held to the root example's (JAX_EXAMPLE, 0.01 s);
 13. AnnulusSolver(method="pallas") (the relax kernel) and
     AnnulusSolver(method="fused") (the fused kernel) at 180x63, through
     the entry points of phase 4: the anchors, the JAX package's
     iterations and spread from a tol=1e-5 twrapped solve (JAX_CONTRIB),
     pallas within ENGINE_ATOL of the sweep field and fused within 2e-3 s
     of the tight solve at every node, the prev tree equal to
     recover_prev with as many receiver paths reaching the source
     without a cycle as in the JAX package (ROADMAP C.9), a 48x12 solve
     bit-equal to the same route on the CPU, an 8 x 150 table (S=8) with
     three rows held to single solves.
Every kernel-launch count is set to 0 just before each path (4, 6, 7,
9, 10, 11, 13) and read just after it.  Then one JSON line of kernel numbers, the
card's name and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}.

Needs no network and writes only to a temporary directory and to the
package's `_build/`.  Without CUDA, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# JAX package's values on this grid (surface source, AK135 Vp)
T60_REF, T150_REF, T_ATOL = 610.742, 1050.994, 0.01
CPU_ATOL = 2e-3          # two tol units of f32 termination slack
MAX_ROUNDS = 10
TABLE_SOURCES, TABLE_RECEIVERS = 8, 150
# One engine against another over every node.  Every engine stops once
# no node improves by more than tol = 1e-3 s in one iteration or round,
# and that slack adds up (ROADMAP C.5): on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit, at 1080x300 the default-tol sweep sat up to 8.9 ms
# above a stream solve run to tol = 1e-5 and the warm stream up to
# 7.9 ms (the two differed by up to 8.1 ms, in the inner core); at
# 183x63 the stream itself sits up to 3.9 ms above it, so 'wrapped'
# (within 1.8 ms of it) differs from 'stream' by 2.5 ms.  'diag' also
# sits up to 4.4 ms BELOW the tol = 1e-5 solve: its ring scan's closed
# form (cumulative minima of b - j*c, then + j*c) rounds some sums below
# every real path (ROADMAP C.7).  The JAX package run on the CPU gives
# the same spreads (JAX_SPREAD).  Phases 7, 9 and 10 print each figure.
ENGINE_ATOL = 1e-2
TIGHT_TOL = 1e-5
# the JAX package's engines on the CPU (tools/jax_engine_spread.py):
# iterations of the engine, and its max |field - stream field| (s)
JAX_SPREAD = {"wrapped 183x63": (108, 2.50244140625e-3),
              "diag 127x63": (92, 4.2724609375e-3)}
# the JAX package's quarantined engines on the CPU at 180x63
# (tools/jax_contrib_reference.py): iterations (-1: fused keeps its count
# on the device) and the most the field sits above and below a twrapped
# solve at tol=1e-5 (124 iterations).  pallas sits below it: its ring
# scan's closed form rounds below the fixpoint (ROADMAP C.7).
# The last figure: how many of the 150 receivers' predecessor walks
# reach the source without a cycle (ROADMAP C.9).
JAX_CONTRIB = {"pallas": (95, 0.002685546875, 0.004364013671875, 6),
               "fused": (-1, 0.0008544921875, 0.0, 147),
               "twrapped tight": 124}
SPREAD_ATOL = 1e-6
# The JAX package's 3x3 travel-time tables (s) on the CPU, float32, 3
# surface sources x 3 surface receivers (tools/jax_grid3d_reference.py):
# the root example_grid3d.py at its defaults (24x24x16, xla engine), and
# the 128x128x64 chip-campaign wedge (xla engine, scan_every 0).
JAX_EXAMPLE = [[118.82701110839844, 231.0539093017578, 447.36053466796875],
               [218.8846435546875, 231.0298309326172, 225.4295654296875],
               [426.60101318359375, 424.41326904296875, 156.23204040527344]]
JAX_WEDGE = [[96.63719177246094, 207.28045654296875, 444.18426513671875],
             [198.22744750976562, 207.27886962890625, 242.14430236816406],
             [427.5814514160156, 423.6245422363281, 137.81248474121094]]
WEDGE_DIMS = (128, 128, 64)
TABLE3D_SOURCES, TABLE3D_RECEIVERS, TABLE3D_BATCH = 64, 1024, 7
# a source group's row against its single-source solve: the tolerance of
# the JAX package's test_solve3d_source_batched_matches_single
BATCH_ATOL = 5e-3
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores, same sheet


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _smi() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])


def _cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of fn() over n calls, timed with CUDA events
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def _launch_counters():
    """name -> the wrapper whose `launches` counts that kernel."""
    from raytracer_tpu_torch.contrib import fused_circulant, pallas_circulant
    from raytracer_tpu_torch.ops import (diag_circulant, diag_wrapped,
                                         stream_t, sweep3d, sweep_theta,
                                         wrapped_t)

    return {"rsweep": sweep_theta.rsweep, "titer": wrapped_t.titer,
            "band": stream_t.band, "witer": diag_wrapped.witer,
            "diag": diag_circulant.diag_sweep,
            "ring_scan": diag_circulant.ring_scan,
            "chain_scan": diag_circulant.chain_scan,
            "sweep3d": sweep3d.sweep3d_T, "relax": pallas_circulant.relax,
            "fused": fused_circulant.fused}


def _reset_counts():
    for fn in _launch_counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def _max_err(got, want) -> float:
    """Max abs difference over finite entries; inf when the +inf
    patterns differ."""
    import torch

    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        return float("inf")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _reaching(prev, source, receivers) -> list:
    """The receivers whose predecessor walk reaches `source` without
    meeting a node twice.  A walk that meets a cycle never reaches it
    (recontruct_path would walk n nodes and then append the source)."""
    out = []
    for r in receivers:
        node, seen = r, set()
        while node != source and node not in seen:
            seen.add(node)
            node = int(prev[node])
        if node == source:
            out.append(r)
    return out


def _steady_ms(solver, source, n):
    """Median host milliseconds of n single-source solves, each one
    between two synchronizes."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(source, want_prev=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _bound_ms(nbytes: float, ops: float):
    t_b, t_o = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _kernel_split_ms(fn, n: int) -> dict:
    """Device milliseconds per call of fn, by CUDA kernel (and copy),
    from torch.profiler's CUDA trace over n calls after one warm-up.
    Host-side operator entries (aten::...) also carry the device time of
    the kernels they launched; those kernels are counted under their own
    names, so the host entries are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a window now and then comes back without device events (seen on
    # the card for a phase's first profile): take the next one
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_time_total > 0 for e in events):
            break
    out = {}
    for e in events:
        t = e.device_time_total
        if t > 0 and e.device_type != DeviceType.CPU:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0].split("<")[0]
            name = name.strip()
            out[name] = out.get(name, 0.0) + t / 1e3 / n
    return out


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    from raytracer_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    release = [ln for ln in _run([nvcc, "--version"]).splitlines()
               if "release" in ln]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    print("phase 1 environment: "
          f"python={sys.version.split()[0]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} triton={triton_version} nvcc={nvcc} "
          f"({release[0].strip() if release else 'release unknown'}) "
          f"ninja={'present' if shutil.which('ninja') else 'absent'} "
          f"device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} smi=[{_smi()}]", flush=True)


def phase_build():
    from raytracer_tpu_torch import kernels

    names = sorted(f[:-3] for f in os.listdir(kernels.CSRC_DIR)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        secs = dict(zip(names, pool.map(kernels.build, names)))
    for name in names:
        kernels.load(name)
    print(f"phase 2 build: {len(names)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{n}={s:.2f}s" for n, s in secs.items()), flush=True)


def _rsweep_buffer(rng, rst, nt, S, upward):
    """Random T-layout field at the main path's layout: finite travel
    times with some +inf (unreached) cells in the field rows, +inf pad
    rows and pad lanes."""
    import numpy as np
    import torch

    buf = np.full((S, rst.MT + rst.K8, rst.NTL), np.inf, np.float32)
    vals = rng.uniform(0.0, 1500.0, (S, rst.MT, nt)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = np.inf
    off = rst.K8 if upward else 0
    buf[:, off: off + rst.MT, :nt] = vals
    return torch.from_numpy(buf).cuda()


def _rsweep_work(wtab, rst, nt, S, upward):
    """(bytes, operations, finite weights) of one sweep: the buffer read
    and written once, the weight and tap tables read once; one add and
    one min per real theta lane for every finite (row, tap) weight."""
    import numpy as np

    taps = rst.taps_up if upward else rst.taps_dn
    w = wtab.cpu().numpy()
    cols = [iw for _, _, iw in taps]
    finite = int(np.isfinite(w[:, cols]).sum())
    nbytes = (2 * S * (rst.MT + rst.K8) * rst.NTL * 4 + w.size * 4
              + len(taps) * 3 * 4)
    return nbytes, 2 * finite * nt * S, finite


def _rsweep_check(rng, cases, nt, wdn, wup) -> float:
    """Each (statics, S, upward) case through the kernel and the plain
    version on the same random field; raises unless bit-equal.  Returns
    the largest abs difference (0.0)."""
    import torch

    from raytracer_tpu_torch.ops.sweep_theta import rsweep, rsweep_reference

    max_err = 0.0
    for st, S, up in cases:
        buf = _rsweep_buffer(rng, st, nt, S, up)
        wtab = wup if up else wdn
        out_k = rsweep(buf.clone(), wtab, st, up)
        out_r = rsweep_reference(buf.clone(), wtab, st, up)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        max_err = max(max_err, err)
        if not torch.equal(out_k, out_r):
            raise AssertionError(
                f"rsweep kernel != plain version (S={S}, upward={up}, "
                f"NTB={st.NTB}/{st.NTL}): max abs err {err}")
    return max_err


def phase_kernels(rec: dict):
    import numpy as np

    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops.sweep_theta import (_kernel_tables,
                                                     device_tables, rsweep,
                                                     rsweep_reference)
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    _, cg, _ = init_annulus_circulant(180, 63, spacing=20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    _, static, wdn, wup, rst = device_tables(ws, cg, np.float32, "cuda")
    nt = static.nt
    blocked = rst._replace(NTB=rst.NTL // 2)
    # the same taps on one 1,280-lane block: the ring would not fit in
    # shared memory, so the kernel takes its device-memory route
    wide = rst._replace(NTL=1280, NTB=1280)
    rng = np.random.default_rng(0)
    cases = [(rst, 1, False), (rst, 1, True), (rst, 4, False),
             (rst, 4, True), (blocked, 2, False), (blocked, 2, True),
             (wide, 1, False), (wide, 1, True)]
    max_err = _rsweep_check(rng, cases, nt, wdn, wup)
    routes = sorted({"shared" if _kernel_tables(wup if up else wdn, st,
                                                up)[0].shared else "global"
                     for st, _, up in cases})
    times = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": [],
             "finite": []}
    for up in (False, True):
        wtab = wup if up else wdn
        buf = _rsweep_buffer(rng, rst, nt, 1, up)
        times["ms"].append(_cuda_ms(lambda: rsweep(buf, wtab, rst, up), 20))
        times["plain_ms"].append(
            _cuda_ms(lambda: rsweep_reference(buf, wtab, rst, up), 2))
        nbytes, ops, finite = _rsweep_work(wtab, rst, nt, 1, up)
        times["finite"].append(finite)
        t_b, t_o = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
        times["bound_ms"].append(1e3 * max(t_b, t_o))
        times["bound_by"].append("bytes" if t_b >= t_o else "operations")
    buf4 = _rsweep_buffer(rng, rst, nt, 4, False)
    ms4 = _cuda_ms(lambda: rsweep(buf4, wdn, rst, False), 10)
    rec["rsweep"] = {
        "max_abs_err": max_err,
        "ms": statistics.mean(times["ms"]),
        "plain_ms": statistics.mean(times["plain_ms"]),
        "bound_ms": statistics.mean(times["bound_ms"]),
        "bound_by": times["bound_by"][0],
    }
    print(f"phase 3 kernels: rsweep bit-equal to rsweep_reference in "
          f"{len(cases)} cases (S=1,4 both directions; lane-blocked "
          f"NTB={blocked.NTB}<NTL={rst.NTL}; one {wide.NTB}-lane block, "
          f"both directions; routes {routes}); at S=1 (MT={rst.MT}, "
          f"K8={rst.K8}, NTL={rst.NTL}, {len(rst.taps_dn)}+"
          f"{len(rst.taps_up)} taps, {times['finite'][0]}/"
          f"{times['finite'][1]} finite (row, tap) weights) kernel down/up "
          f"{times['ms'][0]:.4f}/{times['ms'][1]:.4f} ms = "
          f"{1e3 * times['ms'][0] / rst.MT:.3f}/"
          f"{1e3 * times['ms'][1] / rst.MT:.3f} us per row, plain "
          f"{times['plain_ms'][0]:.1f}/{times['plain_ms'][1]:.1f} ms, "
          f"bound {times['bound_ms'][0]:.5f}/{times['bound_ms'][1]:.5f} ms "
          f"({times['bound_by'][0]}); kernel at S=4 down {ms4:.4f} ms",
          flush=True)


def phase_main_path(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.main_annulus import receiver_degrees

    t_build = time.perf_counter()
    gr, cg, U = rt.init_annulus_circulant(180, 63, spacing=20.0)
    t_build = time.perf_counter() - t_build
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")

    solver = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    degs = receiver_degrees()
    receivers = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                 for d in degs]
    paths = [rt.recontruct_path(D.prev, source, r) for r in receivers]
    csv_path = os.path.join(tmp, "main_path_travel_times.csv")
    tt = rt.travel_times(D, gr, receivers, isave=True, flname=csv_path)
    launches = counts["rsweep"]
    rounds = solver.last_iterations

    assert solver.method == "sweep", solver.method
    assert str(solver.device).startswith("cuda"), solver.device
    assert rounds is not None and 1 <= rounds <= MAX_ROUNDS, rounds
    assert launches == 2 * rounds, (launches, rounds)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert abs(t60 - T60_REF) <= T_ATOL, t60
    assert abs(t150 - T150_REF) <= T_ATOL, t150
    for r, p in zip(receivers, paths):
        assert p[0] == r and p[-1] == source and len(p) > 1, (r, p[:3])
    reach = _reaching(D.prev, source, receivers)
    with open(csv_path) as f:
        assert len(f.read().strip().splitlines()) == len(degs) + 1

    cpu = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg,
                           device="cpu")
    d_cpu = cpu.solve(source, want_prev=False).dist
    err_cpu = float(np.abs(D.dist - d_cpu).max())
    assert err_cpu <= CPU_ATOL, err_cpu

    steady_ms = _steady_ms(solver, source, 5)
    # device time of a steady solve by kernel, and the device's busy share
    split = _kernel_split_ms(lambda: solver.solve(source, want_prev=False),
                             3)
    busy = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = solver.recover_prev(D.dist)
    torch.cuda.synchronize()
    t_prev = time.perf_counter() - t0
    prev[source] = source
    assert np.array_equal(prev, D.prev)

    rec["rsweep"]["launches"] = launches
    rec["sweep_ms"] = steady_ms
    rec["sweep_180"] = (gr, cg, U, source, D, receivers, degs)
    print(f"phase 4 main path: {gr.nnods} nodes (grid {t_build:.2f} s), "
          f"method={solver.method} on {solver.device}, {rounds} rounds, "
          f"rsweep launches={launches}, t(60)={t60:.4f} s, "
          f"t(150)={t150:.4f} s, max |cuda - cpu| = {err_cpu:.3g} s, "
          f"{len(paths)} paths end at the source, {len(reach)} of them "
          f"without a cycle (ROADMAP C.9); first solve+prev "
          f"{t_first:.3f} s, steady solve median of 5 "
          f"{steady_ms:.2f} ms, prev recovery "
          f"{1e3 * t_prev:.2f} ms; launches on this path {counts}; device "
          f"ms per steady solve (torch.profiler, 3 solves) {busy:.3f} = "
          f"{100 * busy / steady_ms:.1f} % of the steady solve (idle "
          f"{100 * (1 - busy / steady_ms):.1f} %), by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in top[:8])
          + f" and {len(top) - 8} more" * (len(top) > 8),
          flush=True)


def phase_cli(tmp: str):
    from raytracer_tpu_torch import main_annulus

    prefix = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    main_annulus.main(["--ntheta", "180", "--nr", "63", "--out-prefix",
                       prefix])
    with open(f"{prefix}_travel_times.csv") as f:
        n_rows = len(f.read().strip().splitlines())
    assert n_rows == 151, n_rows
    assert os.path.getsize(f"{prefix}.npz") > 0
    print(f"phase 5 cli: main_annulus wrote {n_rows - 1} travel times and "
          f"the npz in {time.perf_counter() - t0:.2f} s", flush=True)


def _titer_work(ws, st, S, iters):
    """(bytes, operations) of one titer launch: the field and the centre
    values read and written once, the tables read once (the band's
    weights as the stencil's finite ones, each with an int32 index, in
    the tables' dtype); one add and one min per candidate - ring and
    chain steps over the whole page, band taps only where the weight is
    finite (an +inf weight is no work a kernel must do), one band a row,
    the duplicate merge one min per merged lane, the fan's reduce and
    broadcast."""
    import numpy as np

    from raytracer_tpu_torch.ops.wrapped_t import _scan_plan

    ring_statics, n_ring, chain_statics, chain_rep, n_chain = _scan_plan(st)
    rows, ML, NTT = S * st.NTT, st.ML, st.NTT
    n_dm5 = (2 * st.maxdm + 1) * 5
    ring = 2 * 2 * ML * S * sum(NTT - s for s in ring_statics
                                + (16,) * n_ring)
    chain = 2 * rows * ML * (len(chain_statics) + n_chain) * 2
    finite = int(np.isfinite(ws.wrows[:n_dm5]).sum())
    dup = NTT - st.nt
    band = 2 * S * NTT * finite
    merge = 2 * dup * ML * S
    fan = 2 * 2 * rows * ML
    ops = iters * (ring + chain + band + merge + fan)
    item = ws.wrows.dtype.itemsize
    tables = item * sum(a.size for a in (ws.ring_f, ws.ring_b, ws.cfl,
                                         ws.cbl, ws.fan_w))
    nbytes = item * (2 * rows * ML + 2 * S) + tables + (item + 4) * finite
    return nbytes, ops


def _band_work(wrows, maxdm, S, nt, ML):
    """(bytes, operations) of one band sweep in the field form the kernel
    takes: the field read once, the output written once, the weight rows
    read once; one add and one min per finite weight entry per (source,
    theta row)."""
    import numpy as np

    w = wrows.cpu().numpy()[: (2 * maxdm + 1) * 5]
    nbytes = 4 * (2 * S * nt * ML + wrows.numel())
    return nbytes, 2 * S * nt * int(np.isfinite(w).sum())


def _random_field(rng, shape, Mp, dtype=None):
    """Finite travel times with ~half +inf cells and +inf pad lanes
    [Mp, ML), the invariant the kernels' tables keep (float32 unless
    `dtype` says otherwise)."""
    import numpy as np
    import torch

    v = rng.uniform(0.0, 1500.0, shape).astype(dtype or np.float32)
    v[rng.random(shape) < 0.5] = np.inf
    v[..., Mp:] = np.inf
    return torch.from_numpy(v).cuda()


def phase_jacobi_kernels(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops import stream_t, wrapped_t

    rng = np.random.default_rng(5)
    titer_rows = []
    # the path's shape (180x63, S=1) first; S=2 and a dup-0 grid (176x40);
    # float64 at both shapes
    for ntheta, nr, S, dtype in ((180, 63, 1, np.float32),
                                 (180, 63, 2, np.float32),
                                 (176, 40, 2, np.float32),
                                 (180, 63, 1, np.float64),
                                 (176, 40, 2, np.float64)):
        _, cg, _ = init_annulus_circulant(ntheta, nr, spacing=20.0)
        ws = wrapped_t.pack_twrapped_stencil(cg, dtype=dtype, band_closure=1)
        st = wrapped_t.TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)
        tbl = wrapped_t.device_twrapped_tables(ws, "cuda")
        dist = _random_field(rng, (S * ws.NTT, ws.ML), ws.Mp, dtype)
        cen = torch.tensor(rng.uniform(0.0, 1500.0, S).astype(dtype),
                           device="cuda")
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        d_k, c_k = wrapped_t.titer(st, dist, cen, tbl, 4)
        d_r, c_r = wrapped_t.titer_reference(st, dist, cen, tbl, 4)
        torch.cuda.synchronize()
        err = max(_max_err(d_k, d_r), _max_err(c_k, c_r))
        if not (torch.equal(d_k, d_r) and torch.equal(c_k, c_r)):
            raise AssertionError(
                f"titer kernel != plain version at {name} S={S} "
                f"(dup {ws.NTT - ws.nt}): max abs err {err}")
        ms = _cuda_ms(lambda: wrapped_t.titer(st, dist, cen, tbl, 4), 20)
        plain = _cuda_ms(lambda: wrapped_t.titer_reference(st, dist, cen,
                                                           tbl, 4), 2)
        if not titer_rows:  # the phase split at the path's shape (S=1)
            rec["titer_split"] = _kernel_split_ms(
                lambda: wrapped_t.titer(st, dist, cen, tbl, 4), 5)
        nbytes, ops = _titer_work(ws, st, S, 4)
        bound, by = _bound_ms(nbytes, ops)
        titer_rows.append(dict(
            grid=name, S=S, dup=ws.NTT - ws.nt, max_abs_err=err,
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, ops=ops))
    band_rows = []
    _, cg, _ = init_annulus_circulant(1080, 300, spacing=20.0)
    ws = wrapped_t.pack_twrapped_stencil(cg, dtype=np.float32,
                                         band_closure=1)
    coarse = stream_t._warm_stencils(ws, cg, np.float32, 1, 1)[0]
    # the stream path's levels (the fine grid at S=1 and 2, the warm
    # level's coarse grid) and 5 theta rows, where the wrap folds the
    # rows dc = -2..2 onto each other
    for name, w_, S, nt in (("1080x300", ws, 1, ws.nt),
                            ("1080x300", ws, 2, ws.nt),
                            ("1080x300 coarse", coarse, 1, coarse.nt),
                            ("1080x300, 5 rows", ws, 2, 5)):
        wrows = torch.tensor(w_.wrows, device="cuda")
        v = _random_field(rng, (S, nt, w_.ML), w_.Mp)
        out_k = stream_t.band(v, wrows, w_.maxdm)
        out_r = stream_t.band_reference(stream_t._band_stack(v), wrows,
                                        w_.maxdm)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"band kernel != plain version at {name} "
                                 f"S={S}: max abs err {err}")
        ms = _cuda_ms(lambda: stream_t.band(v, wrows, w_.maxdm), 50)
        plain = _cuda_ms(lambda: stream_t.band_reference(
            stream_t._band_stack(v), wrows, w_.maxdm), 3)
        nbytes, ops = _band_work(wrows, w_.maxdm, S, nt, w_.ML)
        bound, by = _bound_ms(nbytes, ops)
        band_rows.append(dict(
            grid=name, S=S, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, nbytes=nbytes, ops=ops))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    for name, rows in (("titer", titer_rows), ("band", band_rows)):
        # times at the main paths' shape (S=1), errors over every case
        rec[name] = {k: rows[0][k] for k in keys}
        rec[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    print("phase 3a kernels: titer (T=4) bit-equal to titer_reference: "
          + "; ".join(f"{r['grid']} S={r['S']} dup={r['dup']}: kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['ops'] / 1e9:.3f} G ops)" for r in titer_rows)
          + ". titer at 180x63 S=1 by kernel (torch.profiler, device ms per "
          "launch; ring_kernel also merges the duplicate rows and applies "
          "the fan, band_kernel folds the centre): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rec["titer_split"].items())
          + ". band (field form) bit-equal to band_reference on the "
          "rolled stack: "
          + "; ".join(f"{r['grid']} S={r['S']}: kernel {r['ms']:.4f} ms, "
                      f"plain {r['plain_ms']:.2f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e6:.1f} M "
                      f"ops)" for r in band_rows),
          flush=True)


def phase_twrapped(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U, source, D_sweep, receivers, degs = rec["sweep_180"]
    solver = rt.AnnulusSolver(gr, None, None, U, method="twrapped",
                              circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    assert solver.method == "twrapped", solver.method
    assert counts["titer"] > 0 and counts["titer"] * 4 == iters, \
        (counts, iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    tt = rt.travel_times(D, gr, receivers)
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert abs(t60 - T60_REF) <= T_ATOL, t60
    assert abs(t150 - T150_REF) <= T_ATOL, t150
    err = float(np.abs(D.dist - D_sweep.dist).max())
    assert err <= CPU_ATOL, err
    rec["titer"]["launches"] = counts["titer"]
    rec["twrapped_solver"] = solver
    rec["twrapped_ms"] = _steady_ms(solver, source, 3)
    f64 = _f64_against_cpu(rt, "twrapped", 48, 12, 150.0)
    print(f"phase 6 twrapped: {gr.nnods} nodes, method={solver.method}, "
          f"{iters} iterations, titer launches={counts['titer']} "
          f"(path counts {counts}), t(60)={t60:.4f} s, t(150)={t150:.4f} s,"
          f" max |twrapped - sweep| = {err:.3g} s over every node; first "
          f"solve {t_first:.3f} s, steady solve median of 3 "
          f"{rec['twrapped_ms']:.2f} ms; {f64}", flush=True)


def _f64_against_cpu(rt, method, ntheta, nr, spacing):
    """A float64 solve of `method` on the card equal to the same solve on
    the CPU (the plain versions), node for node, with the same
    iterations; returns a line that says so."""
    import numpy as np

    gr, cg, U = rt.init_annulus_circulant(ntheta, nr, spacing,
                                          dtype=np.float64)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    out = []
    for device in ("cuda", "cpu"):
        solver = rt.AnnulusSolver(gr, None, None, U,
                                  rt.SolverConfig(dtype="float64"),
                                  method=method, circulant=cg, device=device)
        d = solver.solve(source, want_prev=False).dist
        assert solver.method == method and d.dtype == np.float64
        out.append((d, solver.last_iterations))
    (d_k, it_k), (d_c, it_c) = out
    assert it_k == it_c and np.array_equal(d_k, d_c), (method, it_k, it_c)
    return (f"float64 {method} at {ntheta}x{nr} on the card equals the CPU "
            f"route ({it_k} iterations, largest time "
            f"{np.max(d_k[np.isfinite(d_k)]):.6f} s)")


def phase_stream(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.main_annulus import receiver_degrees
    from raytracer_tpu_torch.ops.stream_t import auto_warm_levels
    from raytracer_tpu_torch.ops.sweep_theta import (_kernel_tables,
                                                     device_tables, rsweep)

    gr, cg, U = rt.init_annulus_circulant(1080, 300, spacing=20.0)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    sweep = rt.AnnulusSolver(gr, None, None, U, method="sweep", circulant=cg)
    d_sweep = sweep.solve(source, want_prev=False).dist
    rounds = sweep.last_iterations
    # the radial kernel at this grid's tables, against its plain version
    _, st7, wdn, wup, rst7 = device_tables(sweep._packed(sweep=True), cg,
                                           np.float32, "cuda")
    rng = np.random.default_rng(3)
    err7 = _rsweep_check(rng, [(rst7, 1, False), (rst7, 1, True)], st7.nt,
                         wdn, wup)
    rs7 = []
    for up in (False, True):
        wtab = wup if up else wdn
        buf = _rsweep_buffer(rng, rst7, st7.nt, 1, up)
        nbytes, ops, _ = _rsweep_work(wtab, rst7, st7.nt, 1, up)
        rs7.append((_cuda_ms(lambda: rsweep(buf, wtab, rst7, up), 10),
                    _kernel_tables(wtab, rst7, up)[0].shared,
                    *_bound_ms(nbytes, ops)))
    rec["rsweep"]["max_abs_err"] = max(rec["rsweep"]["max_abs_err"], err7)
    solver = rt.AnnulusSolver(gr, None, None, U, method="stream",
                              circulant=cg)
    assert auto_warm_levels(cg.ntheta) == 1 and solver.config.warm_levels \
        is None
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    assert solver.method == "stream", solver.method
    assert counts["band"] == iters > 0, (counts, iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    err_all = float(np.abs(D.dist - d_sweep).max())
    assert err_all <= ENGINE_ATOL, err_all
    recs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in receiver_degrees()]
    err_rec = float(np.abs(D.dist[recs] - d_sweep[recs]).max())
    assert err_rec <= CPU_ATOL, err_rec
    cpu = rt.AnnulusSolver(gr, None, None, U, method="stream", circulant=cg,
                           device="cpu")
    t0 = time.perf_counter()
    d_cpu = cpu.solve(source, want_prev=False).dist
    t_cpu = time.perf_counter() - t0
    err_cpu = float(np.abs(D.dist - d_cpu).max())
    assert err_cpu <= CPU_ATOL, err_cpu
    assert cpu.last_iterations == iters, (cpu.last_iterations, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    iters_by = {}
    fields = {}
    for name, cfg in (("cold", rt.SolverConfig(warm_levels=0)),
                      ("tight", rt.SolverConfig(warm_levels=0, tol=TIGHT_TOL,
                                                max_iters=5000))):
        s_ = rt.AnnulusSolver(gr, None, None, U, cfg, method="stream",
                              circulant=cg)
        fields[name] = s_.solve(source, want_prev=False).dist
        iters_by[name] = s_.last_iterations
    ref = fields["tight"]
    above = {name: float((d - ref).max()) for name, d in
             (("sweep", d_sweep), ("warm stream", D.dist),
              ("cold stream", fields["cold"]))}
    for name, a in above.items():
        assert -CPU_ATOL <= a <= ENGINE_ATOL, (name, a)
    rec["band"]["launches"] = counts["band"]
    rec["stream_ms"] = 1e3 * steady
    print(f"phase 7 rsweep at 1080x300 (MT={rst7.MT}, K8={rst7.K8}, "
          f"NTL={rst7.NTL}, {len(rst7.taps_dn)}+{len(rst7.taps_up)} taps): "
          f"bit-equal to rsweep_reference at S=1 both directions; kernel "
          f"down/up " + "/".join(f"{r[0]:.4f}" for r in rs7) + " ms = "
          + "/".join(f"{1e3 * r[0] / rst7.MT:.3f}" for r in rs7)
          + " us per row, bound " + "/".join(f"{r[2]:.5f}" for r in rs7)
          + f" ms ({rs7[0][3]}), "
          + ("shared-memory" if rs7[0][1] else "device-memory") + " route",
          flush=True)
    print(f"phase 7 stream: 1080x300, {gr.nnods} nodes, warm level 1, "
          f"{iters} iterations over both levels, band launches="
          f"{counts['band']} (path counts {counts}); max |cuda - cpu| = "
          f"{err_cpu:.3g} s over every node (the CPU solve through the "
          f"plain versions took {t_cpu:.1f} s, same iterations); max "
          f"|stream - sweep| = {err_rec:.3g} s over the {len(recs)} "
          f"surface receivers and {err_all:.3g} s over every node (sweep "
          f"{rounds} rounds); first solve {t_first:.3f} s, steady solve "
          f"{1e3 * steady:.1f} ms; cold stream {iters_by['cold']} "
          f"iterations; against a cold stream solve at tol={TIGHT_TOL:g} "
          f"({iters_by['tight']} iterations) the most any node sits above "
          f"is " + ", ".join(f"{n} {a:.3g} s" for n, a in above.items()),
          flush=True)


def phase_tables(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U, _, _, receivers, _ = rec["sweep_180"]
    recs = np.asarray(receivers[:TABLE_RECEIVERS])
    assert len(recs) == TABLE_RECEIVERS
    srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(0.0, 315.0, TABLE_SOURCES)]
    parts = []
    for method in ("sweep", "twrapped"):
        solver = rt.AnnulusSolver(gr, None, None, U, method=method,
                                  circulant=cg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = solver.travel_time_table(srcs, recs, batch=8)
        torch.cuda.synchronize()
        t_table = time.perf_counter() - t0
        single = np.stack([solver.solve(s, want_prev=False).dist[recs]
                           for s in srcs])
        assert table.shape == (TABLE_SOURCES, TABLE_RECEIVERS)
        assert np.isfinite(table).all()
        err = float(np.abs(table - single).max())
        assert err <= CPU_ATOL, (method, err)
        parts.append(f"{method}: {1e3 * t_table:.1f} ms, max |table - "
                     f"single solves| = {err:.3g} s"
                     f"{' (bit-equal)' if err == 0.0 else ''}")
    print(f"phase 8 tables: {TABLE_SOURCES} sources x {TABLE_RECEIVERS} "
          f"receivers at 180x63, batch=8; " + "; ".join(parts), flush=True)


def _witer_work(ws, S, iters):
    """(bytes, operations) of one witer launch: the field and the centre
    values read and written once, the tables read once (the band's taps
    as the kernel's per-row lists); one add and one min per candidate -
    ring and chain steps over the whole field, band taps only where a
    diagonal's weight is finite (one band per lane; the duplicate merge
    is one min per merged lane), the fan's reduce and broadcast."""
    import numpy as np

    from raytracer_tpu_torch.ops.diag_wrapped import (_chain_plan,
                                                      _ring_plan,
                                                      wrapped_tap_lists)

    ring_statics, n_ring = _ring_plan(ws.NTL)
    chain_statics, _, n_chain = _chain_plan(ws.Mp)
    Mp, NTL, NTLT = ws.Mp, ws.NTL, S * ws.NTL
    dup = NTL - ws.nt
    ring = 2 * 2 * Mp * S * sum(NTL - s for s in ring_statics
                                + (16,) * n_ring)
    chain = 2 * 2 * Mp * NTLT * (len(chain_statics) + n_chain)
    finite = int(np.isfinite(ws.wpT[:ws.D, :Mp]).sum())
    band = 2 * NTLT * finite
    merge = 2 * dup * Mp * S
    fan = 2 * 2 * Mp * NTLT
    ops = iters * (ring + chain + band + merge + fan)
    item = ws.wpT.dtype.itemsize
    taps = sum(a.nbytes for a in wrapped_tap_lists(ws))
    tables = item * (ws.ring_f.size + ws.ring_b.size + ws.cfl.size
                     + ws.cbl.size + ws.fan_w.size)
    return item * (2 * Mp * NTLT + 2 * S) + tables + taps, ops


def _diag_work(ds):
    """(bytes, operations) of one diag sweep: the field read and written
    once, the stencil's finite (row, diagonal) weights that a row reads
    (source row in [0, Mp)) with their indices (the per-row tap lists)
    read once, in the stencil's dtype; one add and one min per theta
    lane for every such weight."""
    from raytracer_tpu_torch.ops.diag_circulant import diag_tap_lists

    tl = diag_tap_lists(ds)
    item = ds.wp.dtype.itemsize
    nbytes = item * 2 * ds.Mp * ds.NTL + sum(a.nbytes for a in tl)
    return nbytes, 2 * ds.ntheta * len(tl.w)


def _ring_scan_work(Mp, NTL, nt, itemsize):
    """(bytes, operations) of one ring scan: the field read and written
    once, the two hop costs a row; per theta lane and direction a
    product, a difference, two cumulative minima, three sums and two
    minima."""
    return itemsize * (2 * Mp * NTL + 2 * Mp), 2 * 9 * Mp * nt


def _chain_scan_work(Mp, NTL, itemsize):
    """(bytes, operations) of one chain scan: the field read and written
    once, the two chain costs a row; per lane an add and a min for each
    pair up the recursion's levels and each even value down them, both
    directions, and the final two minima."""
    pairs, n = 0, Mp
    while n >= 2:
        pairs += n // 2 + (n - 1) // 2
        n >>= 1
    return itemsize * (2 * Mp * NTL + 2 * Mp), 2 * (2 * pairs + Mp) * NTL


def phase_wrapped_diag_kernels(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops import diag_circulant, diag_wrapped

    rng = np.random.default_rng(6)
    witer_rows = []
    # the path's shape (183x63, S=1) first; 128x100 (1,328 slots) and
    # 1080x300 (1,152 lanes) spread a chain column and a ring row over
    # several warps of a block; in float64 the band's coarse-theta tiles:
    # 47x63 with 32 lanes, 31x63 with its taps read from global memory
    for ntheta, nr, S, dtype in ((183, 63, 1, np.float32),
                                 (183, 63, 2, np.float32),
                                 (256, 63, 2, np.float32),
                                 (183, 63, 1, np.float64),
                                 (128, 100, 1, np.float32),
                                 (1080, 300, 1, np.float32),
                                 (1080, 300, 1, np.float64),
                                 (47, 63, 1, np.float64),
                                 (31, 63, 1, np.float64)):
        _, cg, _ = init_annulus_circulant(ntheta, nr, spacing=20.0)
        ws = diag_wrapped.pack_wrapped_stencil(cg, dtype=dtype)
        st = diag_wrapped.WStatic(ws.rho_starts, ws.Mp, ws.NTL, ws.pad2,
                                  ws.nt)
        tbl = diag_wrapped.device_wrapped_tables(ws, "cuda")
        # every lane of the wrapped cover is real data: no +inf pad lanes
        dist = _random_field(rng, (ws.Mp, S * ws.NTL), S * ws.NTL, dtype)
        cen = torch.tensor(rng.uniform(0.0, 1500.0, S).astype(dtype),
                           device="cuda")
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        d_k, c_k = diag_wrapped.witer(st, dist, cen, tbl, 4)
        d_r, c_r = diag_wrapped.witer_reference(st, dist, cen, tbl, 4)
        torch.cuda.synchronize()
        err = max(_max_err(d_k, d_r), _max_err(c_k, c_r))
        if not (torch.equal(d_k, d_r) and torch.equal(c_k, c_r)):
            raise AssertionError(
                f"witer kernel != plain version at {name} S={S} "
                f"(dup {ws.NTL - ws.nt}): max abs err {err}")
        ms = _cuda_ms(lambda: diag_wrapped.witer(st, dist, cen, tbl, 4), 20)
        plain = _cuda_ms(lambda: diag_wrapped.witer_reference(
            st, dist, cen, tbl, 4), 1)
        if not witer_rows:  # the phase split at the path's shape (S=1)
            rec["witer_split"] = _kernel_split_ms(
                lambda: diag_wrapped.witer(st, dist, cen, tbl, 4), 5)
        nbytes, ops = _witer_work(ws, S, 4)
        bound, by = _bound_ms(nbytes, ops)
        lanes, staged = diag_wrapped.witer_launch_plan(
            st, np.dtype(dtype).itemsize,
            diag_wrapped.band_block_taps(tbl.tap_ptr.cpu().numpy()))
        witer_rows.append(dict(
            grid=name, S=S, dup=ws.NTL - ws.nt, max_abs_err=err,
            tile=f"{lanes} lanes, taps in {'shared' if staged else 'global'}",
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, ops=ops))
    diag_rows = []
    for ntheta, dtype in ((127, np.float32), (183, np.float32),
                          (127, np.float64), (183, np.float64)):
        _, cg, _ = init_annulus_circulant(ntheta, 63, spacing=20.0)
        ds = diag_circulant.pack_diag_stencil(cg, dtype=dtype)
        st = diag_circulant.DiagStatic(ds.D, ds.Mp, ds.NTL, ds.pad,
                                       ds.ntheta)
        tbl = diag_circulant.device_diag_tables(ds, "cuda")
        dist = _random_field(rng, (ds.Mp, ds.NTL), ds.NTL, dtype)
        name = f"{ntheta}x63" + ("" if dtype == np.float32 else " f64")
        out_k = diag_circulant.diag_sweep(st, dist, tbl)
        out_r = diag_circulant.diag_sweep_reference(st, dist, tbl)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"diag kernel != plain version at {name}: "
                                 f"max abs err {err}")
        ms = _cuda_ms(lambda: diag_circulant.diag_sweep(st, dist, tbl), 50)
        plain = _cuda_ms(lambda: diag_circulant.diag_sweep_reference(
            st, dist, tbl), 3)
        # the sweep with the fan and the changed test: a changed and an
        # unchanged iteration
        sc = diag_circulant.device_diag_scan_tables(ds, "cuda")
        tol = torch.tensor(1e-3, dtype=dist.dtype, device="cuda")
        dcen = torch.tensor(300.0, dtype=dist.dtype, device="cuda")
        step = []
        for old in (dist, None):
            if old is None:  # the last step's own output: unchanged
                old, dcen = step[-1][0], step[-1][1]
            got = diag_circulant.diag_step(st, dist, tbl, sc, old, dcen, tol)
            want = diag_circulant.diag_step_reference(st, dist, tbl, sc, old,
                                                      dcen, tol)
            torch.cuda.synchronize()
            err = max(err, _max_err(got[0], want[0]),
                      _max_err(got[1], want[1]))
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])
                    and bool(got[2]) == bool(want[2])):
                raise AssertionError(f"diag_step != plain version at {name} "
                                     f"(changed {bool(want[2])})")
            step.append(want)
        assert bool(step[0][2]) and not bool(step[1][2]), "changed flags"
        nbytes, ops = _diag_work(ds)
        bound, by = _bound_ms(nbytes, ops)
        lanes, staged = diag_circulant.diag_launch_plan(
            st, np.dtype(dtype).itemsize,
            diag_circulant.band_block_taps(tbl.tap_ptr.cpu().numpy()))
        diag_rows.append(dict(
            grid=name, dup=ds.NTL - ds.ntheta, D=ds.D, max_abs_err=err,
            tile=f"{lanes} lanes, taps in {'shared' if staged else 'global'}",
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, nbytes=nbytes,
            ops=ops))
    # the scans at 127x63, and on its first 1,031 rows (an odd number of
    # slots: every level of the chain's recursion has an odd length then)
    scan_rows = []
    _, cg, _ = init_annulus_circulant(127, 63, spacing=20.0)
    for dtype, rows in ((np.float32, None), (np.float64, None),
                        (np.float32, 1031)):
        ds = diag_circulant.pack_diag_stencil(cg, dtype=dtype)
        if rows is not None:
            cut = dict(ring_f=ds.ring_f[:rows], ring_b=ds.ring_b[:rows],
                       chain_f=ds.chain_f[:rows], chain_b=ds.chain_b[:rows],
                       fan_w=ds.fan_w[:rows], Mp=rows)
            ds = dataclasses.replace(ds, **cut)
        sc = diag_circulant.device_diag_scan_tables(ds, "cuda")
        x = _random_field(rng, (ds.Mp, ds.NTL), ds.NTL, dtype)
        name = (f"127x63" + ("" if rows is None else f" first {rows} rows")
                + ("" if dtype == np.float32 else " f64"))
        for kname, kern, plain_fn, work in (
                ("ring_scan",
                 lambda: diag_circulant.ring_scan(x, sc, ds.ntheta),
                 lambda: diag_circulant._ring_scan(x, sc.ring_f, sc.ring_b,
                                                   ds.ntheta),
                 _ring_scan_work(ds.Mp, ds.NTL, ds.ntheta,
                                 np.dtype(dtype).itemsize)),
                ("chain_scan", lambda: diag_circulant.chain_scan(x, sc),
                 lambda: diag_circulant._chain_scan(x, sc.chain_f,
                                                    sc.chain_b),
                 _chain_scan_work(ds.Mp, ds.NTL, np.dtype(dtype).itemsize))):
            got, want = kern(), plain_fn()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"{kname} kernel != plain version at "
                                     f"{name}: max abs err {err}")
            bound, by = _bound_ms(*work)
            scan_rows.append(dict(
                kernel=kname, grid=name, max_abs_err=err,
                ms=_cuda_ms(kern, 50), plain_ms=_cuda_ms(plain_fn, 5),
                bound_ms=bound, bound_by=by))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    for name, rows in (("witer", witer_rows), ("diag", diag_rows),
                       ("ring_scan", [r for r in scan_rows
                                      if r["kernel"] == "ring_scan"]),
                       ("chain_scan", [r for r in scan_rows
                                       if r["kernel"] == "chain_scan"])):
        # times at the main paths' shapes (S=1; 127x63 for diag and the
        # scans), errors over every case
        rec[name] = {k: rows[0][k] for k in keys}
        rec[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    rec["witer_rows"], rec["diag_rows"] = witer_rows, diag_rows
    print("phase 3b kernels: witer (T=4) bit-equal to witer_reference: "
          + "; ".join(f"{r['grid']} S={r['S']} dup={r['dup']} "
                      f"(band {r['tile']}): kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['ops'] / 1e9:.3f} G ops)" for r in witer_rows)
          + ". diag bit-equal to diag_sweep_reference, and with the fan and "
          "changed test (diag_step, a changed and an unchanged iteration) "
          "to diag_step_reference: "
          + "; ".join(f"{r['grid']} dup={r['dup']} D={r['D']} "
                      f"({r['tile']}): kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e6:.1f} M "
                      f"ops)" for r in diag_rows)
          + ". the diag scans bit-equal to _ring_scan and _chain_scan: "
          + "; ".join(f"{r['kernel']} {r['grid']}: kernel {r['ms']:.4f} ms, "
                      f"plain {r['plain_ms']:.3f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
                      for r in scan_rows)
          + ". witer at 183x63 S=1 by phase (torch.profiler, device ms per "
          "launch; ring_kernel also merges the duplicate lanes and applies "
          "the fan, band_kernel folds the centre): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rec["witer_split"].items()),
          flush=True)


def _engine_checks(rt, gr, cg, U, source, d, name):
    """The stream and tol=1e-5 stream fields on this grid, and d's
    spread from them: (stream iterations, every-node and receiver
    |d - stream|, most above and below the tight field, receivers)."""
    import numpy as np

    from raytracer_tpu_torch.main_annulus import receiver_degrees

    stream = rt.AnnulusSolver(gr, None, None, U, method="stream",
                              circulant=cg)
    d_stream = stream.solve(source, want_prev=False).dist
    tight = rt.AnnulusSolver(gr, None, None, U,
                             rt.SolverConfig(warm_levels=0, tol=TIGHT_TOL,
                                             max_iters=5000),
                             method="stream", circulant=cg)
    d_tight = tight.solve(source, want_prev=False).dist
    recs = [rt.closest_point(gr, np.deg2rad(x), rt.R, system="polar")
            for x in receiver_degrees()]
    out = dict(
        stream_iters=stream.last_iterations,
        tight_iters=tight.last_iterations,
        all=float(np.abs(d - d_stream).max()),
        recs=float(np.abs(d[recs] - d_stream[recs]).max()),
        above=float((d - d_tight).max()), below=float((d - d_tight).min()),
        stream_above=float((d_stream - d_tight).max()))
    print(f"  {name}: max |{name} - stream| = {out['all']:.6g} s over every "
          f"node, {out['recs']:.3g} s over the {len(recs)} surface "
          f"receivers (stream {out['stream_iters']} iterations); against a "
          f"cold stream solve at tol={TIGHT_TOL:g} ({out['tight_iters']} "
          f"iterations) {name} sits at most {out['above']:.3g} s above and "
          f"{max(0.0, -out['below']):.3g} s below it, the default stream "
          f"{out['stream_above']:.3g} s above", flush=True)
    return out


def _anchors(rt, solver, receivers, degs, source):
    """(t(60), t(150), field) of a single solve at 180x63."""
    import numpy as np

    D = solver.solve(source, want_prev=False)
    tt = rt.travel_times(D, solver.gr, receivers)
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert abs(t60 - T60_REF) <= T_ATOL, (solver.method, t60)
    assert abs(t150 - T150_REF) <= T_ATOL, (solver.method, t150)
    return t60, t150, D.dist


def phase_wrapped(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U = rt.init_annulus_circulant(183, 63, spacing=20.0)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    solver = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    ref_iters, ref_spread = JAX_SPREAD["wrapped 183x63"]
    assert solver.method == "wrapped", solver.method
    assert counts["witer"] > 0 and counts["witer"] * 4 == iters, \
        (counts, iters)
    assert iters == ref_iters, (iters, ref_iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    chk = _engine_checks(rt, gr, cg, U, source, D.dist, "wrapped")
    assert abs(chk["all"] - ref_spread) <= SPREAD_ATOL, chk["all"]
    assert chk["all"] <= ENGINE_ATOL and chk["recs"] <= CPU_ATOL, chk
    assert -CPU_ATOL <= chk["below"] and chk["above"] <= CPU_ATOL, chk
    steady = _steady_ms(solver, source, 3)

    # a device-resident result through the outputs (ROADMAP C.1)
    Dd = solver.solve(source, device_dist=True)
    assert isinstance(Dd.dist, torch.Tensor) and Dd.dist.is_cuda
    _, _, _, _, D_sweep, receivers180, degs = rec["sweep_180"]
    recs = [rt.closest_point(gr, np.deg2rad(x), rt.R, system="polar")
            for x in degs]
    tt = rt.travel_times(Dd, gr, recs, isave=True,
                         flname=os.path.join(tmp, "wrapped_183.csv"))
    assert np.array_equal(tt, D.dist[recs])
    npz = os.path.join(tmp, "wrapped_183.npz")
    rt.save_solution_npz(npz, Dd, gr, source)
    with np.load(npz) as f:
        assert np.array_equal(f["dist"], D.dist)

    # 8 x 150 table against single solves
    srcs = [rt.closest_point(gr, np.deg2rad(x), rt.R, system="polar")
            for x in np.linspace(0.0, 315.0, TABLE_SOURCES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = solver.travel_time_table(srcs, np.asarray(recs), batch=8)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    single = np.stack([solver.solve(x, want_prev=False).dist[recs]
                       for x in srcs])
    assert table.shape == (TABLE_SOURCES, TABLE_RECEIVERS)
    err_table = float(np.abs(table - single).max())
    assert err_table <= CPU_ATOL, err_table

    # explicit 'wrapped' at 180x63: the anchors and the sweep field
    gr180, cg180, U180, source180 = (rec["sweep_180"][0], rec["sweep_180"][1],
                                     rec["sweep_180"][2], rec["sweep_180"][3])
    w180 = rt.AnnulusSolver(gr180, None, None, U180, method="wrapped",
                            circulant=cg180)
    t60, t150, d180 = _anchors(rt, w180, receivers180, degs, source180)
    err_sweep = float(np.abs(d180 - D_sweep.dist).max())
    assert err_sweep <= CPU_ATOL, err_sweep

    rec["witer"]["launches"] = counts["witer"]
    rec["wrapped_ms"] = steady
    rec["wrapped_launches"] = counts["witer"]
    print(f"phase 9 wrapped: 183x63, {gr.nnods} nodes, auto -> "
          f"{solver.method}, {iters} iterations (the JAX package: "
          f"{ref_iters}), witer launches={counts['witer']} (path counts "
          f"{counts}); first solve {t_first:.3f} s, steady solve median of "
          f"3 {steady:.2f} ms; a device_dist result through travel_times "
          f"and save_solution_npz equals the host one; 8x150 table "
          f"{1e3 * t_table:.1f} ms, max |table - single solves| = "
          f"{err_table:.3g} s; explicit wrapped at 180x63 "
          f"({w180.last_iterations} iterations): t(60)={t60:.4f} s, "
          f"t(150)={t150:.4f} s, max |wrapped - sweep| = {err_sweep:.3g} s "
          f"over every node", flush=True)


def phase_diag(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U = rt.init_annulus_circulant(127, 63, spacing=20.0)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    solver = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    ref_iters, ref_spread = JAX_SPREAD["diag 127x63"]
    assert solver.method == "diag", solver.method
    assert counts["diag"] == iters > 0, (counts, iters)
    assert iters == ref_iters, (iters, ref_iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    chk = _engine_checks(rt, gr, cg, U, source, D.dist, "diag")
    assert abs(chk["all"] - ref_spread) <= SPREAD_ATOL, chk["all"]
    assert chk["all"] <= ENGINE_ATOL, chk
    assert -ENGINE_ATOL <= chk["below"] and chk["above"] <= ENGINE_ATOL, chk
    assert counts["ring_scan"] == counts["chain_scan"] == iters, counts
    steady = _steady_ms(solver, source, 3)
    # an iteration's scans on the converged field, and the whole
    # iteration
    from raytracer_tpu_torch.ops import diag_circulant as pdc

    ds = pdc.pack_diag_stencil(cg, dtype=np.float32)
    st = pdc.DiagStatic(ds.D, ds.Mp, ds.NTL, ds.pad, ds.ntheta)
    tbl = pdc.device_diag_tables(ds, "cuda")
    sc = pdc.device_diag_scan_tables(ds, "cuda")
    x = torch.full((ds.Mp, ds.NTL), float("inf"), device="cuda")
    valid = cg.cmap.m_of >= 0
    x[torch.as_tensor(cg.cmap.m_of[valid], device="cuda"),
      torch.as_tensor(cg.cmap.c_of[valid], device="cuda")] = torch.as_tensor(
        D.dist[valid], device="cuda")
    ring_ms = _cuda_ms(lambda: pdc.ring_scan(x, sc, ds.ntheta), 20)
    chain_ms = _cuda_ms(lambda: pdc.chain_scan(x, sc), 20)
    tol = torch.tensor(1e-3, device="cuda")
    dcen = torch.tensor(float(D.dist[cg.cmap.center]) if cg.cmap.center >= 0
                        else float("inf"), device="cuda")
    step_ms = _cuda_ms(lambda: pdc.diag_step(st, x, tbl, sc, x, dcen, tol,
                                             True), 20)
    f64 = _f64_against_cpu(rt, "diag", 47, 6, 400.0)

    gr180, cg180, U180, source180, D_sweep, receivers180, degs = \
        rec["sweep_180"]
    d180s = rt.AnnulusSolver(gr180, None, None, U180, method="diag",
                             circulant=cg180)
    t60, t150, d180 = _anchors(rt, d180s, receivers180, degs, source180)
    err_sweep = float(np.abs(d180 - D_sweep.dist).max())
    assert err_sweep <= ENGINE_ATOL, err_sweep
    for name in ("diag", "ring_scan", "chain_scan"):
        rec[name]["launches"] = counts[name]
    rec["diag_ms"] = steady
    rec["diag_launches"] = counts["diag"]
    print(f"phase 10 diag: 127x63, {gr.nnods} nodes, auto -> "
          f"{solver.method}, {iters} iterations (the JAX package: "
          f"{ref_iters}), diag launches={counts['diag']}, ring_scan "
          f"{counts['ring_scan']}, chain_scan {counts['chain_scan']} (path "
          f"counts {counts}); first solve {t_first:.3f} s, steady solve "
          f"median of 3 {steady:.2f} ms, of it per iteration the ring scan "
          f"{ring_ms:.4f} ms and the chain scan {chain_ms:.4f} ms each "
          f"alone, the whole iteration in one diag_step call (the scans, the "
          f"sweep, the fan and the changed test) {step_ms:.4f} ms (CUDA "
          f"events); {f64}; explicit diag at 180x63 "
          f"({d180s.last_iterations} iterations): t(60)={t60:.4f} s, "
          f"t(150)={t150:.4f} s, max |diag - sweep| = {err_sweep:.3g} s "
          f"over every node", flush=True)


def _wedge3d(dims, lo_deg, hi_deg, depth):
    """A (theta, phi, r) wedge grid, theta and phi in [lo, hi] deg, r from
    R - depth to R, and its AK135 Vp."""
    import numpy as np

    import raytracer_tpu_torch as rt

    g = rt.grid3d((np.deg2rad(lo_deg), np.deg2rad(lo_deg), rt.R - depth),
                  (np.deg2rad(hi_deg), np.deg2rad(hi_deg), rt.R), dims)
    prof = rt.velocity_profile("ak135")
    return g, rt.LinearInterpolation(prof.r, prof.Vp)(g.r)


def _sweep3d_work(W4, S, T, itemsize):
    """(bytes, operations, streamed bytes of a 26-weight design, streamed
    bytes of this design) of one sweep3d call of T sweeps.  The bound's
    bytes read each input once and write each output once: the weights
    and the S fields in, the S fields out.  One add and one min per
    finite weight per field per sweep.  The streamed bytes are the floor
    of a design that reads the weights from device memory in every sweep
    (at 1M nodes they exceed the 50 MB L2): all 26 a node in a kernel
    that reads W4, the 13 of the mirrored layout in this one."""
    import torch

    finite = int(torch.isfinite(W4).sum())
    field = W4.shape[0] * W4.shape[2] * W4.shape[3]
    nbytes = itemsize * (W4.numel() + 2 * S * field)
    streamed = itemsize * (T * W4.numel() + 2 * S * field)
    mirrored = itemsize * (T * W4.numel() // 2 + 2 * S * field)
    return nbytes, 2 * finite * S * T, streamed, mirrored


def _field3d(rng, plan, S, dtype):
    """S packed fields of random travel times, ~30 % +inf."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops.sweep3d import pack_field

    v = rng.uniform(0.0, 1500.0, (S,) + plan.shape)
    v[rng.random(v.shape) < 0.3] = np.inf
    return pack_field(torch.from_numpy(v.astype(dtype)).cuda(), plan)


def phase_sweep3d_kernel(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import sweep3d
    from raytracer_tpu_torch.solvers.solve3d import (_shifted_weights,
                                                     prepare3d)
    import raytracer_tpu_torch as rt

    rng = np.random.default_rng(7)
    max_err = 0.0
    small = []
    # the last case's four plane tiles of 8 float64 fields do not fit
    # with all 640 lanes: the kernel takes lane chunks of 128
    for dims, dtype, S, block_rows in (((7, 5, 4), np.float32, 1, 32),
                                       ((130, 6, 3), np.float32, 3, 32),
                                       ((8, 8, 3), np.float64, 1, 1024),
                                       ((600, 4, 3), np.float64, 8, 1024)):
        g, U = _wedge3d(dims, 80.0, 100.0, 600.0)
        plan = sweep3d.plan_sweep3d(_shifted_weights(g, U, dtype), block_rows)
        W4 = torch.from_numpy(plan.W4).cuda()
        f = _field3d(rng, plan, S, dtype)
        args = (W4, plan.n1, plan.BR, plan.NB, plan.L0, plan.H8, 3)
        out_k = sweep3d.sweep3d_T_batched(f, *args)
        out_r = sweep3d.sweep3d_reference(f, *args)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        max_err = max(max_err, err)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"sweep3d kernel != plain version at {dims} "
                                 f"{np.dtype(dtype).name} S={S}: max abs "
                                 f"err {err}")
        small.append(f"{dims} {np.dtype(dtype).name} S={S} L0={plan.L0}")

    t0 = time.perf_counter()
    g, U = _wedge3d(WEDGE_DIMS, 60.0, 120.0, 2500.0)
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = prepare3d(g, U, rt.SolverConfig(dtype="float32"))
    t_prep = time.perf_counter() - t0
    rec["wedge"] = (g, U, packed, t_grid, t_prep)
    plan = packed.plan
    W4 = torch.from_numpy(plan.W4).cuda()
    T = 8
    rows = []
    for S in (1, TABLE3D_BATCH):
        f = _field3d(rng, plan, S, np.float32)
        args = (W4, plan.n1, plan.BR, plan.NB, plan.L0, plan.H8, T)
        out_k = sweep3d.sweep3d_T_batched(f, *args)
        out_r = sweep3d.sweep3d_reference(f, *args)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        max_err = max(max_err, err)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"sweep3d kernel != plain version at "
                                 f"{WEDGE_DIMS} S={S}: max abs err {err}")
        ms = _cuda_ms(lambda: sweep3d.sweep3d_T_batched(f, *args), 10)
        plain = _cuda_ms(lambda: sweep3d.sweep3d_reference(f, *args), 2)
        nbytes, ops, streamed, mirrored = _sweep3d_work(W4, S, T, 4)
        bound, by = _bound_ms(nbytes, ops)
        rows.append(dict(S=S, ms=ms, plain_ms=plain, bound_ms=bound,
                         bound_by=by, nbytes=nbytes, ops=ops,
                         stream_ms=_bound_ms(streamed, ops)[0],
                         streamed=streamed,
                         mirror_ms=_bound_ms(mirrored, ops)[0],
                         mirrored=mirrored))
    rec["sweep3d"] = {k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")}
    rec["sweep3d"]["max_abs_err"] = max_err
    rec["sweep3d_rows"] = rows
    print("phase 3c kernels: sweep3d (T=3) bit-equal to sweep3d_reference at "
          + "; ".join(small) + f"; at {WEDGE_DIMS} (NB={plan.NB}, "
          f"BR={plan.BR}, L0={plan.L0}, W4 {W4.numel() * 4 / 1e6:.2f} MB) "
          f"T={T}: " + "; ".join(
              f"S={r['S']}: kernel {r['ms']:.4f} ms per call, plain "
              f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}, {r['nbytes'] / 1e6:.1f} MB, "
              f"{r['ops'] / 1e9:.3f} G ops); bytes from device memory per "
              f"call of this design (13 weights a node a sweep, the mirror "
              f"reads in L2) {r['mirrored'] / 1e6:.1f} MB, floor "
              f"{r['mirror_ms']:.5f} ms; of a design that reads all 26 a "
              f"sweep "
              f"{r['streamed'] / 1e6:.1f} MB, floor {r['stream_ms']:.5f} ms"
              for r in rows)
          + f"; grid {t_grid:.2f} s, prepare3d {t_prep:.2f} s", flush=True)


def phase_grid3d(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.example_grid3d import (RECEIVER_DEGREES,
                                                    SOURCE_DEGREES,
                                                    surface_nodes)
    from raytracer_tpu_torch.solvers.solve3d import (_auto_source_batch,
                                                     select_engine3d)

    g, U, packed, t_grid, t_prep = rec["wedge"]
    cfg = rt.SolverConfig(dtype="float32")
    n = len(g)
    route = select_engine3d(packed, "auto", np.float32)
    batch = _auto_source_batch(packed.plan, 4, TABLE3D_SOURCES)
    assert route == "pallas" and batch == TABLE3D_BATCH, (route, batch)

    # the main 3-D path: one source's whole field
    src = n - n // 2
    _reset_counts()
    t0 = time.perf_counter()
    d1, it1 = rt.solve3d(g, U, [src], cfg, _packed=packed)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    launches = counts["sweep3d"]
    assert launches > 0 and launches * 8 == it1, (counts, it1)
    assert d1.shape == (1, n) and np.isfinite(d1).all()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.solve3d(g, U, [src], cfg, _packed=packed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steady = 1e3 * statistics.median(times)
    # device time of one solve by kernel (torch.profiler)
    split = _kernel_split_ms(
        lambda: rt.solve3d(g, U, [src], cfg, _packed=packed), 1)
    t0 = time.perf_counter()
    d_cpu, it_cpu = rt.solve3d(g, U, [src], cfg, _packed=packed, device="cpu")
    t_cpu = time.perf_counter() - t0
    assert it_cpu == it1, (it_cpu, it1)
    assert np.array_equal(d1, d_cpu), float(np.abs(d1 - d_cpu).max())

    # the example's 3 surface sources x 3 receivers against the JAX package
    srcs3 = surface_nodes(g, SOURCE_DEGREES)
    recs3 = surface_nodes(g, RECEIVER_DEGREES)
    tab3, it3 = rt.solve3d(g, U, srcs3, cfg, receivers=recs3, _packed=packed)
    err3 = float(np.abs(tab3 - np.asarray(JAX_WEDGE)).max())
    assert err3 <= T_ATOL, (err3, tab3)

    # the 64-source x 1024-receiver table (benchmarks/chip_dsweep3d.py)
    rng = np.random.default_rng(0)
    srcs64 = rng.integers(0, n, TABLE3D_SOURCES).tolist()
    recs = rng.integers(0, n, TABLE3D_RECEIVERS).tolist()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table, it_tab = rt.solve3d(g, U, srcs64, cfg, receivers=recs,
                               _packed=packed)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    tab_launches = _counts()["sweep3d"]
    assert table.shape == (TABLE3D_SOURCES, TABLE3D_RECEIVERS)
    assert np.isfinite(table).all()
    err_rows = 0.0
    for q in (0, TABLE3D_SOURCES // 2, TABLE3D_SOURCES - 1):
        row, _ = rt.solve3d(g, U, [srcs64[q]], cfg, receivers=recs,
                            _packed=packed)
        err_rows = max(err_rows, float(np.abs(row[0] - table[q]).max()))
    assert err_rows <= BATCH_ATOL, err_rows

    # the predecessor tree of the single source, on the card and the CPU
    prev = rt.recover_prev3d(g, U, d1, [src], cfg, _packed=packed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = rt.recover_prev3d(g, U, d1, [src], cfg, _packed=packed)
    torch.cuda.synchronize()
    t_prev = time.perf_counter() - t0
    prev_cpu = rt.recover_prev3d(g, U, d1, [src], cfg, _packed=packed,
                                 device="cpu")
    assert np.array_equal(prev, prev_cpu)
    hops = []
    for r in recs3:
        p = rt.recontruct_path(prev[0], src, r)
        assert p[0] == r and p[-1] == src and len(p) > 1, (r, p[:3])
        assert np.all(np.diff(d1[0][p]) < 0), r
        hops.append(len(p) - 1)

    ms1 = rec["sweep3d"]["ms"]
    ms7 = rec["sweep3d_rows"][1]["ms"]
    rec["sweep3d"]["launches"] = launches
    rec["grid3d_ms"] = steady
    rec["grid3d_launches"] = launches
    print(f"phase 11 grid3d: {WEDGE_DIMS}, {n} nodes (grid {t_grid:.2f} s, "
          f"prepare3d {t_prep:.2f} s), auto -> {route}, source batch "
          f"{batch} for {TABLE3D_SOURCES} sources. Single source {src}: "
          f"{it1} iterations, sweep3d launches={launches} (path counts "
          f"{counts}); first solve {t_first:.3f} s, steady solve median of 3 "
          f"{steady:.2f} ms, of it the kernel {launches} x {ms1:.4f} ms = "
          f"{100 * launches * ms1 / steady:.1f} %; device ms per solve "
          f"by kernel (torch.profiler): " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items())
          + f" (busy {100 * sum(split.values()) / steady:.1f} % of the "
          f"steady solve); bit-equal to the CPU "
          f"route ({it_cpu} iterations, {t_cpu:.1f} s through the plain "
          f"twin). 3x3 surface table ({it3} iterations) within "
          f"{err3:.3g} s of the JAX package's. {TABLE3D_SOURCES}x"
          f"{TABLE3D_RECEIVERS} table: {1e3 * t_table:.1f} ms = "
          f"{1e3 * t_table / TABLE3D_SOURCES:.2f} ms per source, {it_tab} "
          f"iterations at most, {tab_launches} launches, of it the kernel "
          f"{tab_launches} x {ms7:.4f} ms = "
          f"{100 * tab_launches * ms7 / (1e3 * t_table):.1f} %; three rows "
          f"within {err_rows:.3g} s of their single solves. recover_prev3d "
          f"{1e3 * t_prev:.2f} ms, equal to the CPU recovery; backtraces of "
          f"{hops} hops descend to the source", flush=True)


def phase_example3d():
    import numpy as np

    t0 = time.perf_counter()
    out = _run([sys.executable, "-m", "raytracer_tpu_torch.example_grid3d"])
    rows = [ln for ln in out.splitlines() if ln.strip().startswith("src (")]
    got = np.array([[float(v) for v in ln.split(":")[1].split()]
                    for ln in rows])
    assert got.shape == (3, 3), out
    assert "engine pallas" in out and "on cuda" in out, out
    # printed to 0.01 s: |printed - JAX| <= 0.005 + |port - JAX|
    err = float(np.abs(got - np.asarray(JAX_EXAMPLE)).max())
    assert err <= T_ATOL, (err, out)
    solve_line = [ln for ln in out.splitlines() if "solve" in ln][0]
    print(f"phase 12 example_grid3d: defaults on the card, "
          f"'{solve_line.strip()}', table within {err:.3g} s of the root "
          f"example's ({time.perf_counter() - t0:.1f} s)", flush=True)


def _stencil_bytes(ts):
    """Bytes of the lane-gather stencil that a sweep must read: one weight
    and one source lane for each finite (k, lane) weight, each row's
    source (u_of) and each tile's first row (offs), not the kernels'
    padded forms of it."""
    import numpy as np

    finite = int(np.isfinite(ts.w).sum())
    return (4 + ts.w.dtype.itemsize) * finite + 4 * (ts.u_of.size
                                                    + ts.offs.size)


def _relax_work(ts, S, itemsize):
    """(bytes, operations) of one relax sweep: the state read and written
    once, the stencil's finite weights once (`_stencil_bytes`); one add
    and one min per finite (k, lane) weight for every real theta row of
    every source."""
    import numpy as np

    nt = ts.ntheta
    state = ts.T * S * (-(-nt // 8) * 8) * 128 * itemsize
    nbytes = 2 * state + _stencil_bytes(ts)
    return nbytes, 2 * int(np.isfinite(ts.w).sum()) * nt * S


def _fused_work(ts, tbl, S, iters, itemsize):
    """(bytes, operations) of one fused solve of `iters` iterations (the
    count the kernel returned for these inputs).  Bytes: the stencil's
    finite weights (`_stencil_bytes`) and the ring, chain and fan weights
    once, the state and the centre in and out once.  Operations per iteration,
    over the real theta rows only (pad rows never reach a real one): the
    ring steps (a multiply, an add and two mins per element of a ring whose
    hop cost is finite), the chain steps (an add and a min per finite jump
    cost), the relaxation (an add and a min per finite weight), the fan (an
    add and a min each way per finite fan weight) and the convergence
    compare (one per element)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.contrib.fused_circulant import RING_STEPS

    nt = ts.ntheta
    steps = sum(1 for k in range(RING_STEPS) if (1 << k) % nt)
    ring = 4 * steps * int(np.isfinite(ts.ring_w).sum()) * nt
    chain = 2 * int(torch.isfinite(tbl.pdn).sum()
                    + torch.isfinite(tbl.pup).sum()) * nt
    relax = 2 * int(np.isfinite(ts.w).sum()) * nt
    fan = 4 * int(np.isfinite(ts.fan_w).sum()) * nt
    compare = ts.T * 128 * nt
    ops = iters * S * (ring + chain + relax + fan + compare)
    state = ts.T * S * (-(-nt // 8) * 8) * 128 * itemsize
    tables = _stencil_bytes(ts) + sum(
        t.numel() * t.element_size()
        for t in (tbl.ring_w, tbl.pdn, tbl.pup, tbl.fan_w))
    return tables + 2 * state + 2 * S * itemsize, ops


def _lane_field(rng, ts, S):
    """Random (T, S, ntp, 128) travel times in the stencil's dtype, ~30 %
    +inf, with finite pad rows (the fan writes such rows; a sweep must
    reset them to +inf)."""
    import numpy as np
    import torch

    nt = ts.ntheta
    ntp = -(-nt // 8) * 8
    d = rng.uniform(0.0, 1500.0, (ts.T, S, ntp, 128)).astype(ts.w.dtype)
    d[rng.random(d.shape) < 0.3] = np.inf
    d[:, :, nt:] = rng.uniform(0.0, 1500.0, d[:, :, nt:].shape)
    return torch.from_numpy(d).cuda()


def phase_lane_gather_kernels(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.contrib import fused_circulant as pfc
    from raytracer_tpu_torch.contrib import pallas_circulant as ppc

    rng = np.random.default_rng(8)
    relax_rows = []
    # the path's shapes (180x63, S=1; the table's S=8) and float64 at 24x12
    for (ntheta, nr, spacing), S, dtype in (
            ((180, 63, 20.0), 1, np.float32), ((180, 63, 20.0), 8, np.float32),
            ((24, 12, 150.0), 2, np.float64)):
        _, cg, _ = rt.init_annulus_circulant(ntheta, nr, spacing=spacing)
        ts = ppc.pack_tiled_stencil(cg, dtype)
        nt = ts.ntheta
        ntp = -(-nt // 8) * 8
        tb = ppc.device_pallas_tables(ts, "cuda")
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        x = _lane_field(rng, ts, S)
        args = (tb.offs, tb.u_of, tb.idx, tb.w, ts.T, nt, S, ntp)
        out_k = ppc.relax(x, *args)
        out_r = ppc.relax_reference(x, *args)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"relax kernel != plain version at {name} "
                                 f"S={S}: max abs err {err}")
        ms = _cuda_ms(lambda: ppc.relax(x, *args, ), 50)
        plain = _cuda_ms(lambda: ppc.relax_reference(x, *args), 2)
        nbytes, ops = _relax_work(ts, S, np.dtype(dtype).itemsize)
        bound, by = _bound_ms(nbytes, ops)
        dev = _kernel_split_ms(lambda: ppc.relax(x, *args), 5)
        chunks = ppc._kernel_chunks(*args[:5])[0].shape[0]
        relax_rows.append(dict(
            grid=name, S=S, T=ts.T, K=ts.idx.shape[0],
            chunks=int(chunks), max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, nbytes=nbytes,
            ops=ops, device_ms=dev))

    fused_rows, cuts = [], []
    eight = tuple(np.linspace(0.0, 360.0, 8, endpoint=False))
    # the modular ring shifts (24x12, S=2, also in float64), the table's
    # width (48x12 and 180x63, S=8) and the solve (180x63, S=1)
    for ntheta, nr, spacing, degs, dtype in (
            (24, 12, 150.0, (0.0, 97.0), np.float32),
            (24, 12, 150.0, (0.0, 97.0), np.float64),
            (48, 12, 150.0, eight, np.float32),
            (180, 63, 20.0, (0.0,), np.float32),
            (180, 63, 20.0, eight, np.float32)):
        gr, cgf, _ = rt.init_annulus_circulant(ntheta, nr, spacing=spacing)
        tsf = ppc.pack_tiled_stencil(cgf, dtype)
        ntf = tsf.ntheta
        ntpf = -(-ntf // 8) * 8
        srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                for d in degs]
        S = len(srcs)
        d0, c0 = ppc.initial_state(cgf, srcs, tsf.T, ntpf, dtype)
        x0 = torch.from_numpy(d0.reshape(tsf.T, S * ntpf, 128)).cuda()
        cen0 = torch.from_numpy(c0).cuda()
        tbl = pfc.device_fused_tables(tsf, "cuda")
        st = pfc.FusedStatic(tsf.T, ntf, ntpf, S)
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        # the loop cut at max_iters: no iteration, and three (the last
        # fan and the snapshot's copy back at the cut)
        for m in ((0, 3) if ntheta == 24 else ()):
            x_k, c_k, it_k = pfc.fused(x0, cen0, tbl, st, m)
            x_r, c_r, it_r = pfc.fused_reference(x0, cen0, tbl, st, m)
            torch.cuda.synchronize()
            if not (torch.equal(x_k, x_r) and torch.equal(c_k, c_r)
                    and int(it_k) == it_r):
                raise AssertionError(
                    f"fused kernel != plain version at {name} S={S} cut at "
                    f"max_iters={m}: max abs err "
                    f"{max(_max_err(x_k, x_r), _max_err(c_k, c_r))}, "
                    f"iterations {int(it_k)} and {it_r}")
            cuts.append(f"{name} S={S} max_iters={m}: {it_r} iterations")
        x_k, c_k, it_k = pfc.fused(x0, cen0, tbl, st, 100_000)
        it_k = int(it_k)
        t0 = time.perf_counter()
        x_r, c_r, it_r = pfc.fused_reference(x0, cen0, tbl, st, 100_000)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        err = max(_max_err(x_k, x_r), _max_err(c_k, c_r))
        if not (torch.equal(x_k, x_r) and torch.equal(c_k, c_r)
                and it_k == it_r):
            raise AssertionError(
                f"fused kernel != plain version at {ntheta}x{nr} S={S}: max "
                f"abs err {err}, iterations {it_k} and {it_r}")
        ms = _cuda_ms(lambda: pfc.fused(x0, cen0, tbl, st, 100_000), 3)
        nbytes, ops = _fused_work(tsf, tbl, S, it_k,
                                  np.dtype(dtype).itemsize)
        bound, by = _bound_ms(nbytes, ops)
        fused_rows.append(dict(
            grid=name, S=S, T=tsf.T, iters=it_k, max_abs_err=err,
            ms=ms, plain_ms=1e3 * t_plain,
            bound_ms=bound, bound_by=by, nbytes=nbytes, ops=ops,
            chunks=int(tbl.ck_info.shape[0])))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    # times at the main paths' shapes (180x63, S=1), errors over every case
    rec["relax"] = {k: relax_rows[0][k] for k in keys}
    rec["relax"]["max_abs_err"] = max(r["max_abs_err"] for r in relax_rows)
    rec["fused"] = {k: fused_rows[3][k] for k in keys}
    rec["fused"]["max_abs_err"] = max(r["max_abs_err"] for r in fused_rows)
    rec["fused_iters"] = fused_rows[3]["iters"]
    print("phase 3d kernels: relax bit-equal to relax_reference (finite pad "
          "rows in): "
          + "; ".join(f"{r['grid']} S={r['S']} (T={r['T']}, K_tot={r['K']}, "
                      f"{r['chunks']} chunks): kernel {r['ms']:.4f} ms (device "
                      "ms by kernel, torch.profiler: "
                      + ", ".join(f"{k} {v:.4f}"
                                  for k, v in r['device_ms'].items())
                      + f"), plain {r['plain_ms']:.2f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e6:.1f} M "
                      f"ops)" for r in relax_rows)
          + ". fused bit-equal to fused_reference, same iterations: "
          + "; ".join(f"{r['grid']} S={r['S']} T={r['T']}: {r['iters']} "
                      f"iterations, {r['chunks']} chunks, kernel "
                      f"{r['ms']:.3f} ms per solve "
                      f"({1e3 * r['ms'] / r['iters']:.2f} us per iteration), "
                      f"plain {r['plain_ms'] / 1e3:.2f} s, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e9:.3f} G "
                      f"ops)" for r in fused_rows)
          + ". fused cut at max_iters, bit-equal: " + "; ".join(cuts),
          flush=True)


def phase_contrib(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U, source, D_sweep, receivers, degs = rec["sweep_180"]
    tight = rt.AnnulusSolver(gr, None, None, U,
                             rt.SolverConfig(tol=TIGHT_TOL, max_iters=5000),
                             method="twrapped", circulant=cg)
    d_tight = tight.solve(source, want_prev=False).dist
    assert tight.last_iterations == JAX_CONTRIB["twrapped tight"], \
        tight.last_iterations
    gs, cgs, Us = rt.init_annulus_circulant(48, 12, spacing=150.0)
    src_s = rt.closest_point(gs, 0.0, rt.R, system="polar")
    srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(0.0, 315.0, TABLE_SOURCES)]
    recs = np.asarray(receivers[:TABLE_RECEIVERS])
    parts = []
    for method, kernel in (("pallas", "relax"), ("fused", "fused")):
        t_engine = time.perf_counter()
        solver = rt.AnnulusSolver(gr, None, None, U, method=method,
                                  circulant=cg)
        _reset_counts()
        t0 = time.perf_counter()
        D = solver.solve(source)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = _counts()
        iters = solver.last_iterations
        ref_iters, ref_above, ref_below, ref_reach = JAX_CONTRIB[method]
        assert solver.method == method and iters == ref_iters, \
            (solver.method, iters)
        if method == "pallas":
            assert counts["relax"] == iters, counts
        else:
            assert counts["fused"] == 1, counts
        assert sum(counts.values()) == counts[kernel], counts
        assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
        tt = rt.travel_times(D, gr, receivers)
        t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
        t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
        assert abs(t60 - T60_REF) <= T_ATOL, (method, t60)
        assert abs(t150 - T150_REF) <= T_ATOL, (method, t150)
        above = float((D.dist - d_tight).max())
        below = float(-(D.dist - d_tight).min())
        assert abs(above - ref_above) <= SPREAD_ATOL, (method, above)
        assert abs(below - ref_below) <= SPREAD_ATOL, (method, below)
        err_sweep = float(np.abs(D.dist - D_sweep.dist).max())
        if method == "pallas":
            assert err_sweep <= ENGINE_ATOL, err_sweep
        else:
            assert max(above, below) <= CPU_ATOL, (above, below)
        reach = _reaching(D.prev, source, receivers)
        assert len(reach) == ref_reach, (method, len(reach))
        paths = [rt.recontruct_path(D.prev, source, r) for r in reach]
        for r, p in zip(reach, paths):
            assert p[0] == r and p[-1] == source and len(p) > 1, (r, p[:3])
        prev = solver.recover_prev(D.dist)
        prev[source] = source
        assert np.array_equal(prev, D.prev)
        # the same route on the CPU, bit for bit, at 48x12
        t_small = time.perf_counter()
        small = [rt.AnnulusSolver(gs, None, None, Us, method=method,
                                  circulant=cgs, device=dev)
                 for dev in ("cuda", "cpu")]
        d_small = [s.solve(src_s, want_prev=False).dist for s in small]
        t_small = time.perf_counter() - t_small
        assert np.array_equal(d_small[0], d_small[1]), method
        assert small[0].last_iterations == small[1].last_iterations
        # 8 x 150 table (S = 8 on the kernel's rows), rows against singles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = solver.travel_time_table(srcs, recs, batch=8)
        torch.cuda.synchronize()
        t_table = time.perf_counter() - t0
        assert table.shape == (TABLE_SOURCES, TABLE_RECEIVERS)
        assert np.isfinite(table).all()
        rows = (0, 3, 7)
        assert srcs[0] == source  # row 0 is D's
        err_table = float(max(np.abs(
            table[i] - (D.dist if i == 0 else solver.solve(
                srcs[i], want_prev=False).dist)[recs]).max() for i in rows))
        assert err_table <= CPU_ATOL, (method, err_table)
        steady = _steady_ms(solver, source, 3)
        rec[kernel]["launches"] = counts[kernel]
        rec[f"{method}_ms"] = steady
        parts.append(
            f"{method}: {iters} iterations (the JAX package: {ref_iters}), "
            f"{kernel} launches={counts[kernel]}, t(60)={t60:.4f} s, "
            f"t(150)={t150:.4f} s; against twrapped at tol={TIGHT_TOL:g} "
            f"{above:.6g} s above and {below:.6g} s below (the JAX package: "
            f"{ref_above:.6g} and {ref_below:.6g}); max |{method} - sweep| = "
            f"{err_sweep:.3g} s over every node; prev tree equal to "
            f"recover_prev, {len(reach)} of {len(receivers)} receiver paths "
            f"reach the source without a cycle (the JAX package: "
            f"{ref_reach}); 48x12 bit-equal to the CPU "
            f"route ({small[0].last_iterations} iterations, both solves "
            f"{t_small:.1f} s); 8x150 table "
            f"{1e3 * t_table:.1f} ms, rows {rows} within {err_table:.3g} s "
            f"of single solves; first solve+prev {t_first:.3f} s, steady "
            f"solve median of 3 {steady:.2f} ms "
            f"({time.perf_counter() - t_engine:.1f} s)")
    print(f"phase 13 pallas and fused: 180x63, {gr.nnods} nodes, twrapped at "
          f"tol={TIGHT_TOL:g} {tight.last_iterations} iterations; "
          + "; ".join(parts), flush=True)


def main():
    faulthandler.dump_traceback_later(900, exit=True)
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    phase_environment()
    import torch

    rec: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for phase in (phase_build, lambda: phase_kernels(rec),
                      lambda: phase_jacobi_kernels(rec),
                      lambda: phase_wrapped_diag_kernels(rec),
                      lambda: phase_sweep3d_kernel(rec),
                      lambda: phase_lane_gather_kernels(rec),
                      lambda: phase_main_path(rec, tmp),
                      lambda: phase_cli(tmp), lambda: phase_twrapped(rec),
                      lambda: phase_stream(rec), lambda: phase_tables(rec),
                      lambda: phase_wrapped(rec, tmp),
                      lambda: phase_diag(rec),
                      lambda: phase_grid3d(rec), phase_example3d,
                      lambda: phase_contrib(rec)):
            t0 = time.perf_counter()
            phase()
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    sources = {
        "rsweep": ("raytracer_tpu_torch/csrc/rsweep.cu",
                   "raytracer_tpu/ops/sweep_theta.py:551",
                   "auto 180x63 -> sweep"),
        "titer": ("raytracer_tpu_torch/csrc/titer.cu",
                  "raytracer_tpu/ops/wrapped_t.py:254",
                  "twrapped 180x63"),
        "band": ("raytracer_tpu_torch/csrc/band.cu",
                 "raytracer_tpu/ops/stream_t.py:253",
                 "stream 1080x300"),
        "witer": ("raytracer_tpu_torch/csrc/witer.cu",
                  "raytracer_tpu/ops/diag_wrapped.py:272",
                  "auto 183x63 -> wrapped"),
        "diag": ("raytracer_tpu_torch/csrc/diag.cu",
                 "raytracer_tpu/ops/diag_circulant.py:230",
                 "auto 127x63 -> diag"),
        "ring_scan": ("raytracer_tpu_torch/csrc/diag_scans.cuh",
                      "raytracer_tpu/ops/diag_circulant.py:284",
                      "auto 127x63 -> diag"),
        "chain_scan": ("raytracer_tpu_torch/csrc/diag_scans.cuh",
                       "raytracer_tpu/ops/diag_circulant.py:316",
                       "auto 127x63 -> diag"),
        "sweep3d": ("raytracer_tpu_torch/csrc/sweep3d.cu",
                    "raytracer_tpu/ops/sweep3d.py:90",
                    "solve3d auto 128x128x64 -> pallas"),
        "relax": ("raytracer_tpu_torch/csrc/relax.cu",
                  "raytracer_tpu/contrib/pallas_circulant.py:171",
                  "pallas 180x63"),
        "fused": ("raytracer_tpu_torch/csrc/fused.cu",
                  "raytracer_tpu/contrib/fused_circulant.py:67",
                  "fused 180x63"),
    }
    kernels_line = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "path": path,
        "launches": rec[name]["launches"],
        "bit_equal": True,
        "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"],
        "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"],
        "bound_by": rec[name]["bound_by"],
        "library_ms": None,
    } for name, (src, replaces, path) in sources.items()]}
    for k in kernels_line["kernels"]:
        assert k["launches"] > 0, k
    faulthandler.cancel_dump_traceback_later()
    print(f"total wall {time.perf_counter() - t_start:.1f} s "
          f"(twrapped steady solve {rec['twrapped_ms']:.2f} ms, stream "
          f"steady solve {rec['stream_ms']:.1f} ms, wrapped 183x63 "
          f"{rec['wrapped_ms']:.2f} ms = {rec['wrapped_launches']} x "
          f"{rec['witer']['ms']:.4f} ms of witer + the rest, diag 127x63 "
          f"{rec['diag_ms']:.2f} ms = {rec['diag_launches']} x "
          f"({rec['diag']['ms']:.4f} ms of diag + "
          f"{rec['ring_scan']['ms']:.4f} of ring_scan + "
          f"{rec['chain_scan']['ms']:.4f} of chain_scan) + the rest, 3-D "
          f"128x128x64 {rec['grid3d_ms']:.2f} ms = {rec['grid3d_launches']} "
          f"x {rec['sweep3d']['ms']:.4f} ms of sweep3d + the rest, pallas "
          f"180x63 {rec['pallas_ms']:.1f} ms = {rec['relax']['launches']} x "
          f"{rec['relax']['ms']:.4f} ms of relax + the rest, fused 180x63 "
          f"{rec['fused_ms']:.2f} ms = 1 launch of {rec['fused_iters']} "
          f"iterations)",
          flush=True)
    print(json.dumps(kernels_line))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
