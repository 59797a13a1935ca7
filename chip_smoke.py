"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero):
  1. environment: torch, CUDA, nvcc release, ninja, the card's name and
     power limit;
  2. build: every CUDA kernel of the port, one nvcc per source, all
     started together;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes of the 180x63 AK135 main path (bit equality: each candidate
     is one f32 add followed by a min), with both timed;
  4. the main path through the user entry points: init_annulus_circulant
     (180, 63, 20) -> AnnulusSolver(method="auto") on cuda -> solve with
     prev -> receiver fan -> paths -> travel-time CSV, with the kernel
     launch counts read just around it and the result held against the
     JAX package's anchors and the same solve on the CPU;
  5. the port's main_annulus CLI into a temporary directory.
Then one JSON line of kernel numbers, the card's name and power limit
from nvidia-smi, and as the last line {"ok": true, "device": {...}}.

Needs no network and writes only to a temporary directory and to the
package's `_build/`.  Without CUDA, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

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


def phase_kernels(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops.sweep_theta import (device_tables, rsweep,
                                                     rsweep_reference)
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    _, cg, _ = init_annulus_circulant(180, 63, spacing=20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    _, static, wdn, wup, rst = device_tables(ws, cg, np.float32, "cuda")
    nt = static.nt
    blocked = rst._replace(NTB=rst.NTL // 2)
    rng = np.random.default_rng(0)
    cases = [(rst, 1, False), (rst, 1, True), (rst, 4, False),
             (rst, 4, True), (blocked, 2, False), (blocked, 2, True)]
    max_err = 0.0
    for st, S, up in cases:
        buf = _rsweep_buffer(rng, st, nt, S, up)
        wtab = wup if up else wdn
        out_k = rsweep(buf.clone(), wtab, st, up)
        out_r = rsweep_reference(buf.clone(), wtab, st, up)
        torch.cuda.synchronize()
        same_inf = torch.equal(torch.isinf(out_k), torch.isinf(out_r))
        fin = torch.isfinite(out_r)
        err = float((out_k[fin] - out_r[fin]).abs().max()) if fin.any() else 0.0
        max_err = max(max_err, err if same_inf else float("inf"))
        if not torch.equal(out_k, out_r):
            raise AssertionError(
                f"rsweep kernel != plain version (S={S}, upward={up}, "
                f"NTB={st.NTB}/{st.NTL}): max abs err {err}, "
                f"inf pattern equal {same_inf}")
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
          f"NTB={blocked.NTB}<NTL={rst.NTL}); at S=1 (MT={rst.MT}, "
          f"K8={rst.K8}, NTL={rst.NTL}, {len(rst.taps_dn)}+"
          f"{len(rst.taps_up)} taps, {times['finite'][0]}/"
          f"{times['finite'][1]} finite (row, tap) weights) kernel down/up "
          f"{times['ms'][0]:.4f}/{times['ms'][1]:.4f} ms, plain "
          f"{times['plain_ms'][0]:.1f}/{times['plain_ms'][1]:.1f} ms, "
          f"bound {times['bound_ms'][0]:.5f}/{times['bound_ms'][1]:.5f} ms "
          f"({times['bound_by'][0]}); kernel at S=4 down {ms4:.4f} ms",
          flush=True)


def phase_main_path(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.main_annulus import receiver_degrees
    from raytracer_tpu_torch.ops import sweep_theta

    t_build = time.perf_counter()
    gr, cg, U = rt.init_annulus_circulant(180, 63, spacing=20.0)
    t_build = time.perf_counter() - t_build
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")

    sweep_theta.rsweep.launches = 0
    solver = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg)
    t0 = time.perf_counter()
    D = solver.solve(source)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    degs = receiver_degrees()
    receivers = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                 for d in degs]
    paths = [rt.recontruct_path(D.prev, source, r) for r in receivers]
    csv_path = os.path.join(tmp, "main_path_travel_times.csv")
    tt = rt.travel_times(D, gr, receivers, isave=True, flname=csv_path)
    launches = sweep_theta.rsweep.launches
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
    with open(csv_path) as f:
        assert len(f.read().strip().splitlines()) == len(degs) + 1

    cpu = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg,
                           device="cpu")
    d_cpu = cpu.solve(source, want_prev=False).dist
    err_cpu = float(np.abs(D.dist - d_cpu).max())
    assert err_cpu <= CPU_ATOL, err_cpu

    steady = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(source, want_prev=False)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = solver.recover_prev(D.dist)
    torch.cuda.synchronize()
    t_prev = time.perf_counter() - t0
    prev[source] = source
    assert np.array_equal(prev, D.prev)

    rec["rsweep"]["launches"] = launches
    print(f"phase 4 main path: {gr.nnods} nodes (grid {t_build:.2f} s), "
          f"method={solver.method} on {solver.device}, {rounds} rounds, "
          f"rsweep launches={launches}, t(60)={t60:.4f} s, "
          f"t(150)={t150:.4f} s, max |cuda - cpu| = {err_cpu:.3g} s, "
          f"{len(paths)} paths end at the source; first solve+prev "
          f"{t_first:.3f} s, steady solve median of 5 "
          f"{1e3 * statistics.median(steady):.2f} ms, prev recovery "
          f"{1e3 * t_prev:.2f} ms", flush=True)


def phase_cli(tmp: str):
    from raytracer_tpu_torch import main_annulus

    prefix = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    main_annulus.main(["--out-prefix", prefix])
    with open(f"{prefix}_travel_times.csv") as f:
        n_rows = len(f.read().strip().splitlines())
    assert n_rows == 151, n_rows
    assert os.path.getsize(f"{prefix}.npz") > 0
    print(f"phase 5 cli: main_annulus wrote {n_rows - 1} travel times and "
          f"the npz in {time.perf_counter() - t0:.2f} s", flush=True)


def main():
    faulthandler.dump_traceback_later(480, exit=True)
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    phase_environment()
    import torch

    phase_build()
    rec: dict = {}
    phase_kernels(rec)
    with tempfile.TemporaryDirectory() as tmp:
        phase_main_path(rec, tmp)
        phase_cli(tmp)
    r = rec["rsweep"]
    kernels_line = {"kernels": [{
        "name": "rsweep",
        "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/rsweep.cu",
        "replaces": "raytracer_tpu/ops/sweep_theta.py:551",
        "launches": r["launches"],
        "bit_equal": True,
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "kernel_ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
    }]}
    faulthandler.cancel_dump_traceback_later()
    print(f"total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels_line))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
