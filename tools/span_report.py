"""Where a table request's time goes, read from the port's own spans
(`raytracer_tpu_torch.utils.profiling`), on one NVIDIA GPU.

    python3 tools/span_report.py [--requests 6] [--seed 7] [--out FILE]

Builds the AK135 annulus at 180x63 with 20 km spacing (auto -> the
directional sweep), solves 32 events x 150 surface stations a request in
batches of 8, warms up, then profiles `--requests` requests with
torch.profiler (CPU and CUDA) and prints, per request:
- each span name: spans, host ms, device ms (entry to exit CUDA event,
  in stream order), the device's idle ms whose gap midpoint falls in it
  as the innermost span (`-` outside every span), and the host_syncs
  kept under it;
- the set-up: `import torch`, the CUDA context, the program's build and
  the first request, and each `build.*` span (the outermost of a name
  nested in itself counted once);
- the spans' own cost: host microseconds of an empty span with no
  profiler, and under one with and without CUDA events, and the median
  request with and without the profiler.
With `--out` the same as JSON.
"""
import argparse
import collections
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
T_START = time.perf_counter()
import torch  # noqa: E402

T_TORCH = time.perf_counter()


def device_and_host(prof):
    """(device intervals, host) in us from a stopped profiler's events."""
    from torch.autograd import DeviceType

    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU and not e.is_user_annotation():
            device.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3))
    return sorted(device)


def idle_gaps(device, lo, hi):
    gaps, t = [], lo
    for s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def innermost(spans, t):
    """The name of the innermost span holding time t (us), or '-'."""
    best = None
    for s in spans:
        if s.t0_ns * 1e-3 <= t <= s.t1_ns * 1e-3 and (
                best is None or s.t0_ns > best.t0_ns):
            best = s
    return best.name if best is not None else "-"


def span_cost(dev, n):
    """Host us a span: with no profiler, and under one without and with
    CUDA events (the events made anew, then taken from the pool that
    `records()` refills)."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.utils import profiling

    def per(device, reps):
        with profiling.span("cost.request", device):   # as in a request
            t = time.perf_counter()
            for _ in range(reps):
                with profiling.span("cost", device):
                    pass
            return (time.perf_counter() - t) / reps * 1e6

    out = {"off_us": per(dev, 100 * n)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_host_us"] = per(None, n)
        out["on_cuda_us"] = per(dev, n)
    profiling.records()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_cuda_pooled_us"] = per(dev, n)
    profiling.clear()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_report: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_ctx = time.perf_counter()
    import numpy as np

    import raytracer_tpu_torch as pt
    from raytracer_tpu_torch.utils import profiling

    gr, cg, U = pt.init_annulus_circulant(180, 63, 20.0)
    solver = pt.AnnulusSolver(gr, None, None, U, circulant=cg,
                              device="cuda")
    t_build = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    r = np.hypot(gr.x, gr.z)
    surface = np.flatnonzero(np.abs(r - pt.R) < 1e-6)
    receivers = np.sort(rng.choice(surface, 150, replace=False))
    deep = np.flatnonzero(r >= pt.R - 700.0)

    def request():
        t = time.perf_counter()
        solver.travel_time_table(rng.choice(deep, 32, replace=False),
                                 receivers, batch=8)
        return time.perf_counter() - t

    request()
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    setup = profiling.records().spans
    untraced = [request() for _ in range(args.requests)]

    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = [request() for _ in range(args.requests)]
    rec = profiling.records()
    device = device_and_host(prof)
    spans = [s for s in rec.spans if s.root is not None]
    roots = [s for s in spans if s.name == "table"]
    n = len(roots)
    lo = min(s.t0_ns for s in roots) * 1e-3
    hi = max(s.t1_ns for s in roots) * 1e-3
    rows = collections.defaultdict(lambda: collections.Counter())
    for s in spans:
        row = rows[s.name]
        row["spans"] += 1 / n
        row["host_ms"] += (s.t1_ns - s.t0_ns) * 1e-6 / n
        row["device_ms"] += (s.device_ms or 0.0) / n
        row["host_syncs"] += s.counts.get(profiling.HOST_SYNCS, 0) / n
    busy = 0.0
    for s, e in device:
        busy += max(0.0, min(e, hi) - max(s, lo))
    idle_total = 0.0
    for a, b in idle_gaps(device, lo, hi):
        rows[innermost(spans, (a + b) / 2)]["idle_ms"] += (b - a) * 1e-3 / n
        idle_total += (b - a) * 1e-3 / n
    builds = collections.Counter()
    by_id = {s.id: s for s in setup}
    for s in setup:
        p, nested = by_id.get(s.parent), False
        while p is not None:
            nested |= p.name == s.name
            p = by_id.get(p.parent)
        if not nested:
            builds[s.name] += (s.t1_ns - s.t0_ns) * 1e-9
    report = {
        "device": torch.cuda.get_device_name(),
        "torch": torch.__version__,
        "requests": n,
        "window_ms": (hi - lo) * 1e-3 / n,
        "busy_ms": busy * 1e-3 / n,
        "idle_ms": idle_total,
        "spans": {k: dict(v) for k, v in sorted(
            rows.items(), key=lambda kv: -kv[1]["device_ms"])},
        "setup_s": {"import_torch": T_TORCH - T_START,
                    "cuda_context": t_ctx - t0,
                    "build": t_build - t_ctx,
                    "first_request": t_first - t_build,
                    **{k: v for k, v in sorted(builds.items())}},
        "request_ms": {"untraced_median": statistics.median(untraced) * 1e3,
                       "traced_median": statistics.median(traced) * 1e3},
        "span_cost": span_cost(torch.device("cuda"), 2000),
    }
    print(f"{report['device']}, torch {report['torch']}, {n} requests")
    print(f"a request: window {report['window_ms']:.3f} ms, busy "
          f"{report['busy_ms']:.3f} ms, idle {report['idle_ms']:.3f} ms")
    print(f"{'span':<20}{'spans':>8}{'host ms':>10}{'device ms':>11}"
          f"{'idle ms':>9}{'syncs':>7}")
    for name, row in report["spans"].items():
        print(f"{name:<20}{row.get('spans', 0):>8.2f}"
              f"{row.get('host_ms', 0):>10.3f}{row.get('device_ms', 0):>11.3f}"
              f"{row.get('idle_ms', 0):>9.3f}{row.get('host_syncs', 0):>7.2f}")
    for k, v in report["setup_s"].items():
        print(f"setup {k:<22}{v:>10.4f} s")
    for k, v in {**report["request_ms"], **report["span_cost"]}.items():
        print(f"{k:<28}{v:>10.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
