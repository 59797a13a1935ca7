"""The harness: one run of one cell, from `BENCHMARK.json` and the files
it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is found by name under `<root>/portbench/`:
- `configs/<config>.json`: the deployment (its `geometry` picks the
  program's adapter `systems/<geometry>.py` and the plain reference
  `reference/<geometry>.py`);
- `traffic/<mix>.json`: the parameters `traffic.py` draws requests from;
- `limits/<cell>.json`: each compared number's limit;
- `metrics/<metric>.py`: a reader `read(run)` of one per-layer metric,
  which returns None where it finds nothing to read.
A later cell, configuration or metric is new files and new entries, and
no edit here.

A run: set-up (the program's build, the warm-up requests, the window's
first block of requests) -> a closed loop of one client for `seconds`,
closing at the last completion -> the device's peak memory -> the
program freed -> a sample of the window's answers, drawn from the seed,
compared with the reference (`reference/check.py`) -> one JSON line.  `--trace 1` adds synchronized
spans to every request, profiles a fixed number of them and reports the
per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np

from . import devtrace, traffic, work
from .spans import Recorder

BENCH_DIR = "portbench"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """`<root>/portbench/<kind>/<name>.py` as a module of this package."""
    path = os.path.join(root, BENCH_DIR, kind, name + ".py")
    modname = f"{__package__}.{kind}.{name.replace('.', '__')}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    root: str
    bench: dict
    cell: dict
    config: dict
    mix: dict
    limits: dict


def load_cell(root: str, workload: str) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    d = os.path.join(root, BENCH_DIR)
    return Cell(root, bench, cell,
                load_json(os.path.join(d, "configs", cell["config"] + ".json")),
                load_json(os.path.join(d, "traffic", cell["traffic"] + ".json")),
                load_json(os.path.join(d, "limits", workload + ".json")))


class Run(NamedTuple):
    """What a per-layer reader reads."""
    mix: dict
    rec: Recorder               # spans (traced run) and counters
    setup: dict                 # build_s
    timeline: Optional[devtrace.Timeline]
    least_solve_s: Optional[float]   # work.py's least time of one solve


class Reservoir:
    """A uniform sample of k of the window's answers, drawn from the
    seed as they complete."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


def _applies(entry: dict, cell_name: str) -> bool:
    return cell_name in entry.get("workloads", [cell_name])


def check_sample(c: Cell, kept, node_keys, rng, device):
    """(the widest gap of each compared number over the kept answers,
    the reference); +inf where the program's nodes do not match the
    reference's or nothing was kept."""
    import torch

    from .reference import check

    ref = load_module(c.root, "reference", c.config["geometry"]).Reference(
        c.config, device)
    m, worst_km = check.node_map(ref, *node_keys)
    if not math.isfinite(worst_km) or not kept:
        return {k: math.inf for k in c.limits}, ref
    nums = {k: 0.0 for k in c.limits}
    for req, out in kept:
        srcs = m[np.asarray(req.sources)]
        rcv = m[np.asarray(req.receivers)]
        parts = np.array_split(np.arange(len(srcs)), c.mix["check_sources"])
        rows = np.array([int(rng.choice(p)) for p in parts if len(p)])
        T, _ = ref.solve(srcs[rows])
        got = check.table_numbers(T.cpu().numpy(), np.asarray(out)[rows],
                                  rcv)
        for k in nums:
            nums[k] = max(nums[k], got.get(k, math.inf))
        del T
        if device != "cpu":
            torch.cuda.empty_cache()
    return nums, ref


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: int, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object (without printing).
    `t_start` is the process's start on `time.perf_counter`'s clock."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = load_cell(root, workload)
    mix, cfg = c.mix, c.config
    import torch

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    traced = bool(trace)
    rec = Recorder(traced, sync)
    marks = [("torch", time.perf_counter())]
    torch.zeros(1, device=device)
    sync()
    marks.append(("device", time.perf_counter()))

    system = load_module(root, "systems", cfg["geometry"]).System(
        cfg, mix, device, rec)
    sync()
    marks.append(("build", time.perf_counter()))
    tr = traffic.Traffic(mix, cfg, system, seed)
    for req in tr.requests(traffic.stream(seed, traffic.WARMUP),
                           mix["warmup_requests"]):
        system.table(req.sources, req.receivers, rec)
    sync()
    marks.append(("warmup", time.perf_counter()))
    setup = {"build_s": marks[2][1] - marks[1][1]}
    rec.counters.clear()
    timeline = {}
    prof = None
    gc.collect()
    gc.freeze()

    keep = Reservoir(mix["check_requests"],
                     traffic.stream(seed, traffic.CHECK))
    lat, errors = [], []
    attempted = failed = sources = 0
    gen = tr.window()
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    deadline = t_win + seconds
    t_end = t_last = t_win
    traced_from = None
    # a traced run, its window over, profiles `trace_skip` requests (the
    # tracer's start-up) and then `traced_requests` more
    while True:
        if prof is None and time.perf_counter() >= deadline:
            if not traced or traced_from is not None:
                break
            traced_from = attempted
            rec.collect = False
            prof = devtrace.profile(
                cuda, mix["trace_skip"], mix["traced_requests"],
                lambda p: timeline.setdefault("t", devtrace.read(p)))
            prof.__enter__()
        req = next(gen)
        rec.request = attempted
        attempted += 1
        t = time.perf_counter()
        try:
            with rec.span("request"):
                out = system.table(req.sources, req.receivers, rec)
        except Exception as e:   # an answer that never comes
            failed += 1
            errors.append(repr(e)[:300])
            continue
        finally:
            t_end = time.perf_counter()
            if prof is not None:
                prof.step()
                if attempted - traced_from >= (mix["trace_skip"]
                                               + mix["traced_requests"]):
                    prof.__exit__(None, None, None)
                    prof = None
        if traced_from is None:
            lat.append(t_end - t)
            sources += len(req.sources)
            t_last = t_end
        keep.offer((req, out))
    window_s = t_last - t_win
    sync()
    gc.unfreeze()
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    node_keys = system.node_keys()
    del system, tr, gen
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    nums, ref = check_sample(c, keep.items, node_keys, keep.rng, device)
    from .reference.check import json_number

    correct = failed == 0 and len(keep.items) > 0 and all(
        nums[k] <= c.limits[k] for k in c.limits)

    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": memory_peak}
    metrics = {}
    if not traced:
        values = {"setup_s": setup_s}
        if lat:
            values["request_ms"] = window_s / len(lat) * 1e3
            values["request_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
            values["sources_per_s"] = sources / window_s
        for m in c.bench["end_to_end"]:
            if _applies(m, workload) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        timeline = timeline.get("t")
        nodes, edges = ref.problem_size()
        S = int(mix["events_per_request"])
        least = work.least_work(nodes, edges, S,
                                S * int(mix["stations"]["count"]),
                                cfg["dtype"])
        run = Run(mix, rec, setup, timeline, least.seconds)
        for m in c.bench["per_layer"]:
            if not _applies(m, workload):
                continue
            v = load_module(root, "metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if timeline is not None and timeline.device:
            lo, hi = devtrace.window(timeline)
            device_info["busy_s"] = devtrace.busy_us(timeline, lo, hi) * 1e-6
            device_info["window_s"] = (hi - lo) * 1e-6
            result["breakdown"] = {
                "device_ops": devtrace.device_ops(timeline, lo, hi),
                "idle_gaps": devtrace.idle_gaps(timeline, lo, hi)}
        if cuda:
            device_info["power_limit_w"] = power_limit()
    result["metrics"] = metrics
    result["device"] = device_info
    result["setup"] = {name: t - prev for (name, t), (_, prev) in
                       zip(marks, [("start", t_start)] + marks[:-1])}
    iters = rec.counters.get("solver_iters", [])
    result["window"] = {"seconds": window_s, "completed": len(lat),
                        "latency_ms_quartiles": (
                            [q * 1e3 for q in np.percentile(lat, [25, 50, 75])]
                            if lat else None),
                        "solver_iters_mean": (float(np.mean(iters))
                                              if iters else None),
                        "sources": sources,
                        "checked": len(keep.items), "errors": errors[:3]}
    result["checks"] = {k: {"value": json_number(nums[k]),
                            "limit": c.limits[k]} for k in c.limits}
    return result


def power_limit() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
