"""Helpers of the readers of the program's own spans and counters: the
port's `raytracer_tpu_torch.utils.profiling.records()`, read after the
run.  Each returns None where the program keeps no such records (a
program without the API, or none of the named spans) and, for a device
reading, where the run had no device (a CPU run)."""
from __future__ import annotations

import importlib

import numpy as np

from portbench import devtrace

# the set-up spans `lazy_build_s` sums (the builders that run in the
# first request, not in the program's build)
LAZY_BUILDS = ("build.stencil", "build.sweep_tables", "build.kernel")


def records():
    """The program's records, or None where it has no `records()`."""
    try:
        profiling = importlib.import_module(
            "raytracer_tpu_torch.utils.profiling")
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    return read() if read is not None else None


def table_spans(run):
    """(the `table` roots inside the traced window, the spans under
    them), or None."""
    tl = run.timeline
    rec = records()
    if tl is None or rec is None:
        return None
    lo, hi = devtrace.window(tl)
    if hi <= lo:
        return None
    roots = [s for s in rec.spans if s.name == "table" and s.root == s.id
             and lo <= s.t0_ns * 1e-3 and s.t1_ns * 1e-3 <= hi]
    if not roots:
        return None
    ids = {r.id for r in roots}
    return roots, [s for s in rec.spans if s.root in ids]


def per_table_count(run, name: str):
    """The counter `name` kept under the traced tables, a table."""
    got = table_spans(run)
    if got is None:
        return None
    roots, under = got
    return sum(s.counts.get(name, 0) for s in under) / len(roots)


def per_table_device_ms(run, name: str):
    """The device milliseconds of the spans `name` under the traced
    tables (each from its entry event to its exit event, in stream
    order), a table."""
    got = table_spans(run)
    if got is None:
        return None
    roots, under = got
    ms = [s.device_ms for s in under if s.name == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(roots)


def per_table_idle_ms(run, name: str):
    """The device's idle time whose gap midpoint falls, on the shared
    clock, while the host is inside a span `name` under the traced
    tables (or one of its children), in ms a table."""
    got = table_spans(run)
    tl = run.timeline
    if got is None or not tl.device:
        return None
    roots, under = got
    spans = sorted((s.t0_ns * 1e-3, s.t1_ns * 1e-3) for s in under
                   if s.name == name)
    if not spans:
        return None
    lo, hi = devtrace.window(tl)
    busy = devtrace.merged(tl.device, lo, hi)
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    if len(gaps) == 0:
        return 0.0
    mid = gaps.mean(axis=1)
    starts = np.array([a for a, _ in spans])
    ends = np.array([b for _, b in spans])
    k = np.searchsorted(starts, mid, side="right") - 1
    inside = (k >= 0) & (mid <= ends[np.maximum(k, 0)])
    idle_us = float((gaps[:, 1] - gaps[:, 0])[inside].sum())
    return idle_us * 1e-3 / len(roots)


def lazy_build_s():
    """Seconds of the outermost `LAZY_BUILDS` spans (one nested in
    another is counted once, in the outer one)."""
    rec = records()
    if rec is None:
        return None
    by_id = {s.id: s for s in rec.spans}

    def nested(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name in LAZY_BUILDS:
                return True
            p = by_id.get(p.parent)
        return False

    top = [s for s in rec.spans if s.name in LAZY_BUILDS and not nested(s)]
    if not top:
        return None
    return sum(s.t1_ns - s.t0_ns for s in top) * 1e-9
