"""Helpers the per-layer readers share."""
from __future__ import annotations

from portbench import devtrace


def mean(values):
    values = [float(v) for v in values if v is not None]
    return sum(values) / len(values) if values else None


def idle_pct(run):
    tl = run.timeline
    if tl is None or not tl.device:
        return None
    lo, hi = devtrace.window(tl)
    if hi <= lo:
        return None
    return 100.0 * (1.0 - devtrace.busy_us(tl, lo, hi) / (hi - lo))


def solve_roofline_pct(run):
    """The least time of the traced solves (work.py) over the device's
    busy time inside their `solve` spans."""
    tl = run.timeline
    if tl is None or not tl.device or not run.least_solve_s:
        return None
    spans = devtrace.spans_of(tl, "solve")
    busy = sum(devtrace.busy_us(tl, lo, hi) for lo, hi in spans) * 1e-6
    if busy <= 0:
        return None
    return 100.0 * len(spans) * run.least_solve_s / busy
