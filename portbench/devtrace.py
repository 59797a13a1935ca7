"""The traced run's device timeline, from torch.profiler.

`profile(...)` profiles the host and, on a card, the device; events stay
in memory and nothing is written to disk.  `read(prof)` turns them into a
`Timeline`: the device's operations (kernels, copies, fills), the host's
operations, and the benchmark's marks (`portbench.<span>`), all as
(name, start, end) in microseconds on the profiler's one clock.  The
readers under `metrics/` and the breakdown take their numbers from it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, NamedTuple, Tuple

import numpy as np

MARK = "portbench."
Interval = Tuple[str, float, float]


class Timeline(NamedTuple):
    device: List[Interval]
    host: List[Interval]
    marks: List[Interval]


def profile(cuda: bool, warmup: int, active: int, on_ready):
    """A profiler that, stepped once a request, discards the first
    `warmup` requests (they take the tracer's own start-up) and hands
    the next `active` to `on_ready(prof)`."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=on_ready,
        schedule=torch.profiler.schedule(wait=0, warmup=warmup,
                                         active=active, repeat=1))


def read(prof) -> Timeline:
    """The raw events of a stopped profiler (no call tree is built)."""
    from torch.autograd import DeviceType

    device, host, marks = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0, t1 = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        annotation = e.is_user_annotation() or "annotation" in str(
            e.activity_type() if hasattr(e, "activity_type") else "")
        if e.device_type() == DeviceType.CPU:
            if name.startswith(MARK):
                marks.append((name[len(MARK):], t0, t1))
            elif not annotation:
                host.append((name, t0, t1))
        elif not annotation and not name.startswith(MARK):
            device.append((name, t0, t1))
    return Timeline(device, host, marks)


def merged(intervals, lo: float, hi: float) -> np.ndarray:
    """(k, 2) union of the intervals' [start, end], clipped to [lo, hi]."""
    if not intervals:
        return np.zeros((0, 2))
    a = np.array([(s, e) for _, s, e in intervals], np.float64)
    a = np.clip(a, lo, hi)
    a = a[a[:, 1] > a[:, 0]]
    if len(a) == 0:
        return np.zeros((0, 2))
    a = a[np.argsort(a[:, 0])]
    ends = np.maximum.accumulate(a[:, 1])
    new = np.ones(len(a), bool)
    new[1:] = a[1:, 0] > ends[:-1]
    starts = a[new, 0]
    group = np.cumsum(new) - 1
    stops = np.zeros(len(starts))
    np.maximum.at(stops, group, ends)
    return np.stack([starts, stops], axis=1)


def busy_us(tl: Timeline, lo: float, hi: float) -> float:
    u = merged(tl.device, lo, hi)
    return float((u[:, 1] - u[:, 0]).sum())


def spans_of(tl: Timeline, name: str) -> List[Tuple[float, float]]:
    return [(s, e) for n, s, e in tl.marks if n == name]


def window(tl: Timeline) -> Tuple[float, float]:
    """The traced requests' extent."""
    req = spans_of(tl, "request")
    return (min(s for s, _ in req), max(e for _, e in req)) if req else (0, 0)


def device_ops(tl: Timeline, lo: float, hi: float, top: int = 10):
    """[name, seconds] of the device operations that took most time."""
    tot = defaultdict(float)
    for n, s, e in tl.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            tot[n[:160]] += d * 1e-6
    return sorted(([n, v] for n, v in tot.items()), key=lambda x: -x[1])[:top]


def _innermost(intervals, points: np.ndarray, outside: str):
    """For each point, the name of the innermost interval holding it
    (intervals nest, as one thread's calls do), else `outside`: a sweep
    over the intervals by start with a stack of the open ones."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][1], -intervals[i][2]))
    names = [outside] * len(points)
    stack, i = [], 0
    for p in np.argsort(points):
        t = points[p]
        while i < len(order) and intervals[order[i]][1] <= t:
            iv = intervals[order[i]]
            while stack and stack[-1][2] < iv[1]:
                stack.pop()
            stack.append(iv)
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        if stack:
            names[p] = stack[-1][0]
    return names


def idle_gaps(tl: Timeline, lo: float, hi: float, top: int = 10):
    """[name, seconds] of the device's idle time inside the window, by
    what the host was doing: the innermost benchmark span and the
    innermost host operation at the middle of each gap ("python" where
    none runs), summed by name."""
    u = merged(tl.device, lo, hi)
    edges = np.concatenate([[lo], u.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    if len(gaps) == 0:
        return []
    mid = gaps.mean(axis=1)
    stage = _innermost(tl.marks, mid, "outside")
    op = _innermost(tl.host, mid, "python")
    tot = defaultdict(float)
    for s, o, (a, b) in zip(stage, op, gaps):
        tot[f"{s}: {o}"[:160]] += float(b - a) * 1e-6
    return sorted(([n, v] for n, v in tot.items()), key=lambda x: -x[1])[:top]
