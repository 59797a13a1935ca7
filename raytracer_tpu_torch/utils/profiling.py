"""Profiling hooks: torch.profiler traces, the program's own spans and
counters, and per-iteration solver stats.

The port's counterpart of `raytracer_tpu/utils/profiling.py`:
  * `trace(log_dir)` wraps a block in `torch.profiler.profile` (CPU
    activity, and CUDA activity where a CUDA device is present) and
    writes a Chrome trace (chrome://tracing, Perfetto) into `log_dir`;
  * `span(name, device)` and `count(name, n)` mark the steps of a solve
    and count its host syncs where they happen (`AnnulusSolver.
    travel_time_table` opens a `table` span, the directional sweep a
    `sweep.round` span a round with one child span a step).  They record
    only while a torch profiler runs in the process: run any port call
    under `trace(...)`, or any `torch.profiler.profile` session, and the
    spans show in its Chrome trace under their own names, while
    `records()` returns them (start and end on the profiler's clock,
    `time.time_ns()`; device milliseconds between a CUDA event pair the
    span recorded on the current stream, resolved when `records()` is
    read; the counts kept under the innermost open span).  With no
    profiler a span is one flag read and a shared null context;
  * `setup_span(name)` marks a one-time builder (`build.*`: the grid,
    the stencil, the sweep tables, a kernel library) and records whether
    or not a profiler runs;
  * `iteration_stats` runs the circulant solver host-stepped, recording
    per-iteration frontier statistics (improved-node counts, max delta) -
    the structured equivalent of the reference's convergence printouts.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_SOLVER_CONFIG, SolverConfig
from ..ops.circulant import (CirculantGraph, CircState, _circ_step,
                             resolve_device)

# the counter of calls that block the host until the card drains its
# stream (`.item()`, `.cpu()`, a tensor built on the card from host data)
HOST_SYNCS = "host_syncs"
# the prefix of the set-up spans (`setup_span`)
BUILD = "build."
# spans kept; the oldest go first (a traced sweep request keeps ~270)
MAX_SPANS = 16384
MAX_SETUP_SPANS = 1024
# CUDA events a stream's pool holds when a request's outermost span opens
# (two a span; `records()` returns read events to the pool)
EVENT_POOL = 1024

# torch.profiler rebinds `_is_profiler_enabled` in this module while a
# profiler records (only in a schedule's active steps)
_torch_profiler = torch.autograd.profiler
# a span's event in the profiler's trace: the C++ context (~2 us under a
# profiler, against ~13 for `record_function`)
_record_function = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """One kept span: ids group a request (`root` is the id of its
    outermost span, None on a set-up span), times are `time.time_ns()`,
    the profiler's own clock."""

    name: str
    id: int
    parent: Optional[int]
    root: Optional[int]
    t0_ns: int
    t1_ns: int
    device_ms: Optional[float]   # None off the card
    counts: Dict[str, int]       # kept while this was the innermost span


class Records(NamedTuple):
    spans: List[Span]
    counts: Dict[str, int]       # every count since `clear()`


class _Open:
    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "events",
                 "device_ms", "counts", "rf")


class _Recorder(threading.local):
    def __init__(self):
        self.stack: List[_Open] = []


_local = _Recorder()
_ids = itertools.count()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_setup_spans: collections.deque = collections.deque(maxlen=MAX_SETUP_SPANS)
_counts: Dict[str, int] = {}
# per CUDA stream: (its Stream object, the pool of its spare events)
_streams: dict = {}


def _event(pool: list):
    return pool.pop() if pool else torch.cuda.Event(enable_timing=True)


def _current_stream(index: int):
    """(`torch.cuda.current_stream(index)`, its event pool); index -1 is
    the current device.  The Stream object is kept: made anew it costs
    ~6 us a call."""
    data = torch._C._cuda_getCurrentStream(index)
    got = _streams.get(data)
    if got is None:
        got = _streams[data] = (torch.cuda.Stream(
            stream_id=data[0], device_index=data[1], device_type=data[2]),
            [])
    return got


class _SpanContext(contextlib.ContextDecorator):
    """A span's context; as a decorator, each call is a span of its own."""

    def __init__(self, name: str, device, store):
        self._name, self._device, self._store = name, device, store

    def _recreate_cm(self):
        return _SpanContext(self._name, self._device, self._store)

    def __enter__(self):
        # the entry event first and the exit event last: the span's own
        # bookkeeping lies inside its device extent, and the gap between
        # two siblings' extents (the device idle while the host is
        # between them) stays a few microseconds
        stack = _local.stack
        events = None
        dev = self._device
        if dev is not None:
            if type(dev) is not torch.device:
                dev = torch.device(dev)
            if dev.type == "cuda":
                stream, pool = _current_stream(
                    dev.index if dev.index is not None else -1)
                if not stack:   # a request's events made up front
                    pool.extend(torch.cuda.Event(enable_timing=True)
                                for _ in range(EVENT_POOL - len(pool)))
                start = _event(pool)
                torch._C._CudaEventBase.record(start, stream)
                events = [start, None, stream, pool]
        parent = stack[-1] if stack else None
        s = _Open()
        s.name, s.id = self._name, next(_ids)
        s.parent = parent.id if parent is not None else None
        if self._store is _setup_spans:
            s.root = None
        elif parent is not None and parent.root is not None:
            s.root = parent.root
        else:
            s.root = s.id
        s.counts, s.device_ms, s.events = None, None, events
        s.t0 = time.time_ns()
        s.rf = _record_function(self._name)
        s.rf.__enter__()
        stack.append(s)
        self._open = s
        return self

    def __exit__(self, *exc):
        s = self._open
        _local.stack.pop()
        s.rf.__exit__(*exc)
        s.t1 = time.time_ns()
        if s.events is None:
            self._store.append(s)
        else:
            s.events[1] = end = _event(s.events[3])
            self._store.append(s)
            torch._C._CudaEventBase.record(end, s.events[2])
        return False


def span(name: str, device=None):
    """A span of the request path: `with span("sweep.round", v.device):`.
    Records only while a torch profiler runs in the process (else a
    shared null context after one flag read); on a CUDA `device` it also
    records a CUDA event pair on the current stream.  Never
    synchronizes."""
    if not _torch_profiler._is_profiler_enabled:
        return _NULL
    return _SpanContext(name, device, _spans)


def setup_span(name: str, when: bool = True):
    """A span of a one-time builder, named `build.*`, recorded whether or
    not a profiler runs; `when=False` (the builder's cache hit) is the
    shared null context.  Host time only.  Also a decorator
    (`@setup_span("build.grid")`): each call of the function is one."""
    if not when:
        return _NULL
    if not name.startswith(BUILD):
        raise ValueError(f"a set-up span is named {BUILD}*, not {name!r}")
    return _SpanContext(name, None, _setup_spans)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` under the innermost open span, while
    a torch profiler runs (else one flag read)."""
    if not _torch_profiler._is_profiler_enabled:
        return
    stack = _local.stack
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n
    _counts[name] = _counts.get(name, 0) + n


def records() -> Records:
    """The kept spans (set-up spans first, then the rest in the order they
    closed) and the counts.  Resolves the device milliseconds of the
    spans not yet read, after one synchronize of their devices."""
    kept = list(_setup_spans) + list(_spans)
    pending = [s for s in kept if s.events is not None]
    for dev in {s.events[2].device_index for s in pending}:
        torch.cuda.synchronize(dev)
    for s in pending:
        start, end, _, pool = s.events
        s.device_ms = start.elapsed_time(end)
        pool.extend((start, end))
        s.events = None
    return Records([Span(s.name, s.id, s.parent, s.root, s.t0, s.t1,
                         s.device_ms, dict(s.counts or {})) for s in kept],
                   dict(_counts))


def clear() -> None:
    """Forget the kept spans and counts (open spans are kept when they
    close)."""
    _spans.clear()
    _setup_spans.clear()
    _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: `with trace('/tmp/prof') as prof: solver.solve(...)`.

    Yields the `torch.profiler.profile`; on exit the Chrome trace is in
    `log_dir`, its path in `prof.trace_path`.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class IterationStat(NamedTuple):
    iteration: int
    improved_nodes: int
    max_delta: float


def iteration_stats(
    cg: CirculantGraph,
    source: int,
    config: SolverConfig = DEFAULT_SOLVER_CONFIG,
    max_iters: int = 10_000,
    device="cuda",
) -> List[IterationStat]:
    """Host-stepped circulant solve on `device` recording per-iteration
    statistics: one `ops/circulant._circ_step` a call, and its improved
    slots and largest decrease read back to the host.

    Slower than the solve loop (a host read per iteration); for debugging
    and analysis.  Stops at the first step that changes nothing, as
    `solve_circulant` does, so the list is as long as its iteration count.
    """
    device = resolve_device(device)
    dtype = getattr(torch, np.dtype(config.dtype).name)
    cmap = cg.cmap
    M, nt = cmap.M, cmap.ntheta

    dist = torch.full((M, nt), float("inf"), dtype=dtype, device=device)
    dcen = torch.tensor(float("inf"), dtype=dtype, device=device)
    if source == cmap.center:
        dcen = torch.zeros((), dtype=dtype, device=device)
    else:
        dist[int(cmap.m_of[source]), int(cmap.c_of[source])] = 0.0

    src_flat = torch.tensor(cg.src_flat.astype(np.int64), device=device)
    w = torch.tensor(cg.w, dtype=dtype, device=device)
    fan_slots = torch.tensor(cg.fan_slots.astype(np.int64), device=device)
    fan_w = torch.tensor(cg.fan_w, dtype=dtype, device=device)

    state = CircState(dist, dcen, True, 0)
    zero = torch.zeros((), dtype=dtype, device=device)
    stats: List[IterationStat] = []
    for it in range(max_iters):
        new = _circ_step(state, src_flat, w, fan_slots, fan_w)
        improved = int((new.dist < state.dist).sum())
        delta = float(torch.where(torch.isfinite(state.dist),
                                  state.dist - new.dist, zero).max())
        stats.append(IterationStat(it + 1, improved, delta))
        if not new.changed:
            break
        state = new
    return stats
