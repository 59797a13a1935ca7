"""Spans and counters the benchmark records around its calls into the
program.

In an untraced run a span costs nothing and times nothing: the request's
own latency is taken by the harness.  In a traced run a span
synchronizes the device on entry and exit, so that it holds the device
work of the calls inside it, marks the profiler's timeline with
`portbench.<name>` (the readers align device time to it), and, while
`collect` is set (not while the profiler runs), keeps (name, request,
start, end) on the host's clock in nanoseconds.  Counters (`count`) are
kept in both runs.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, NamedTuple


class Span(NamedTuple):
    name: str
    request: int
    t0_ns: int
    t1_ns: int

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


class Recorder:
    def __init__(self, traced: bool, sync: Callable[[], None]):
        self.traced = traced
        self.sync = sync
        self.spans: list = []
        self.counters = defaultdict(list)
        self.request = -1
        self.collect = True

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        from torch.profiler import record_function

        self.sync()
        t0 = time.perf_counter_ns()
        with record_function("portbench." + name):
            yield
            self.sync()
        if self.collect:
            self.spans.append(Span(name, self.request, t0,
                                   time.perf_counter_ns()))

    def count(self, name: str, value) -> None:
        self.counters[name].append(value)

    def durations(self, name: str) -> list:
        return [s.seconds for s in self.spans if s.name == name]
