"""Lightweight section timing (a copy of `raytracer_tpu/utils/timing.py`),
in the spirit of the reference's TimerOutputs instrumentation."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Timer:
    """Accumulates wall-clock per named section; prints a summary table."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'section':<24}{'calls':>8}{'total s':>12}{'avg ms':>12}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, cnt = self.totals[name], self.counts[name]
            lines.append(f"{name:<24}{cnt:>8}{tot:>12.4f}{1e3 * tot / cnt:>12.3f}")
        return "\n".join(lines)
