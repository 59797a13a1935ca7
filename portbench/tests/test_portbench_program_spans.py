"""The readers of the program's own spans and counters
(`metrics/_program.py` and the metrics that use it): their arithmetic on
synthetic records and a synthetic timeline, None where the program keeps
no records, and the tiny traced run on the CPU still printing its line."""
import os
from typing import NamedTuple, Optional

import pytest

from portbench import devtrace, harness
from portbench.metrics import _program

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NEW = ("host_syncs.table", "hscan_ms.table", "ring_chain_ms.table",
       "layout_ms.table", "rsweep_ms.table", "round_idle_ms.table",
       "lazy_build_s")


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    root: Optional[int]
    t0_ns: int
    t1_ns: int
    device_ms: Optional[float]
    counts: dict


class Records(NamedTuple):
    spans: list
    counts: dict


class Run(NamedTuple):
    timeline: Optional[devtrace.Timeline]


def us(t):
    return int(t * 1000)


def table(rid, t0, t1, device=True):
    """A table request from t0 to t1 (us): a round over its middle
    half, with an hscan (2 ms), an rsweep (1.5 ms), two layouts (0.25 ms
    each) and a ring_chain (1 ms) under it; 3 host syncs in the round,
    1 in the table."""
    ms = (lambda v: v) if device else (lambda v: None)
    q = (t1 - t0) / 4
    r0, r1 = t0 + q, t1 - q
    k = rid * 100
    return [
        Span("table", k, None, k, us(t0), us(t1), ms(8.0), {"host_syncs": 1}),
        Span("sweep.round", k + 1, k, k, us(r0), us(r1), ms(5.0),
             {"host_syncs": 3}),
        Span("sweep.hscan", k + 2, k + 1, k, us(r0), us(r0 + 1), ms(2.0), {}),
        Span("sweep.rsweep", k + 3, k + 1, k, us(r0 + 1), us(r0 + 2),
             ms(1.5), {}),
        Span("sweep.layout", k + 4, k + 1, k, us(r0 + 2), us(r0 + 3),
             ms(0.25), {}),
        Span("sweep.layout", k + 5, k + 1, k, us(r0 + 3), us(r0 + 4),
             ms(0.25), {}),
        Span("sweep.ring_chain", k + 6, k + 1, k, us(r0 + 4), us(r0 + 5),
             ms(1.0), {}),
    ]


def builds():
    """build.sweep_tables (2 s) holding build.kernel (0.5 s); a
    build.kernel of its own (0.25 s); build.stencil (1 s); build.grid
    (ignored)."""
    s = int(1e9)
    return [
        Span("build.kernel", 2, 1, None, 0, s // 2, None, {}),
        Span("build.sweep_tables", 1, None, None, 0, 2 * s, None, {}),
        Span("build.kernel", 3, None, None, 0, s // 4, None, {}),
        Span("build.stencil", 4, None, None, 0, s, None, {}),
        Span("build.grid", 5, None, None, 0, 7 * s, None, {}),
    ]


def timeline(device=True):
    """Requests traced from 1000 to 1200 us; the device busy in
    [1000, 1100] and [1130, 1200]: one idle gap, [1100, 1130]."""
    dev = [("k", 1000.0, 1100.0), ("k", 1130.0, 1200.0)] if device else []
    return devtrace.Timeline(dev, [], [("request", 1000.0, 1200.0)])


def read(name, run):
    return harness.load_module(ROOT, "metrics", name).read(run)


@pytest.fixture
def synthetic(monkeypatch):
    def use(spans):
        monkeypatch.setattr(_program, "records",
                            lambda: Records(spans, {}))
    return use


def test_each_metric_averages_over_the_tables_in_the_window(synthetic):
    # two tables in the window, one before it
    spans = (table(1, 1000, 1080) + table(2, 1100, 1180)
             + table(3, 100, 180) + builds())
    synthetic(spans)
    run = Run(timeline())
    assert read("host_syncs.table", run) == 4.0
    assert read("hscan_ms.table", run) == 2.0
    assert read("rsweep_ms.table", run) == 1.5
    assert read("layout_ms.table", run) == 0.5
    assert read("ring_chain_ms.table", run) == 1.0
    # the gap's midpoint, 1115 us, lies before table 2's round [1120,
    # 1160]: no idle inside a round
    assert read("round_idle_ms.table", run) == 0.0
    assert read("lazy_build_s", run) == pytest.approx(3.25)


def test_round_idle_counts_the_gaps_whose_midpoint_is_in_a_round(synthetic):
    # table 2's round is [1105, 1135]: the gap's midpoint 1115 is inside
    synthetic(table(1, 1000, 1080) + table(2, 1090, 1150))
    assert read("round_idle_ms.table", Run(timeline())) == pytest.approx(
        0.030 / 2)


def test_device_readings_are_none_on_a_cpu_run(synthetic):
    synthetic(table(1, 1000, 1080, device=False) + builds())
    run = Run(timeline(device=False))
    for name in ("hscan_ms.table", "rsweep_ms.table", "layout_ms.table",
                 "ring_chain_ms.table", "round_idle_ms.table"):
        assert read(name, run) is None, name
    assert read("host_syncs.table", run) == 4.0
    assert read("lazy_build_s", run) == pytest.approx(3.25)


def test_none_where_no_table_lies_in_the_window(synthetic):
    synthetic(table(3, 100, 180))
    for name in NEW[:-1]:
        assert read(name, Run(timeline())) is None, name
        assert read(name, Run(None)) is None, name
    assert read("lazy_build_s", Run(timeline())) is None


def test_none_on_a_program_without_records(monkeypatch):
    """The parent commit's program: `utils.profiling` has no
    `records()`."""
    import raytracer_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "records")
    assert _program.records() is None
    for name in NEW:
        assert read(name, Run(timeline())) is None, name


def test_the_tiny_traced_run_prints_its_line(tiny_root, one_thread):
    r = harness.run_cell(tiny_root, "tiny.table", 2**31 + 77, 0.2, 1,
                         device="cpu")
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["host_syncs.table"]["unit"] == "syncs"
    assert m["host_syncs.table"]["value"] > 0
    assert m["lazy_build_s"]["value"] > 0
    # no device on the CPU: the device readings are left out
    assert not {"hscan_ms.table", "round_idle_ms.table"} & set(m)
