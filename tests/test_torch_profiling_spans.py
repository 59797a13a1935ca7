"""The port's own spans and counters (`raytracer_tpu_torch.utils.profiling`):
off they record nothing, on they tile the sweep round, `host_syncs`
counts the solve's blocking calls, a span shares the profiler's clock,
set-up spans record without a profiler, and tracing changes no answer.

CPU tests on the 24x12 annulus.  The tests marked `card` run where torch
sees a CUDA device and skip elsewhere; this file imports no JAX, so on
the card (which has none) it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_profiling_spans.py
"""
import collections
import math
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raytracer_tpu_torch as pt
from raytracer_tpu_torch.ops.sweep_theta import device_tables
from raytracer_tpu_torch.utils import profiling

ROUND_CHILDREN = collections.Counter({
    "sweep.fan": 1, "sweep.layout": 4, "sweep.rsweep": 2,
    "sweep.ring_chain": 2, "sweep.hscan": 2, "sweep.seamfix": 1,
    "sweep.converged": 1})
SOURCES = np.array([0, 40, 200])
BATCH = 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="module")
def annulus():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    gr, cg, U = pt.init_annulus_circulant(24, 12, 250.0)
    solver = pt.AnnulusSolver(gr, None, None, U, method="sweep",
                              circulant=cg, device="cpu")
    receivers = np.arange(0, gr.nnods, 7)
    plain = solver.travel_time_table(SOURCES, receivers, batch=BATCH)
    yield solver, receivers, plain
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced(annulus):
    """One table under a CPU profiler: (table, records, the profiler's
    events as {name: [(start_ns, end_ns)]})."""
    solver, receivers, _ = annulus
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        table = solver.travel_time_table(SOURCES, receivers, batch=BATCH)
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append((e.start_ns(), e.end_ns()))
    return table, profiling.records(), events


def request_spans(rec):
    return [s for s in rec.spans if s.root is not None]


def test_off_records_nothing_and_enters_no_record_function(annulus,
                                                           monkeypatch):
    solver, receivers, plain = annulus

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    profiling.clear()
    monkeypatch.setattr(profiling, "_record_function", refuse)
    got = solver.travel_time_table(SOURCES, receivers, batch=BATCH)
    rec = profiling.records()
    assert rec.spans == [] and rec.counts == {}
    np.testing.assert_array_equal(got, plain)
    # the off path is one shared null context
    assert profiling.span("table") is profiling.span("sweep.round", "cpu")


def test_on_a_table_root_holds_rounds_their_children_tile(traced):
    _, rec, _ = traced
    spans = request_spans(rec)
    roots = [s for s in spans if s.name == "table"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.root == root.id
    assert all(s.root == root.id for s in spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s is not root:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns, (s, p)
    chunks = math.ceil(len(SOURCES) / BATCH)
    names = collections.Counter(s.name for s in spans)
    for name in ("sweep.chunk_setup", "extract", "copy_out"):
        assert names[name] == chunks
    rounds = [s for s in spans if s.name == "sweep.round"]
    assert len(rounds) >= chunks
    for r in rounds:
        kids = sorted((s for s in spans if s.parent == r.id),
                      key=lambda s: s.t0_ns)
        assert collections.Counter(s.name for s in kids) == ROUND_CHILDREN
        assert [s.name for s in kids][0] == "sweep.fan"
        assert [s.name for s in kids][-1] == "sweep.converged"
        for a, b in zip(kids, kids[1:]):
            assert a.t1_ns <= b.t0_ns
    # the settle after each chunk's last round
    assert names["sweep.fan"] == len(rounds) + chunks
    assert all(s.device_ms is None for s in spans)


def test_host_syncs_equal_the_call_sites_of_the_solve(annulus, traced):
    """tol once a call; a chunk's source field (a write a source), its
    seam plan (two index tensors a kernel-blind boundary, one shift table
    a dc group), its extraction's +inf and its copy to the host; one
    changed-flag read a round."""
    solver = annulus[0]
    _, rec, _ = traced
    ws = solver._packed(sweep=True)
    _, static, _, _, rst = device_tables(ws, solver.circulant,
                                         np.dtype(solver.config.dtype), "cpu")
    bounds = 1 + sum(1 for k in range(1, rst.NTL // rst.NTB)
                     if k * rst.NTB < static.nt)
    seam = 2 * bounds + len(static.dms)
    spans = request_spans(rec)
    rounds = sum(s.name == "sweep.round" for s in spans)
    chunks = math.ceil(len(SOURCES) / BATCH)
    # the last chunk is padded to BATCH sources
    setup = chunks * (BATCH + seam)
    want = 1 + setup + chunks * 2 + rounds
    assert rec.counts == {profiling.HOST_SYNCS: want}
    under = collections.defaultdict(int)
    for s in spans:
        if profiling.HOST_SYNCS in s.counts:
            under[s.name] += s.counts[profiling.HOST_SYNCS]
    assert dict(under) == {"table": 1, "sweep.chunk_setup": setup,
                           "extract": chunks, "copy_out": chunks,
                           "sweep.converged": rounds}


def test_a_span_encloses_its_record_function_event(traced):
    """The spans' `time.time_ns()` is the profiler's own clock: each span
    holds the profiler's event of the same name."""
    _, rec, events = traced
    spans = collections.defaultdict(list)
    for s in request_spans(rec):
        spans[s.name].append((s.t0_ns, s.t1_ns))
    assert set(spans) <= set(events)
    for name, got in spans.items():
        ev = sorted(events[name])
        assert len(ev) == len(got), name
        for (t0, t1), (e0, e1) in zip(sorted(got), ev):
            assert t0 <= e0 <= e1 <= t1, (name, t0, e0, e1, t1)


def test_build_spans_record_with_no_profiler():
    profiling.clear()
    gr, cg, U = pt.init_annulus_circulant(24, 12, 250.0)
    solver = pt.AnnulusSolver(gr, None, None, U, method="sweep",
                              circulant=cg, device="cpu")
    solver.travel_time_table([0], [1, 2], batch=1)
    first = profiling.records().spans
    assert all(s.root is None and s.name.startswith(profiling.BUILD)
               for s in first)
    names = collections.Counter(s.name for s in first)
    for name in ("build.grid", "build.velocity", "build.solver",
                 "build.stencil", "build.sweep_tables"):
        assert names[name] >= 1, name
    grid = next(s for s in first if s.name == "build.grid")
    assert all(s.parent == grid.id for s in first
               if s.name == "build.velocity")
    # the builders' caches hit: no more set-up spans
    solver.travel_time_table([3], [1, 2], batch=1)
    assert len(profiling.records().spans) == len(first)
    with pytest.raises(ValueError, match="build"):
        profiling.setup_span("table")


def test_traced_and_untraced_tables_are_bit_equal(annulus, traced):
    np.testing.assert_array_equal(traced[0], annulus[2])


def test_counts_outside_a_profiler_are_dropped_and_inside_kept():
    profiling.clear()
    profiling.count("x")
    assert profiling.records().counts == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("x", 3)
        with profiling.span("outer"):
            profiling.count("x")
    rec = profiling.records()
    assert rec.counts == {"x": 4}
    assert [s.counts for s in rec.spans] == [{"x": 1}]


# ------------------------------------------------------------- the card


@pytest.fixture(scope="module")
def card_annulus():
    """The AK135 annulus at 180x63, 20 km spacing, on the card, warmed
    up: 32 sources and 150 receivers a table, in batches of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gr, cg, U = pt.init_annulus_circulant(180, 63, 20.0)
    solver = pt.AnnulusSolver(gr, None, None, U, circulant=cg,
                              device="cuda")
    rng = np.random.default_rng(7)
    sources = rng.choice(gr.nnods - 1, size=32, replace=False)
    receivers = np.sort(rng.choice(gr.nnods - 1, size=150, replace=False))
    solver.travel_time_table(sources, receivers, batch=8)
    torch.cuda.synchronize()
    # the first switch to "warn" reports one sync of its own
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    return solver, sources, receivers


def card_traced_table(solver, sources, receivers):
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                solver.travel_time_table(sources, receivers, batch=8)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    syncs = collections.Counter(
        f"{w.filename}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return profiling.records(), syncs


@pytest.mark.card
def test_host_syncs_equal_the_sync_debug_count(card, card_annulus):
    solver, sources, receivers = card_annulus
    assert solver.method == "sweep"
    rec, syncs = card_traced_table(solver, sources, receivers)
    assert syncs
    counted = collections.Counter()
    for s in rec.spans:
        counted[s.name] += s.counts.get(profiling.HOST_SYNCS, 0)
    assert rec.counts == {profiling.HOST_SYNCS: sum(syncs.values())}, (
        syncs, counted)


@pytest.mark.card
def test_round_children_tile_the_round_on_the_card(card, card_annulus):
    """Each round's children's device extents sum to within 2 % of the
    round's; the rounds, the settles, the chunk set-ups, extractions and
    copies to within 5 % of the table's."""
    solver, sources, receivers = card_annulus
    rec, _ = card_traced_table(solver, sources, receivers)
    spans = request_spans(rec)
    assert all(s.device_ms is not None for s in spans)
    (root,) = [s for s in spans if s.name == "table"]
    parent = {s.id: s.name for s in spans}
    for r in (s for s in spans if s.name == "sweep.round"):
        kids = sum(s.device_ms for s in spans if s.parent == r.id)
        assert abs(kids - r.device_ms) <= 0.02 * r.device_ms, (kids, r)
    steps = sum(s.device_ms for s in spans
                if parent.get(s.parent) == "sweep.round"
                or s.name == "sweep.fan")
    rest = sum(s.device_ms for s in spans
               if s.name in ("sweep.chunk_setup", "extract", "copy_out"))
    want = root.device_ms - rest
    assert abs(steps - want) <= 0.05 * want, (steps, root.device_ms, rest)
