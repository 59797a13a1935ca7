"""The harness is driven by data: a new configuration, traffic mix and
per-layer metric are new files plus new BENCHMARK.json entries, and no
file already there changes."""
import hashlib
import json
import os

from portbench import harness
from portbench.tests.tiny import make_root

METRIC = '''"""dummy_checked.table: the solves counted in the window."""


def read(run):
    return float(len(run.rec.counters["solver_iters"]))
'''


def digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(d, f)
            out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_config_mix_and_metric_are_new_files(tmp_path, one_thread):
    root = make_root(str(tmp_path))
    before = digests(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny_annulus.json")) as f:
        cfg = json.load(f)
    cfg.update(name="dummy_annulus", ntheta=12, nr=3, spacing_km=500.0)
    new = {
        "configs/dummy_annulus.json": json.dumps(cfg),
        "traffic/dummy_mix.json": json.dumps({
            "events_per_request": 3,
            "event_depth_km": [0.0, 100.0], "stratify": 3,
            "stations": {"kind": "surface", "count": 5}, "batch": 2,
            "warmup_requests": 1, "check_requests": 1, "check_sources": 3,
            "trace_skip": 0, "traced_requests": 1}),
        "limits/dummy.cell.json": json.dumps({"time_gap_s": 0.05}),
        "metrics/dummy_checked.table.py": METRIC,
    }
    for rel, text in new.items():
        with open(os.path.join(pb, rel), "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy_annulus", "source": "tests",
                             "file": "portbench/configs/dummy_annulus.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_annulus",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "dummy_checked.table",
                               "unit": "answers", "better": "higher",
                               "source": "program_counter", "layer": "tests",
                               "moves": "sources_per_s",
                               "workloads": ["dummy.cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = digests(root)
    assert all(after[p] == h for p, h in before.items())

    r = harness.run_cell(root, "dummy.cell", 2**31 + 99, 0.2, 1,
                         device="cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["dummy_checked.table"]["value"] >= 1
    assert set(r["checks"]) == {"time_gap_s"}
