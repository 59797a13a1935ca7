"""On the card: every cell of BENCHMARK.json runs briefly through the
command and comes out correct with the result line's keys.  Skipped
where torch sees no CUDA device."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          cell, "--seed", str(2**31 + 31337), "--seconds",
                          "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(r)
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
