"""What the benchmark loads: never JAX nor the JAX package (top-level
module names compared whole, so the port `raytracer_tpu_torch` passes),
nothing of the port in the reference, nothing from `benchmarks/`; and
without a card the command refuses and prints no result."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = set(run.FORBIDDEN)


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if "tests" in d.split(os.sep) or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    assert "raytracer_tpu_torch".split(".")[0] not in FORBIDDEN
    for path in sources():
        assert not set(top_level_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "raytracer_tpu_torch" not in set(top_level_imports(path)), path


def test_nothing_reads_the_jax_benchmarks():
    for path in sources():
        assert "benchmarks/" not in open(path).read(), path


def run_py(code, cwd=ROOT):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tiny_root):
    got = run_py(
        "import json, sys; sys.path.insert(0, '.');"
        "from portbench import harness;"
        f"r = harness.run_cell({tiny_root!r}, 'tiny.table', 2**31 + 5, 0.2,"
        " 1, device='cpu');"
        "print(json.dumps({'correct': r['correct'], 'mods': sorted({m.split('.')[0]"
        " for m in sys.modules})}))")
    assert got["correct"]
    assert not set(got["mods"]) & FORBIDDEN
    assert "raytracer_tpu_torch" in got["mods"]


def test_the_reference_runs_without_the_program():
    got = run_py(
        "import json, sys; sys.path.insert(0, '.');"
        "from portbench.reference import annulus;"
        "cfg = json.load(open('portbench/configs/ak135_annulus_180x63.json'));"
        "cfg.update(ntheta=16, nr=4, spacing_km=400.0);"
        "annulus.Reference(cfg, 'cpu').solve([0]);"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "raytracer_tpu_torch" not in got
    assert not set(got) & FORBIDDEN


def test_without_a_card_the_command_refuses():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "annulus180x63.table", "--seed", str(2**31 + 1),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
