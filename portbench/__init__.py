"""The benchmark of `raytracer_tpu_torch`, the PyTorch and CUDA port, on
one NVIDIA H100.

One run of one cell (a configuration under a traffic mix, named in the
repo root's BENCHMARK.json):

    python3 portbench/run.py --workload annulus180x63.table --seed 7 \
        --seconds 10 --trace 0

prints one JSON line: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` a `breakdown` of device time and idle gaps,
and last `checks`, each compared number beside its limit.

Layout (a new cell, configuration, mix or metric is new files):
- `run.py`: the command; refuses without a card and if JAX was loaded.
- `harness.py`: set-up, warm-up, the closed loop, the check, the line.
- `traffic.py` and `traffic/<mix>.json`: the one request generator and
  the mixes' parameters.
- `configs/<config>.json`: the deployments; `systems/<geometry>.py`: the
  program's public calls for a geometry.
- `reference/`: the plain reference (the upstream graph built again,
  exact float64 shortest paths) and `check.py`, the comparison that
  decides `correct`; `limits/<cell>.json`: each number's limit.
- `spans.py`, `devtrace.py`, `work.py`, `metrics/<metric>.py`: spans and
  counters around the program's calls, the profiler's timeline, the
  least work of a solve with the card's published peaks, and one reader
  a per-layer metric.
- `control.py`: the control (the reference in bfloat16 in the program's
  place) and the program's readings on the same requests; never run by
  the benchmark's runs.
- `tests/`: CPU tests at tiny sizes (`python -m pytest portbench/tests`),
  and card tests marked `card`.
Nothing here imports JAX or the JAX package `raytracer_tpu`, and the
reference imports nothing of the port.
"""
