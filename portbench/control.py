"""The control of `correct`, and the readings its limits are set from.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--program]

For each seed it takes the requests a run of that cell draws (the first
`check_requests` of the window's stream; a table's rows sampled as a run
samples them) and compares with the float64 reference:
- the control: the reference itself put in the program's place, computed
  in bfloat16, the precision below the configuration's float32;
- with `--program`, the program's own answers to the same requests (the
  lower readings, read in one process).
It prints one JSON line per seed.  The benchmark's runs never run it; it
runs on the card, or with `--device cpu` at test sizes (`--root`).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def requests_of(c, system, seed):
    from portbench import traffic

    gen = traffic.Traffic(c.mix, c.config, system, seed).window()
    return [next(gen) for _ in range(c.mix["check_requests"])]


def table_rows(c, seed, n_sources):
    """The rows a run's check samples, for a run whose reservoir kept
    these requests (the same stream, drawn after the reservoir's)."""
    from portbench import traffic

    rng = traffic.stream(seed, traffic.CHECK)
    parts = np.array_split(np.arange(n_sources), c.mix["check_sources"])
    return np.array([int(rng.choice(p)) for p in parts if len(p)])


def control_answer(c, ref, req, m, seed):
    """The bfloat16 reference's answer to `req`, in the reference's
    order, and the sources it answers for."""
    import torch

    srcs = m[np.asarray(req.sources)]
    rows = table_rows(c, seed, len(srcs))
    Tb, _ = ref.solve(srcs[rows], dtype=torch.bfloat16)
    return (Tb.double().cpu().numpy()[:, m[np.asarray(req.receivers)]],
            srcs[rows])


def program_answer(c, system, req, m, seed, rec):
    """The program's answer in the reference's order."""
    out = system.table(req.sources, req.receivers, rec)
    srcs = m[np.asarray(req.sources)]
    rows = table_rows(c, seed, len(srcs))
    return np.asarray(out)[rows], srcs[rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness
    from portbench.reference import check
    from portbench.spans import Recorder

    c = harness.load_cell(args.root, args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    rec = Recorder(False, lambda: None)
    system = harness.load_module(args.root, "systems",
                                 c.config["geometry"]).System(
        c.config, c.mix, args.device, rec)
    ref = harness.load_module(args.root, "reference",
                              c.config["geometry"]).Reference(
        c.config, args.device)
    m, worst = check.node_map(ref, *system.node_keys())
    for seed in args.seeds:
        line = {"seed": seed, "match_km": worst}
        ctrl, prog = {}, {}
        for req in requests_of(c, system, seed):
            answer, srcs = control_answer(c, ref, req, m, seed)
            T, _ = ref.solve(srcs)
            T = T.cpu().numpy()
            rcv = m[np.asarray(req.receivers)]
            for k, v in check.table_numbers(T, answer, rcv).items():
                ctrl[k] = max(ctrl.get(k, 0.0), v)
            if args.program:
                got, _ = program_answer(c, system, req, m, seed, rec)
                for k, v in check.table_numbers(T, got, rcv).items():
                    prog[k] = max(prog.get(k, 0.0), v)
        line["control"] = {k: check.json_number(v) for k, v in ctrl.items()}
        if args.program:
            line["program"] = {k: check.json_number(v)
                               for k, v in prog.items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
