"""A benchmark root at test sizes: a copy of `portbench/` with tiny
configurations, their cells and limits, and a BENCHMARK.json naming
them, so that the harness runs end to end on the CPU in seconds."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

TINY_CONFIGS = {
    "tiny_annulus": {"ntheta": 16, "nr": 4, "spacing_km": 400.0,
                     "nodes": None},
}
BASE = {"tiny_annulus": "ak135_annulus_180x63"}
# tiny cell -> (tiny config, the traffic mix: (the mix file it starts
# from, what a tiny grid holds of it), the real cell whose limits it takes)
TINY_CELLS = {
    "tiny.table": ("tiny_annulus",
                   ("annulus_table", {"events_per_request": 4,
                                      "stratify": 4, "batch": 2,
                                      "stations": {"kind": "surface",
                                                   "count": 12},
                                      "check_sources": 4}),
                   "annulus180x63.table"),
}


def make_root(tmp: str, traffic_overrides=None) -> str:
    """A root under `tmp` holding BENCHMARK.json and portbench/ with the
    tiny cells; `traffic_overrides` updates every mix (e.g. fewer
    traced requests)."""
    dst = os.path.join(tmp, "portbench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = []
    for name, over in TINY_CONFIGS.items():
        with open(os.path.join(BENCH, "configs", BASE[name] + ".json")) as f:
            cfg = json.load(f)
        cfg.update(over, name=name)
        path = os.path.join(dst, "configs", name + ".json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": cfg["source"][:60],
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": sorted(over), "why": "tests"})
    bench["workloads"] = []
    for cell, (cfg, (base, over), limits) in TINY_CELLS.items():
        with open(os.path.join(BENCH, "traffic", base + ".json")) as f:
            m = json.load(f)
        m.update(over)
        m.update(traffic_overrides or {})
        mix = "tiny_" + cell.split(".")[1]
        with open(os.path.join(dst, "traffic", mix + ".json"), "w") as f:
            json.dump(m, f)
        with open(os.path.join(BENCH, "limits", limits + ".json")) as f:
            limits = json.load(f)
        with open(os.path.join(dst, "limits", cell + ".json"), "w") as f:
            json.dump(limits, f)
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted(TINY_CELLS)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return tmp
