"""The memory mappings a process needs for the JAX references of
tests/test_torch_theta_shard.py, and what XLA does when the process is
near the kernel's limit on them (`vm.max_map_count`).

    JAX_PLATFORMS=cpu python tools/jax_map_limit.py [--hold N]

Configures JAX as tests/conftest.py does (the CPU, 8 virtual devices,
float64), holds N extra mappings of 4 KB (alternately read-only and
read-write, so that the kernel cannot merge neighbours), then compiles
and runs the module's `_references` on the 48x12 annulus and prints the
process's mapping count (`/proc/self/maps`) before and after, with the
limit.  At --hold 0 the references need ~16,000 mappings; near the limit
XLA's compile fails ("LLVM compilation error: Cannot allocate memory")
and the process dies in XLA, as a suite worker that holds the mappings
of a few hundred earlier JAX tests did (tests/torch_group.py drops them
first).  About a minute on one core.
"""
from __future__ import annotations

import argparse
import mmap
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


def _maps() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hold", type=int, default=0,
                    help="extra 4 KB mappings to hold first")
    a = ap.parse_args(argv)
    held = [mmap.mmap(-1, 4096, prot=mmap.PROT_READ if i % 2
                      else mmap.PROT_READ | mmap.PROT_WRITE)
            for i in range(a.hold)]
    import numpy as np

    import raytracer_tpu as rt
    import raytracer_tpu_torch as pt
    import test_torch_theta_shard as T

    jgr, jcg, _ = rt.init_annulus_circulant(48, 12, 150.0, dtype=np.float64)
    gr, cg, _ = pt.init_annulus_circulant(48, 12, 150.0, dtype=np.float64)
    with open("/proc/sys/vm/max_map_count") as f:
        limit = int(f.read())
    print(f"mappings before the references {_maps()} ({len(held)} held), "
          f"limit {limit}", flush=True)
    T._references((jgr, jcg, gr, cg))
    print(f"mappings after the references {_maps()}", flush=True)


if __name__ == "__main__":
    main()
