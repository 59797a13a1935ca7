"""Keep a test process's memory mappings under the kernel's limit.

An XLA CPU executable keeps its code in memory mappings, and a process
may hold at most `vm.max_map_count` of them (65,530 on Linux by
default).  A worker of the suite keeps every executable it compiled, so
after a few hundred JAX tests it holds tens of thousands of mappings,
and a compile that crosses the limit kills it inside XLA ("LLVM
compilation error: Cannot allocate memory", then an abort or a
segmentation fault; `tools/jax_map_limit.py` shows it).

A port test module that runs JAX imports `below_the_map_limit`, an
autouse module fixture: when the module starts in a process that holds
more than a quarter of the limit, it drops every executable JAX holds
(`jax.clear_caches`).  The tests that call them again recompile them, or
read them from the persistent cache.  The share leaves room for the
largest module's own compiles (the theta-shard references need ~16,000
mappings) and for the JAX package's own test modules, which a worker may
run between two port modules.
"""
from __future__ import annotations

import gc

import jax
import pytest

SHARE = 0.25


def mappings() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def map_limit() -> int:
    with open("/proc/sys/vm/max_map_count") as f:
        return int(f.read())


@pytest.fixture(autouse=True, scope="module")
def below_the_map_limit():
    if mappings() > SHARE * map_limit():
        jax.clear_caches()
        gc.collect()
    yield
