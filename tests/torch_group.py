"""A sharded test module's port results and JAX references, made once.

`once(request, tmp_path_factory, name, calls, references)` runs the
port's sharded `calls` (`launch.Call`s, as `launch.run_calls` takes
them) in one 8-rank gloo group on the CPU, in a background thread, while
this process computes `references()` (the JAX package's results, on the
8 virtual CPU devices of conftest.py), and returns `(ranks, refs)`:
`ranks[r][i]` is call i's result on rank r.

Under pytest-xdist a module's tests may land on several workers; the
first worker to reach the module makes both and stores them in the
run's shared temporary directory, and the others wait on its file lock
and read them, so each module's group and references are made once a
run.

While the group's thread runs, the references' compiles write nothing to
JAX's persistent compilation cache (conftest.py's): a worker died in
XLA's serialisation of an executable for that cache (a segmentation
fault in `put_executable_and_time`) while a group ran beside it.  Reads
from the cache go on; the references are made once a run anyway.
"""
from __future__ import annotations

import contextlib
import fcntl
import os
import pickle
import threading

import jax

from raytracer_tpu_torch.parallel import launch

WORLD = 8
_MIN_CACHED = "jax_persistent_cache_min_compile_time_secs"


@contextlib.contextmanager
def _no_cache_writes():
    """No compile is slow enough to be written to the persistent cache."""
    old = getattr(jax.config, _MIN_CACHED)
    jax.config.update(_MIN_CACHED, float("inf"))
    try:
        yield
    finally:
        jax.config.update(_MIN_CACHED, old)


def _make(calls, references):
    out = {}

    def group():
        try:
            out["ranks"] = launch.run_group(launch.run_calls, WORLD,
                                            list(calls), backend="gloo",
                                            device="cpu")
        except BaseException as e:      # re-raised in the caller
            out["error"] = e

    with _no_cache_writes():
        t = threading.Thread(target=group, daemon=True)
        t.start()
        try:
            refs = references()
        finally:
            t.join()
    if "error" in out:
        raise out["error"]
    return out["ranks"], refs


def once(request, tmp_path_factory, name: str, calls, references):
    if not hasattr(request.config, "workerinput"):       # no xdist
        return _make(calls, references)
    path = tmp_path_factory.getbasetemp().parent / f"torch_group_{name}"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(f"{path}.pkl"):
                with open(f"{path}.pkl", "rb") as f:
                    return pickle.load(f)
            made = _make(calls, references)
            with open(f"{path}.tmp", "wb") as f:
                pickle.dump(made, f)
            os.replace(f"{path}.tmp", f"{path}.pkl")
            return made
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
