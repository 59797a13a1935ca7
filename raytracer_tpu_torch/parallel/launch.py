"""Spawn a local process group and run a function on every rank.

`run_group(fn, world, *args, backend=..., device=...)` starts `world`
processes (the `forkserver` start method: one server process a caller,
started at the first group, imports torch and the port once, and each
rank is forked from it, so a group costs no imports after the first; a
rank never inherits the caller's state, and imports the caller's module
only where `fn` lives there), joins them
into one `torch.distributed` group through a `file://` rendezvous in a
fresh temporary directory (so concurrent groups never collide on a
port), calls `fn(*args)` on each and returns the ranks' results in rank
order.  Each rank sees RANK, LOCAL_RANK and WORLD_SIZE as torchrun sets
them, so `mesh.default_device()` gives rank r `cuda:r % device_count`.
`device="cuda"` also makes that card the rank's current device;
`backend="nccl"` needs it.  On `device="cpu"` each rank runs one
intra-op thread (the ranks share the host's cores).

`run_calls(calls)` is a function to hand to `run_group`: it evaluates a
list of `Call`s on every rank in order (arguments that are `Call`s
first, so a mesh or a prepared graph is built inside the rank), skips a
call whose mesh leaves the rank out, and returns their results, a
ValueError raised by a call as ("ValueError", message).  One group thus
serves many sharded calls.

A rank that raises ends the group: the others are stopped and
run_group raises with the failing rank's traceback; so does a group that
outlives `timeout` seconds.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from .mesh import Mesh


class Call(NamedTuple):
    """fn(*args, **kwargs), evaluated inside a rank by `run_calls`."""

    fn: Callable
    args: tuple = ()
    kwargs: dict = {}


def call(fn: Callable, *args, **kwargs) -> Call:
    return Call(fn, args, kwargs)


def _evaluate(x):
    return x.fn(*[_evaluate(a) for a in x.args],
                **{k: _evaluate(v) for k, v in x.kwargs.items()}) \
        if isinstance(x, Call) else x


def run_calls(calls) -> list:
    """Evaluate `calls` in order on this rank (see the module note)."""
    out = []
    for c in calls:
        args = [_evaluate(a) for a in c.args]
        kwargs = {k: _evaluate(v) for k, v in c.kwargs.items()}
        if any(isinstance(v, Mesh) and not v.member
               for v in list(args) + list(kwargs.values())):
            out.append(None)
            continue
        try:
            out.append(c.fn(*args, **kwargs))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def _rank_main(rank: int, world: int, init: str, backend: str, device: str,
               timeout: float, results, payload: str):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            # pickled here, so that a result that cannot be sent fails
            # the rank (the queue's feeder thread would only print it)
            results.put((rank, True, pickle.dumps(fn(*args))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_group(fn: Callable, world: int, *args, backend: str = "gloo",
              device: str = "cuda", timeout: float = 600.0) -> list:
    """[fn(*args) on rank 0, ..., on rank world-1] of a fresh local group
    of `world` processes (see the module note)."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if backend == "nccl" and device != "cuda":
        raise ValueError("backend='nccl' runs on CUDA devices: pass "
                         "device='cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' (with "
                           "backend='gloo') to run the group on the CPU")
    ctx = mp.get_context("forkserver")
    # takes effect where the server is not yet running; it never
    # initialises CUDA, so a forked rank may
    ctx.set_forkserver_preload([__name__])
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="rt_group_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        # the function and its arguments go through a file: a started
        # child reads its pipe only once its imports are done, so large
        # arguments there would start the ranks one after another
        payload = os.path.join(tmp, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, backend, device, timeout,
                                   results, payload), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict = {}
        done = False
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                # a rank flushes its result into the pipe before it exits,
                # so only one that had exited before this wait began and
                # still sent nothing during it has died without a result
                # (one that exits during the wait may have just sent it)
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} before reporting "
                            f"a result") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"the group of {world} ranks did not finish "
                            f"within {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(
                        f"rank {rank} of {world} failed:\n{val}")
                got[rank] = pickle.loads(val)
            done = True
        finally:
            # a failed group may leave ranks waiting in a collective
            for p in procs:
                p.join(timeout=30 if done else 0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]

