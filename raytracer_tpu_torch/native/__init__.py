"""Native (C++) host builder of the node adjacency, loaded with ctypes.

A copy of the JAX package's `native/`: the mesh build's adjacency union
is ~100x cheaper in C++ than as scipy sparse matmuls (graphbuild.cpp).
At first use the source is compiled with `g++ -O3 -march=native -shared
-fPIC` into the package's `_build/` (listed in .gitignore), the library
named by a hash of the source, the flags and the host CPU, so a stale
library or one built for another CPU is never loaded.

Where no `g++` is on PATH, `node_adjacency_native_flat` returns None and
`models.annulus.node_adjacency` takes its scipy twin.  With g++ present,
a failed compile or load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import scipy.sparse as sp

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graphbuild.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _cpu_key() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(lines[:2]).encode()
    except OSError:
        import platform
        return platform.processor().encode()


def library_path() -> str:
    """`_build/libgraphbuild_<hash>.so`, the hash over the source, the
    flags and the host CPU."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_key())
    return os.path.join(BUILD_DIR, f"libgraphbuild_{h.hexdigest()[:16]}.so")


def available() -> bool:
    """True where g++ is on PATH (the native route is then taken)."""
    return shutil.which("g++") is not None


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on graphbuild.cpp "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None without g++."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not available():
            return None
        out = library_path()
        if not os.path.exists(out):
            _build(out)
        lib = ctypes.CDLL(out)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.node_adjacency.restype = ctypes.c_int64
        lib.node_adjacency.argtypes = [
            i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i64p, i64p]
        lib.node_adjacency_fill32.restype = ctypes.c_int64
        lib.node_adjacency_fill32.argtypes = [
            i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i64p, ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def node_adjacency_native_flat(e2n_flat, e2n_off, nbr_flat, nbr_off,
                               nnods: int, star: int) -> Optional[sp.csr_matrix]:
    """C++ node adjacency from flat (CSR-style) element lists; None when
    no g++ is on PATH (callers then take the scipy twin).  The count
    pass caches its per-signature-group rows C++-side, so the fill pass
    is a straight copy."""
    lib = _load()
    if lib is None:
        return None

    nel = len(e2n_off) - 1
    e2n_flat = np.ascontiguousarray(e2n_flat, dtype=np.int64)
    e2n_off = np.ascontiguousarray(e2n_off, dtype=np.int64)
    nbr_off = np.ascontiguousarray(nbr_off, dtype=np.int64)
    nbr_flat = (np.ascontiguousarray(nbr_flat, dtype=np.int64)
                if nbr_off[-1] else np.zeros(1, dtype=np.int64))

    indptr = np.zeros(nnods + 1, dtype=np.int64)
    nnz = lib.node_adjacency(
        _p(e2n_flat), _p(e2n_off), _p(nbr_flat), _p(nbr_off),
        nel, nnods, star, _p(indptr), None,
    )
    indices = np.empty(nnz, dtype=np.int32)
    node_adjacency_native_flat.calls += 1
    lib.node_adjacency_fill32(
        _p(e2n_flat), _p(e2n_off), _p(nbr_flat), _p(nbr_off),
        nel, nnods, star, _p(indptr),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return sp.csr_matrix(
        (np.ones(nnz, dtype=bool), indices, indptr.astype(np.int32)),
        shape=(nnods, nnods),
    )


# how many adjacencies the native route built (the card's smoke run reads
# it to show that the host took the native route)
node_adjacency_native_flat.calls = 0


def node_adjacency_native(e2n, neighbours, nnods: int, star: int) -> Optional[sp.csr_matrix]:
    """Ragged-list wrapper around node_adjacency_native_flat."""
    nel = len(e2n)
    e2n_off = np.zeros(nel + 1, dtype=np.int64)
    np.cumsum([len(x) for x in e2n], out=e2n_off[1:])
    e2n_flat = (np.concatenate(e2n) if nel else np.empty(0, np.int64))
    nbr_off = np.zeros(nel + 1, dtype=np.int64)
    np.cumsum([len(x) for x in neighbours], out=nbr_off[1:])
    nbr_flat = (np.concatenate(neighbours) if nbr_off[-1]
                else np.empty(0, np.int64))
    return node_adjacency_native_flat(e2n_flat, e2n_off, nbr_flat, nbr_off,
                                      nnods, star)
