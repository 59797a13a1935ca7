"""Build and load the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` (which may include the shared
headers `csrc/*.cuh`) exposes an `extern "C"` launch
function that takes raw pointers, ints and a `cudaStream_t` and returns
`cudaGetLastError()`.  At first use it is compiled with plain `nvcc` into
a shared library under `_build/` (listed in .gitignore) and loaded with
ctypes.  The library's file name carries a hash of the source and the
flags, so a stale library is never loaded.  Nothing here runs when a
module is imported: the CPU tests import every module on machines that
have no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

DEFAULT_CUDA_BIN = "/usr/local/cuda/bin"

# dynamic shared memory one H100 block may have (227 KB = 232,448 bytes,
# minplus::kBlockSmem in the kernels): the wrappers refuse a launch that
# would need more
BLOCK_SMEM = 227 * 1024

_LIBS: dict = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_BIN, "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels need the CUDA "
        "toolkit to build")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """`_build/lib<name>_<hash>.so`, the hash over the source, the shared
    headers `csrc/*.cuh` and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> float:
    """Compile `csrc/<name>.cu` unless its library exists; returns the
    seconds spent compiling (0.0 when the library was already there).
    A compile is the set-up span `build.nvcc`."""
    from .utils import profiling

    out = library_path(name)
    if os.path.exists(out):
        return 0.0
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    with profiling.setup_span("build.nvcc"):
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp,
                               source_path(name)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def require_float(name: str, dtype) -> None:
    """Refuse anything but float32 or float64 for a kernel that has
    builds of both."""
    if str(dtype) not in ("torch.float32", "torch.float64"):
        raise TypeError(f"the {name} kernel takes float32 or float64, not "
                        f"{dtype}")


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use (the set-up span
    `build.kernel`)."""
    lib = _LIBS.get(name)
    if lib is None:
        from .utils import profiling

        with profiling.setup_span("build.kernel"):
            build(name)
            lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
