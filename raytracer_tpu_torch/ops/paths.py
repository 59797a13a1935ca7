"""Predecessor walks and their sensitivity rows: kernel and twin.

The JAX package walks the predecessor tree of a solve with a fixed-depth
`lax.scan` vmapped over the receivers (`raytracer_tpu/solvers/path.py`
`backtrace_paths`), and `raytracer_tpu/solvers/sensitivity.py` `_coo_jit`
turns each walked pair of nodes (a, b) into the travel-time derivative
g = -t_e/(U_a + U_b), t_e = 2 |x_a - x_b| / (U_a + U_b), scattered onto
both ends.  It runs as XLA, with no Pallas kernel.  As torch ops a walk of
`max_len` steps is `max_len` gather launches (972 at 180x63), so on the
card one launch of the hand-written CUDA kernel `csrc/paths.cu` (a kernel
of the port's own choice) does the whole walk, and with the pair terms
the COO row and the dense row of the sensitivity matrix.

What a call computes (`paths_reference`, the JAX functions op for op):
  * nodes (n_rec, max_len) int32: row r starts at receivers[r] and steps
    node -> prev[node] until the source, then repeats the source;
  * with `terms` = (coords (ndim, n), U (n,), partners (n, P) int32):
    ids (n_rec, 2*(max_len-1)) = [a | b] over the walked pairs (a, b) =
    (nodes[:, k], nodes[:, k+1]), vals = [g | g], where a pair of equal
    nodes (the padded tail), a zero-cost twin-merge hop (b among a's
    partners) or an impassable pair (U_a + U_b <= 0) gives 0;
  * with `dense`, the (n_rec, n) matrix: each row's vals added at its
    ids, the a-column first, in order.
`paths` takes a CPU tensor to the twin and a CUDA tensor to the kernel
(or raises); `paths.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels

Terms = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class PathsOut(NamedTuple):
    nodes: torch.Tensor                  # (n_rec, max_len) int32
    ids: Optional[torch.Tensor]          # (n_rec, 2*(max_len-1)) int32
    vals: Optional[torch.Tensor]         # same shape, U's dtype
    dense: Optional[torch.Tensor]        # (n_rec, n), U's dtype


def walk_reference(prev: torch.Tensor, source: int, receivers: torch.Tensor,
                   max_len: int) -> torch.Tensor:
    """(n_rec, max_len) int32 node ids, one gather a step (the JAX scan:
    each step emits the node, then moves to prev[node] unless it is the
    source)."""
    prev = prev.to(torch.int64)
    node = receivers.to(torch.int64)
    out = torch.empty((node.shape[0], max_len), dtype=torch.int32,
                      device=prev.device)
    for k in range(max_len):
        out[:, k] = node
        node = torch.where(node == source, node, prev[node])
    return out


def pair_terms(coords: torch.Tensor, U: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, partners: torch.Tensor):
    """(t_e, 1/(U_a+U_b)) for node-id tensors a, b of one shape; equal,
    impassable (usum <= 0) and twin-merge pairs give inv = 0 (the JAX
    package's `_pair_terms`)."""
    a, b = a.long(), b.long()
    L2 = None
    for axis in coords:
        d = axis[a] - axis[b]
        L2 = d * d if L2 is None else L2 + d * d
    L = torch.sqrt(L2)
    usum = U[a] + U[b]
    good = usum > 0
    is_twin = (partners[a] == b[..., None]).any(dim=-1)
    one = torch.ones((), dtype=usum.dtype, device=usum.device)
    inv = torch.where(good & ~is_twin, 1.0 / torch.where(good, usum, one),
                      torch.zeros((), dtype=usum.dtype, device=usum.device))
    return 2.0 * L * inv, inv


def paths_reference(prev: torch.Tensor, source: int,
                    receivers: torch.Tensor, max_len: int,
                    terms: Optional[Terms] = None,
                    dense: bool = False) -> PathsOut:
    """The plain twin of the `paths` kernel (see the module docstring)."""
    nodes = walk_reference(prev, source, receivers, max_len)
    if terms is None:
        return PathsOut(nodes, None, None, None)
    coords, U, partners = terms
    a, b = nodes[:, :-1], nodes[:, 1:]
    t_e, inv = pair_terms(coords, U, a, b, partners)
    g = -t_e * inv
    ids = torch.cat([a, b], dim=1)
    vals = torch.cat([g, g], dim=1)
    mat = None
    if dense:
        mat = torch.zeros((nodes.shape[0], U.shape[0]), dtype=U.dtype,
                          device=U.device)
        mat.scatter_add_(1, ids.long(), vals)
    return PathsOut(nodes, ids, vals, mat)


def _paths_lib() -> ctypes.CDLL:
    lib = kernels.load("paths")
    fn = lib.paths_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def paths(prev: torch.Tensor, source: int, receivers: torch.Tensor,
          max_len: int, terms: Optional[Terms] = None,
          dense: bool = False) -> PathsOut:
    """Walk `prev` ((n,) int32) from each receiver ((n_rec,) int32) for
    `max_len` steps; with `terms` also the COO sensitivity rows, and with
    `dense` the dense rows (see the module docstring).  prev must hold
    node ids in [0, n); the kernel stops a walk that meets one outside.

    A CUDA `prev` goes to the hand-written kernel `csrc/paths.cu`: one
    thread a receiver walks its row and writes its nodes, ids and vals,
    and adds its own dense row (no atomics: the result is the same every
    run); float32 or float64 by U's dtype.  A CPU `prev` goes to
    `paths_reference`.  Any other device raises."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    if dense and terms is None:
        raise ValueError("the dense rows need the pair terms")
    dev = prev.device
    if dev.type == "cpu":
        return paths_reference(prev, source, receivers, max_len, terms,
                               dense)
    if dev.type != "cuda":
        raise ValueError(f"paths runs on cuda or cpu, not {dev}")
    n = prev.shape[0]
    n_rec = receivers.shape[0]
    _check(prev, "prev", torch.int32, (n,), dev)
    _check(receivers, "receivers", torch.int32, (n_rec,), dev)
    prev, receivers = prev.contiguous(), receivers.contiguous()
    nodes = torch.empty((n_rec, max_len), dtype=torch.int32, device=dev)
    coords = U = partners = ids = vals = mat = None
    ndim = P = 0
    is_double = 0
    if terms is not None:
        coords, U, partners = terms
        kernels.require_float("paths", U.dtype)
        ndim = coords.shape[0]
        P = partners.shape[1]
        _check(U, "U", U.dtype, (n,), dev)
        _check(coords, "coords", U.dtype, (ndim, n), dev)
        _check(partners, "partners", torch.int32, (n, P), dev)
        coords, U = coords.contiguous(), U.contiguous()
        partners = partners.contiguous()
        width = 2 * (max_len - 1)
        ids = torch.empty((n_rec, width), dtype=torch.int32, device=dev)
        vals = torch.empty((n_rec, width), dtype=U.dtype, device=dev)
        if dense:
            mat = torch.zeros((n_rec, n), dtype=U.dtype, device=dev)
        is_double = int(U.dtype == torch.float64)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _paths_lib().paths_launch(
        prev.data_ptr(), int(source), receivers.data_ptr(), n_rec,
        int(max_len), nodes.data_ptr(), ptr(coords), ndim, n, ptr(U),
        ptr(partners), P, ptr(ids), ptr(vals), ptr(mat), is_double, stream)
    if rc != 0:
        raise RuntimeError(f"paths kernel launch failed: CUDA error {rc}")
    paths.launches += 1
    return PathsOut(nodes, ids, vals, mat)


paths.launches = 0
