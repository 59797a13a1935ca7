"""The locator's grid search: kernel and twin.

For picks t_k = t0 + T_k(x) the weighted least-squares origin time at a
node is the weighted mean residual, so a node's misfit is the demeaned
residual variance, and the best node is its argmin over all n nodes
(`raytracer_tpu/solvers/locate.py`).  The JAX package runs it as jitted
XLA, with no Pallas kernel, in two formulas:
  * direct (`_grid_search_jit`, one event): resid = t_obs - T[:, j],
    t0_j = w2 . resid / W2, m_j = sum w2 (resid - t0_j)^2;
  * expanded (`_grid_search_catalogue_jit`, a block of 64 events): both
    sides demeaned, Tc = Tm - s2/W2, Oc = T_obs - s1/W2, a = w2 Oc,
    m = sum(a Oc) - 2 a @ Tc + w2 @ (Tc Tc), t0 = (s1 - s2[j]) / W2.
In both a column with any non-finite station time gets m = inf, and the
argmin takes the first of equal minima (an all-inf row gives node 0).
As torch ops the catalogue search is a dozen launches that write and
re-read an (E, n) block (77 MB at 64 events on the 180x63 grid), so on
the card one call of the hand-written CUDA kernel `csrc/gridsearch.cu`
(a kernel of the port's own choice) reads the (K, n) fields once and
writes (j, t0, m) per event, in either formula, for a whole catalogue.

`grid_search` takes CPU tensors to the twins (`grid_search_reference`
event by event, `grid_search_catalogue_reference` in 64-event blocks, the
JAX functions op for op) and CUDA tensors to the kernel (or raises);
`grid_search.launches` counts the kernel's calls.  The kernel sums in
another order than the twins' matmuls, and two nodes can tie to the last
bit (a halo twin and its partner have the same times), so node ids from
two summation orders are compared only under the tie rule of the
check-only module `ops/gridsearch_check.py`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import kernels

MODES = ("direct", "expanded")
CATALOGUE_BLOCK = 64     # the JAX package's events a catalogue dispatch


def _direct_rows(T: torch.Tensor, t_obs: torch.Tensor, w2: torch.Tensor):
    """(m, t0) over the n nodes for one event, `_grid_search_jit`'s ops."""
    resid = t_obs[:, None] - T
    t0 = (w2 @ resid) / torch.sum(w2)
    m = torch.sum(w2[:, None] * (resid - t0[None, :]) ** 2, dim=0)
    inf = torch.full((), float("inf"), dtype=m.dtype, device=m.device)
    return torch.where(torch.all(torch.isfinite(T), dim=0), m, inf), t0


def grid_search_reference(T: torch.Tensor, t_obs: torch.Tensor,
                          w2: torch.Tensor):
    """The direct twin: (j, t0, m) 0-d tensors for T (K, n), t_obs (K,),
    w2 (K,)."""
    m, t0 = _direct_rows(T, t_obs, w2)
    j = torch.argmin(m)
    return j, t0[j], m[j]


def _catalogue_obs(T_obs: torch.Tensor, w2: torch.Tensor):
    """The event side of the expanded form, (W2, s1, a, A) (the kernel
    forms the same terms from T_obs and w2 with its own sums)."""
    W2 = torch.sum(w2)
    s1 = T_obs @ w2
    Oc = T_obs - (s1 / W2)[:, None]
    a = w2[None, :] * Oc
    return W2, s1, a, torch.sum(a * Oc, dim=1)


def _catalogue_cols(T: torch.Tensor, w2: torch.Tensor, W2: torch.Tensor):
    """The node side of the expanded form: (finite, s2, Tc, C)."""
    finite = torch.all(torch.isfinite(T), dim=0)
    Tm = torch.where(finite[None, :], T, torch.zeros((), dtype=T.dtype,
                                                     device=T.device))
    s2 = w2 @ Tm
    Tc = Tm - (s2 / W2)[None, :]
    return finite, s2, Tc, w2 @ (Tc * Tc)


def _expanded_rows(T, T_obs, w2):
    W2, s1, a, A = _catalogue_obs(T_obs, w2)
    finite, s2, Tc, C = _catalogue_cols(T, w2, W2)
    m = A[:, None] - 2.0 * (a @ Tc) + C[None, :]
    inf = torch.full((), float("inf"), dtype=m.dtype, device=m.device)
    return torch.where(finite[None, :], m, inf), W2, s1, s2, A, C


def grid_search_catalogue_reference(T: torch.Tensor, T_obs: torch.Tensor,
                                    w2: torch.Tensor,
                                    block: int = CATALOGUE_BLOCK):
    """The expanded twin: (j, t0, m) (E,) for T (K, n), T_obs (E, K),
    w2 (K,), `_grid_search_catalogue_jit`'s ops on blocks of `block`
    events (its (E, n) misfit block bounds the memory)."""
    js, t0s, ms = [], [], []
    for lo in range(0, T_obs.shape[0], block):
        m, W2, s1, s2, _, _ = _expanded_rows(T, T_obs[lo:lo + block], w2)
        j = torch.argmin(m, dim=1)
        rows = torch.arange(m.shape[0], device=m.device)
        js.append(j)
        t0s.append((s1 - s2[j]) / W2)
        ms.append(m[rows, j])
    if not js:
        empty = T_obs.new_empty((0,))
        return empty.long(), empty, empty
    return torch.cat(js), torch.cat(t0s), torch.cat(ms)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("gridsearch")
    fn = lib.gridsearch_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_void_p])
        lib.gridsearch_blocks.restype = ctypes.c_int
        lib.gridsearch_blocks.argtypes = [ctypes.c_int] * 3
    return lib


_BLOCKS: dict = {}   # (n, expanded, is_double) -> pass 1's blocks


def _blocks(lib, n: int, expanded: int, is_double: int) -> int:
    key = (n, expanded, is_double)
    nb = _BLOCKS.get(key)
    if nb is None:
        nb = lib.gridsearch_blocks(n, expanded, is_double)
        if nb < 1:
            raise RuntimeError(f"gridsearch kernel: no launch shape for {n} "
                               f"columns: CUDA error {-nb}")
        _BLOCKS[key] = nb
    return nb


def grid_search(T: torch.Tensor, T_obs: torch.Tensor, w2: torch.Tensor,
                mode: str = "direct"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(j (E,) int64, t0 (E,), m (E,)) for the fields T (K, n), the picks
    T_obs (E, K) and the squared weights w2 (K,), in T's dtype (float32
    or float64) on T's device; mode "direct" or "expanded" picks the JAX
    formula (see the module docstring).

    A CUDA T goes to the hand-written kernel `csrc/gridsearch.cu`: a
    lane's tile of columns against its warp's events, its best kept as it
    walks the columns in order, one reduction an (event, block), the
    whole catalogue in one call, the first index among equal minima; the
    kernel forms W2 and the expanded formula's event side itself, so the
    call is one allocation of each output type and the launch.  A CPU T
    goes to the twins: event by event in the direct mode, in 64-event
    blocks in the expanded one.  Any other device raises."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if T.dim() != 2 or T_obs.dim() != 2 or T_obs.shape[1] != T.shape[0] \
            or tuple(w2.shape) != (T.shape[0],):
        raise ValueError(f"T (K, n), T_obs (E, K) and w2 (K,) expected, got "
                         f"{tuple(T.shape)}, {tuple(T_obs.shape)}, "
                         f"{tuple(w2.shape)}")
    dev = T.device
    T_obs = T_obs.to(device=dev, dtype=T.dtype)
    w2 = w2.to(device=dev, dtype=T.dtype)
    if dev.type == "cpu":
        if mode == "expanded":
            return grid_search_catalogue_reference(T, T_obs, w2)
        out = [grid_search_reference(T, row, w2) for row in T_obs]
        if not out:
            empty = T_obs.new_empty((0,))
            return empty.long(), empty, empty
        return tuple(torch.stack([o[i] for o in out]) for i in range(3))
    if dev.type != "cuda":
        raise ValueError(f"grid_search runs on cuda or cpu, not {dev}")
    kernels.require_float("gridsearch", T.dtype)
    K, n = T.shape
    E = T_obs.shape[0]
    T, T_obs, w2 = T.contiguous(), T_obs.contiguous(), w2.contiguous()
    lib = _lib()
    expanded, is_double = int(mode == "expanded"), int(T.dtype == torch.float64)
    nb = _blocks(lib, n, expanded, is_double)
    # (t0, m, the partial misfits) and (j, the partial columns as int32)
    vals = torch.empty(E * (2 + nb) + 1, dtype=T.dtype, device=dev)
    ids = torch.empty(E + (E * nb + 1) // 2 + 1, dtype=torch.int64,
                      device=dev)
    vp, ip, size = vals.data_ptr(), ids.data_ptr(), T.element_size()
    rc = lib.gridsearch_launch(
        T.data_ptr(), K, n, T_obs.data_ptr(), E, w2.data_ptr(), expanded, nb,
        vp + 2 * E * size, ip + 8 * E, ip, vp, vp + E * size, is_double,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gridsearch kernel launch failed: CUDA error {rc}")
    grid_search.launches += 1
    return ids[:E], vals[:E], vals[E:2 * E]


grid_search.launches = 0
