"""Carry the JAX package's packed tables over to the port.

The solver has no weights: its parameters are the packed stencil tables.
`tables_from_numpy` (the sweep's tables), `stencil_from_numpy` (a
theta-major `TWStencil`, the Jacobi engines' tables),
`stream_level_from_numpy` (one level's `StreamTables`/`LevelStatic`),
`wrapped_from_numpy` (a slot-major `WrappedStencil`),
`diag_from_numpy` (a `DiagStencil`), `tiled_from_numpy` (the lane-gather
engines' `TiledStencil`), `packed3d_from_numpy` (the 3-D
solve's `Packed3D`), `device_graph_from_numpy` (the ELL solver's
`DeviceGraph`) and `banded_from_numpy` (the banded solver's
`BandedGraph`) take the JAX package's packed tables (as NumPy arrays or anything `np.asarray` reads) together with
their static fields and return the port's own table types, so both
packages can run on identical tables.
Nothing here imports the JAX package: the inputs are read by field
name.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .contrib.pallas_circulant import TiledStencil
from .ops.banded import BandedGraph, banded_graph
from .ops.circulant import CirculantGraph, ColumnMap, resolve_device
from .ops.diag_circulant import DiagStencil
from .ops.diag_wrapped import WrappedStencil
from .ops.relax import DeviceGraph, device_graph
from .ops.stream_t import LevelStatic, StreamTables
from .ops.sweep_theta import RSweepStatic, SweepStatic, SweepTables
from .ops.wrapped_t import TWStencil
from .solvers.solve3d import Packed3D, _packed3d


def _fields(obj) -> dict:
    """Field name -> value of a NamedTuple, dataclass or mapping."""
    if hasattr(obj, "_asdict"):
        return dict(obj._asdict())
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, Mapping):
        return dict(obj)
    raise TypeError(f"cannot read fields of {type(obj).__name__}")


def _freeze(x):
    """Nested sequences of ints -> nested tuples of Python ints."""
    if isinstance(x, (tuple, list)):
        return tuple(_freeze(v) for v in x)
    return int(x)


def _arrays(x):
    return tuple(np.asarray(a) for a in x)


def tables_from_numpy(tables, static, wtab_dn, wtab_up, rstatic, cg):
    """The port's tables from the JAX package's packed ones.

    tables   : SweepTables fields (wg, cfp, cbp, fan_w, fan_in, wr_dn,
               wr_up, ring_f, ring_b, ring2_f, ring2_b, wh)
    static   : SweepStatic fields (Mp, ML, nt, dms, chain_spans, taps_dn,
               taps_up, h_cap, h_spans)
    wtab_dn, wtab_up : the radial-sweep weight tables
    rstatic  : RSweepStatic fields (MT, K8, NTL, NTB, taps_dn, taps_up,
               Ddn, Dup)
    cg       : CirculantGraph fields (src_flat, w, fan_slots, fan_w,
               cmap, n), cmap with ColumnMap fields
    Returns (SweepTables, SweepStatic, (wtab_dn, wtab_up), RSweepStatic,
    CirculantGraph) of the port, arrays as NumPy with their bits kept.
    """
    t = _fields(tables)
    tbl = SweepTables(**{
        k: _arrays(t[k]) if k in ("wg", "wh") else np.asarray(t[k])
        for k in SweepTables._fields})
    s = _fields(static)
    st = SweepStatic(**{k: _freeze(s[k]) for k in SweepStatic._fields})
    r = _fields(rstatic)
    rst = RSweepStatic(**{k: _freeze(r[k]) for k in RSweepStatic._fields})
    c = _fields(cg)
    m = _fields(c["cmap"])
    cmap = ColumnMap(c_of=np.asarray(m["c_of"]), m_of=np.asarray(m["m_of"]),
                     node_of=np.asarray(m["node_of"]),
                     center=int(m["center"]), M=int(m["M"]),
                     ntheta=int(m["ntheta"]))
    cg_port = CirculantGraph(
        src_flat=np.asarray(c["src_flat"]), w=np.asarray(c["w"]),
        fan_slots=np.asarray(c["fan_slots"]), fan_w=np.asarray(c["fan_w"]),
        cmap=cmap, n=int(c["n"]))
    return (tbl, st, (np.asarray(wtab_dn), np.asarray(wtab_up)), rst,
            cg_port)


def stencil_from_numpy(ws) -> TWStencil:
    """The port's TWStencil from the JAX package's packed one (fields
    wrows, ring_f, ring_b, cfl, cbl, fan_w, maxdm, Mp, ML, M, nt, NTT),
    arrays as NumPy with their bits kept and a fresh, empty table cache
    (the JAX cache holds JAX arrays)."""
    f = _fields(ws)
    arrays = ("wrows", "ring_f", "ring_b", "cfl", "cbl", "fan_w")
    return TWStencil(**{k: np.asarray(f[k]) if k in arrays else int(f[k])
                        for k in TWStencil._fields if k != "dcache"},
                     dcache={})


def stream_level_from_numpy(tables, static):
    """(StreamTables, LevelStatic) of the port from one level of the JAX
    package's streamed path: tables with fields wrows, ring_f, ring_b,
    cfp, cbp, fan_w; static with Mp, ML, nt, maxdm, chain_spans, TB."""
    t = _fields(tables)
    s = _fields(static)
    return (StreamTables(**{k: np.asarray(t[k]) for k in StreamTables._fields}),
            LevelStatic(**{k: _freeze(s[k]) for k in LevelStatic._fields}))


def wrapped_from_numpy(ws) -> WrappedStencil:
    """The port's WrappedStencil from the JAX package's packed one
    (fields offs, wp, wpT, rho_starts, ring_f, ring_b, cfl, cbl, fan_w,
    pad2, D, Mp, M, nt, NTL), arrays as NumPy with their bits kept and a
    fresh, empty table cache."""
    f = _fields(ws)
    arrays = ("offs", "wp", "wpT", "ring_f", "ring_b", "cfl", "cbl", "fan_w")
    out = {k: np.asarray(f[k]) if k in arrays else int(f[k])
           for k in WrappedStencil._fields
           if k not in ("dcache", "rho_starts")}
    return WrappedStencil(**out, dcache={},
                          rho_starts=_freeze(f["rho_starts"]))


def diag_from_numpy(ds) -> DiagStencil:
    """The port's DiagStencil from the JAX package's packed one (fields
    u_idx, offs, wp, ring_f, ring_b, chain_f, chain_b, fan_w, pad, D, Mp,
    M, ntheta, NTL), arrays as NumPy with their bits kept."""
    f = _fields(ds)
    arrays = ("u_idx", "offs", "wp", "ring_f", "ring_b", "chain_f",
              "chain_b", "fan_w")
    return DiagStencil(**{
        k.name: np.asarray(f[k.name]) if k.name in arrays else int(f[k.name])
        for k in dataclasses.fields(DiagStencil)})


def tiled_from_numpy(ts) -> TiledStencil:
    """The port's TiledStencil from the JAX package's packed one (fields
    groups, idx, w, offs, u_of, ring_w, chain_w, fan_w, T, M, ntheta),
    arrays as NumPy with their bits kept."""
    f = _fields(ts)
    arrays = ("idx", "w", "offs", "u_of", "ring_w", "chain_w", "fan_w")
    out = {k.name: np.asarray(f[k.name]) if k.name in arrays
           else int(f[k.name]) for k in dataclasses.fields(TiledStencil)
           if k.name != "groups"}
    return TiledStencil(**out, groups=_freeze(f["groups"]))


def packed3d_from_numpy(W_np, shape, shifts, device,
                        block_rows: int = 1024) -> Packed3D:
    """The port's `Packed3D` from the JAX package's shifted weights
    (`Packed3D.W_np`, (n_shifts, n2, n1, n0)) with its `shape` and
    `shifts`; the kernel plan (star 1) and the scan costs are rebuilt
    from the same bits.  `device` is where the solves will run, checked
    as `prepare3d` checks it; nothing is uploaded here."""
    resolve_device(device)
    shifts = tuple(tuple(int(v) for v in s) for s in shifts)
    return _packed3d(np.ascontiguousarray(np.asarray(W_np)),
                     tuple(int(n) for n in shape), shifts, block_rows)


def device_graph_from_numpy(nbr, w, halo_src, halo_dst, n: int,
                            device) -> DeviceGraph:
    """The port's `DeviceGraph` on `device` from the JAX package's packed
    one (`DeviceGraph` fields nbr, w, halo_src, halo_dst, n), copied with
    the bits of w kept; the kernel's row degrees and halo groups are
    derived from the same arrays."""
    return device_graph(np.array(nbr), np.array(w), np.array(halo_src),
                        np.array(halo_dst), int(n), resolve_device(device))


def banded_from_numpy(offs, W, halo_src, halo_dst, perm, iperm, n: int,
                      n_pad: int, offsets_np, device) -> BandedGraph:
    """The port's `BandedGraph` on `device` from the JAX package's packed
    one (`BandedGraph` fields offs, W, halo_src, halo_dst, perm, iperm, n,
    n_pad, offsets_np), copied with the bits of W kept; the kernels' tap
    lists and halo groups are derived from the same arrays."""
    return banded_graph(np.array(offs), np.array(W), np.array(halo_src),
                        np.array(halo_dst), np.array(perm), np.array(iperm),
                        int(n), int(n_pad), np.array(offsets_np),
                        resolve_device(device))
