"""Disk cache for circulant stencils.

A copy of `build_circulant_cached` of `raytracer_tpu/utils/cache.py`:
the same file name and the same npz keys, so a cache written by one
package is read by the other.  npz (not pickle), so the cache survives
refactors of the classes.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from ..ops.circulant import CirculantGraph, ColumnMap, build_circulant

_CACHE_VERSION = 1


def build_circulant_cached(gr, A, halo, U, dtype, cache_dir: str = ".cache",
                           tag: str = ""):
    """build_circulant with a disk cache keyed on grid shape + U hash."""
    U = np.asarray(U)
    key = hashlib.sha1(
        U.tobytes() + np.asarray(gr.r).tobytes() + str(np.dtype(dtype)).encode()
    ).hexdigest()[:16]
    path = os.path.join(cache_dir, f"circ_v{_CACHE_VERSION}_{gr.ntheta}x{gr.nr}_{key}{tag}.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            cmap = ColumnMap(
                c_of=f["c_of"], m_of=f["m_of"], node_of=f["node_of"],
                center=int(f["center"]), M=int(f["M"]), ntheta=int(f["ntheta"]),
            )
            return CirculantGraph(
                src_flat=f["src_flat"], w=f["w"],
                fan_slots=f["fan_slots"], fan_w=f["fan_w"],
                cmap=cmap, n=int(f["n"]),
            )
    cg = build_circulant(gr, A, halo, U, dtype=dtype)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(
            path,
            src_flat=cg.src_flat, w=cg.w, fan_slots=cg.fan_slots, fan_w=cg.fan_w,
            c_of=cg.cmap.c_of, m_of=cg.cmap.m_of, node_of=cg.cmap.node_of,
            center=cg.cmap.center, M=cg.cmap.M, ntheta=cg.cmap.ntheta, n=cg.n,
        )
    except OSError:
        pass
    return cg
