"""Disk cache for built grids and circulant stencils.

A copy of `raytracer_tpu/utils/cache.py`: the same file names and the
same npz keys, so a cache written by one package is read by the other.
npz (not pickle), so the cache survives refactors of the classes.
Grid+graph construction is a deterministic function of (ntheta, nr,
spacing, star), and the stencil of the grid, U and the dtype.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..models.annulus import Grid2D, _flat_to_ragged, init_annulus
from ..ops.circulant import CirculantGraph, ColumnMap, build_circulant

_CACHE_VERSION = 1


def _path(cache_dir: str, ntheta: int, nr: int, spacing: float, star: int) -> str:
    return os.path.join(
        cache_dir, f"annulus_v{_CACHE_VERSION}_{ntheta}x{nr}_sp{spacing:g}_star{star}.npz"
    )


def save_annulus(cache_dir: str, ntheta: int, nr: int, spacing: float, star: int,
                 gr: Grid2D, A: sp.csr_matrix, halo: np.ndarray) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    e2n_flat, e2n_off = gr.flat_e2n()
    nbr_flat, nbr_off = gr.flat_neighbours()
    path = _path(cache_dir, ntheta, nr, spacing, star)
    np.savez(
        path,
        x=gr.x, z=gr.z, theta=gr.theta, r=gr.r,
        e2n_flat=e2n_flat, e2n_off=e2n_off,
        nbr_flat=nbr_flat, nbr_off=nbr_off,
        meta=np.array([gr.ntheta, gr.nr, gr.nel, gr.nnods], dtype=np.int64),
        is_quad=gr.is_quad,
        twin_class=gr.twin_class if gr.twin_class is not None else np.zeros(gr.nnods, np.int8),
        A_indptr=A.indptr, A_indices=A.indices,
        halo=halo,
    )
    return path


def load_annulus(cache_dir: str, ntheta: int, nr: int, spacing: float, star: int
                 ) -> Optional[Tuple[Grid2D, sp.csr_matrix, np.ndarray]]:
    path = _path(cache_dir, ntheta, nr, spacing, star)
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        nt, nrr, nel, nnods = (int(v) for v in f["meta"])
        e2n_off = f["e2n_off"]
        e2n_flat = f["e2n_flat"]
        nbr_off = f["nbr_off"]
        nbr_flat = f["nbr_flat"]
        gr = Grid2D(
            x=f["x"], z=f["z"], theta=f["theta"], r=f["r"],
            e2n=_flat_to_ragged(e2n_flat, e2n_off),
            ntheta=nt, nr=nrr, nel=nel, nnods=nnods,
            neighbours=_flat_to_ragged(nbr_flat, nbr_off),
            is_quad=f["is_quad"],
            twin_class=f["twin_class"],
            e2n_flat=e2n_flat, e2n_off=e2n_off,
            nbr_flat=nbr_flat, nbr_off=nbr_off,
        )
        A = sp.csr_matrix(
            (np.ones(len(f["A_indices"]), dtype=bool), f["A_indices"], f["A_indptr"]),
            shape=(nnods, nnods),
        )
        halo = f["halo"]
    return gr, A, halo


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


def init_annulus_cached(ntheta: int, nr: int, spacing: float = 20.0, star: int = 1,
                        cache_dir: str = ".cache"):
    """init_annulus with a disk cache."""
    hit = load_annulus(cache_dir, ntheta, nr, spacing, star)
    if hit is not None:
        return hit
    gr, A, halo = init_annulus(ntheta, nr, spacing=spacing, star=star)
    try:
        save_annulus(cache_dir, ntheta, nr, spacing, star, gr, A, halo)
    except OSError:
        pass
    return gr, A, halo
