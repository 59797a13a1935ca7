"""Grid partition into layers and discontinuity boundaries.

Host-side NumPy, a copy of `raytracer_tpu/models/partition.py`: every
node is labelled `Layer_k` (k = 1..8, surface to inner core) or
`Boundary_k` (k = 1..7, on the k-th discontinuity), and a down-then-up
level iterator drives the multi-stage sweeps (solvers/multiphase.py)
and the phase regions (solvers/phases.py).  Labels are kept as strings
for API parity, with integer id arrays alongside for the masks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..config import DISCONTINUITY_RADII


def find_layer_number(ri: float, rlayer=DISCONTINUITY_RADII) -> int:
    """Layer index of radius ri (src/topology/topology.jl:139-148):
    1 above the first discontinuity, len+1 below the last."""
    if ri > rlayer[0]:
        return 1
    if ri < rlayer[-1]:
        return len(rlayer) + 1
    for i in range(len(rlayer) - 1):
        if rlayer[i] > ri > rlayer[i + 1]:
            return i + 2
    raise ValueError(f"radius {ri} is exactly on a boundary")


@dataclasses.dataclass(frozen=True)
class GridPartition:
    """id: per-node string label; layer_of/boundary_of: integer codes
    (layer 1..nlayers, boundary 1..nboundaries or 0); iterator: level ->
    labels active at that level (1-based levels, 2*nlayers-1 of them)."""

    id: np.ndarray
    rboundaries: Tuple[float, ...]
    layers: Tuple[str, ...]
    boundaries: Tuple[str, ...]
    nlayers: int
    nboundaries: int
    iterator: Dict[int, Tuple[str, ...]]
    layer_of: np.ndarray
    boundary_of: np.ndarray


def partition_grid(gr, rboundaries=DISCONTINUITY_RADII) -> GridPartition:
    """Label every node by layer/boundary (src/topology/topology.jl:183-206).

    The reference compares round(r, 2) against the boundary radii; grid
    construction places boundary nodes exactly on them, so exact
    comparison after rounding is faithful.
    """
    rb = tuple(float(r) for r in rboundaries)
    nb = len(rb)
    nlayers = nb + 1
    r = np.round(np.asarray(gr.r), 2)
    rb_round = np.round(rb, 2)

    boundary_of = np.zeros(len(r), dtype=np.int32)
    for k, rbk in enumerate(rb_round):
        boundary_of[r == rbk] = k + 1

    layer_of = np.zeros(len(r), dtype=np.int32)
    free = boundary_of == 0
    lr = np.searchsorted(-np.asarray(rb_round), -r[free], side="left") + 1
    layer_of[free] = lr

    labels = np.empty(len(r), dtype=object)
    labels[free] = [f"Layer_{k}" for k in layer_of[free]]
    labels[~free] = [f"Boundary_{k}" for k in boundary_of[~free]]

    layers = tuple(f"Layer_{i + 1}" for i in range(nlayers))
    boundaries = tuple(f"Boundary_{i + 1}" for i in range(nb))

    # down-then-up level iterator (src/topology/topology.jl:166-176)
    nmax = 2 * nlayers - 1
    it: Dict[int, Tuple[str, ...]] = {}
    it[1] = it[nmax] = (layers[0], boundaries[0])
    for i in range(2, nlayers):
        it[i] = (layers[i - 1], boundaries[i - 2], boundaries[i - 1])
        it[nmax - i + 1] = (layers[i - 1], boundaries[i - 2], boundaries[i - 1])
    it[nlayers] = (layers[-1], boundaries[-1])

    return GridPartition(
        id=labels,
        rboundaries=rb,
        layers=layers,
        boundaries=boundaries,
        nlayers=nlayers,
        nboundaries=nb,
        iterator=it,
        layer_of=layer_of,
        boundary_of=boundary_of,
    )


def level_mask(partition: GridPartition, level: int) -> np.ndarray:
    """Boolean mask of nodes active at the given iterator level."""
    active = set(partition.iterator[level])
    return np.isin(partition.id, list(active))
