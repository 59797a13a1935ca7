"""Device meshes over `torch.distributed` process groups.

Counterpart of `raytracer_tpu/parallel/mesh.py` and of the mesh makers
of `theta_shard.py` and `shard3d.py`.  The JAX package's meshes are
arrays of devices under one program (`shard_map`); here a mesh is a list
of ranks, each one process with its own device, and every sharded
function is called by every rank of the mesh (single program, multiple
processes).  Each rank returns the same host result, the whole array
that the JAX function returns.

A `Mesh` holds its ranks in mesh order, this process's place among them,
its device and the process groups its collectives run on.  The makers
call `dist.new_group` on every rank in the same order (the call is
collective, also for the ranks a group leaves out), so every rank of the
world calls every maker, and a rank outside the mesh gets a mesh it is
not a member of (`member` False), on which it calls nothing.  Where no
process group is initialised, a mesh has the one rank of this process
and every function runs locally with no collective: a one-device JAX
mesh.

The collectives (`all_gather`, `all_min`, `any_of`, `ring_exchange`)
take tensors on the mesh's device.  On an NCCL group they run on the
device tensors; on a gloo group they run on host copies of them (gloo
sends host memory: the two-ranks-on-one-card case, where NCCL refuses a
card shared by two ranks), and the results come back to the device.
That staging follows from the backend the caller chose, not from a
failure: a gloo group on CPU tensors copies nothing.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

SOURCE_AXIS = "sources"
THETA_AXIS = "theta"
SRC_AXIS = "src"
SHARD3D_AXIS = "shard3d"


def default_device() -> torch.device:
    """`cuda:<LOCAL_RANK % device_count>` (LOCAL_RANK as torchrun and
    `launch.run_group` set it, else the global rank, else 0)."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if dist.is_initialized() else 0
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a mesh runs on the card "
                           "unless the caller passes device='cpu'")
    return torch.device("cuda", int(local) % torch.cuda.device_count())


class Mesh:
    """A mesh of ranks with named axes (row-major over `shape`).

    ranks  : the global ranks, in mesh order
    shape  : {axis name: size}, in axis order
    device : this rank's torch.device
    index  : this rank's position in `ranks` (-1 if not a member)
    groups : {axis name: (group, line)} - `line` the global ranks that
             share this rank's coordinates on every other axis, in mesh
             order, and `group` their process group (None for a one-rank
             line or no process group) - and under None the whole mesh
    """

    def __init__(self, ranks, shape: dict, device, groups: dict, index: int):
        self.ranks = tuple(ranks)
        self.shape = dict(shape)
        self.device = torch.device(device)
        self.groups = groups
        self.index = index

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.index >= 0

    def coord(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.groups[axis][1].index(_rank())

    def group(self, axis: Optional[str] = None):
        """(process group, line of global ranks) of `axis`, or of the
        whole mesh."""
        return self.groups[axis]

    def require_member(self) -> None:
        if not self.member:
            raise ValueError(f"rank {_rank()} is not in the mesh of ranks "
                             f"{self.ranks}: only its ranks call its "
                             f"functions")

    def __repr__(self) -> str:
        return (f"Mesh(ranks={self.ranks}, shape={self.shape}, "
                f"device={self.device}, index={self.index})")


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _resolve(device) -> torch.device:
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "a mesh on the CPU")
    return device


def _new_groups(ranks: Sequence[int], axes, dims):
    """({axis: (group, line)}, this rank's index), creating the whole
    mesh's group and then every line's group of every axis, on every
    rank in one fixed order."""
    me = _rank()
    grid = np.asarray(ranks).reshape(dims)
    index = int(np.flatnonzero(grid.ravel() == me)[0]) if me in ranks else -1
    whole = None
    if dist.is_initialized() and len(ranks) > 1:
        whole = dist.new_group(list(ranks))
    out = {None: (whole, tuple(ranks))}
    for a, name in enumerate(axes):
        out[name] = (None, ())
        for line in np.moveaxis(grid, a, -1).reshape(-1, dims[a]):
            line = tuple(int(r) for r in line)
            g = whole if len(axes) == 1 else None
            if dist.is_initialized() and dims[a] > 1 and len(axes) > 1:
                g = dist.new_group(list(line))
            if me in line:
                out[name] = (g, line)
    return out, index


def _make(ranks, axes, dims, device) -> Mesh:
    if ranks is None:
        ranks = list(range(_world()))
    ranks = [int(r) for r in ranks]
    if len(set(ranks)) != len(ranks) or any(
            r < 0 or r >= _world() for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world "
                         f"of {_world()}")
    if int(np.prod(dims)) != len(ranks):
        raise ValueError(f"{len(ranks)} ranks do not fill a {dims} mesh")
    groups, index = _new_groups(ranks, axes, dims)
    dev = _resolve(device) if index >= 0 else torch.device("cpu")
    return Mesh(ranks, dict(zip(axes, dims)), dev, groups, index)


def make_mesh(ranks: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """1-D mesh over all (or the given) ranks along the source axis."""
    n = _world() if ranks is None else len(ranks)
    return _make(ranks, (SOURCE_AXIS,), (n,), device)


def make_theta_mesh(ranks: Optional[Sequence[int]] = None,
                    device=None) -> Mesh:
    """1-D mesh over all (or the given) ranks along the theta axis."""
    n = _world() if ranks is None else len(ranks)
    return _make(ranks, (THETA_AXIS,), (n,), device)


def make_grid_mesh(d_src: int, d_theta: Optional[int] = None,
                   ranks: Optional[Sequence[int]] = None,
                   device=None) -> Mesh:
    """2-D (source, theta) mesh: rows shard the source batch (no
    collective between rows), columns shard the theta axis (ring halo
    inside each row).  d_theta defaults to the ranks over d_src."""
    ranks = list(range(_world())) if ranks is None else list(ranks)
    if d_theta is None:
        if len(ranks) % d_src:
            raise ValueError(f"{len(ranks)} ranks not divisible by "
                             f"d_src={d_src}")
        d_theta = len(ranks) // d_src
    return _make(ranks[: d_src * d_theta], (SRC_AXIS, THETA_AXIS),
                 (d_src, d_theta), device)


def make_shard3d_mesh(ranks: Optional[Sequence[int]] = None,
                      device=None) -> Mesh:
    """1-D mesh over all (or the given) ranks along the 3-D slab axis."""
    n = _world() if ranks is None else len(ranks)
    return _make(ranks, (SHARD3D_AXIS,), (n,), device)


class Sharding(NamedTuple):
    """Where an array lives on a mesh: split along dim 0 into equal
    blocks in mesh order over `axis`, or whole on every rank (axis None)
    - the JAX package's NamedSharding with P(axis) or P()."""

    mesh: Mesh
    axis: Optional[str]

    def local(self, x):
        """This rank's part of the whole array `x`."""
        if self.axis is None:
            return x
        _, line = self.mesh.group(self.axis)
        if len(x) % len(line):
            raise ValueError(f"{len(x)} rows do not split over "
                             f"{len(line)} ranks (pad_sources pads them)")
        n = len(x) // len(line)
        i = line.index(_rank())
        return x[i * n:(i + 1) * n]


def source_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, SOURCE_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def pad_sources(sources: np.ndarray, n_devices: int) -> np.ndarray:
    """Pad the source list to a multiple of the mesh size (repeat last)."""
    sources = np.asarray(sources, dtype=np.int32)
    rem = (-len(sources)) % n_devices
    if rem:
        sources = np.concatenate([sources,
                                  np.full(rem, sources[-1], np.int32)])
    return sources


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------


def _staged(group) -> bool:
    """True for a gloo group: its collectives take host tensors."""
    return dist.get_backend(group) == "gloo"


def _to_comm(x: torch.Tensor, group) -> torch.Tensor:
    return x.cpu() if _staged(group) else x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None
               ) -> torch.Tensor:
    """The ranks' equal-shape blocks `x` of `axis` (the whole mesh when
    None), concatenated along dim 0 in mesh order, on x's device."""
    g, line = mesh.group(axis)
    if g is None:
        return x
    xc = _to_comm(x.contiguous(), g)
    parts = [torch.empty_like(xc) for _ in line]
    dist.all_gather(parts, xc, group=g)
    # the group orders its ranks by global rank, the mesh by its line
    order = sorted(line)
    return torch.cat([parts[order.index(r)] for r in line],
                     dim=0).to(x.device)


def all_min(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None
            ) -> torch.Tensor:
    """Elementwise minimum of `x` over the ranks of `axis`."""
    g, _ = mesh.group(axis)
    if g is None:
        return x
    xc = _to_comm(x.clone(), g)
    dist.all_reduce(xc, op=dist.ReduceOp.MIN, group=g)
    return xc.to(x.device)


def any_of(flag: torch.Tensor, mesh: Mesh, axis: Optional[str] = None
           ) -> bool:
    """The vote: True where any rank of `axis` has `flag` set; read on
    the host (every rank of the axis reads it)."""
    g, _ = mesh.group(axis)
    v = flag.to(torch.int32).reshape(1)
    if g is not None:
        v = _to_comm(v, g)
        dist.all_reduce(v, op=dist.ReduceOp.SUM, group=g)
    return bool(v.item() > 0)


def ring_exchange(to_next: torch.Tensor, to_prev: torch.Tensor, mesh: Mesh,
                  axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(from_prev, from_next): each rank p of the ring of `axis` sends
    `to_next` to rank p+1 and `to_prev` to rank p-1 (mod D), and gets the
    blocks its neighbours sent its way.  D = 1 sends nothing (the ring is
    the block itself).  At D = 2 both neighbours are one rank: the two
    messages carry distinct tags (NCCL, which has none, matches the
    posted pairs in order, and every rank posts them in one order)."""
    g, line = mesh.group(axis)
    D = len(line)
    if g is None or D == 1:
        return to_next, to_prev
    pos = line.index(_rank())
    nxt, prv = line[(pos + 1) % D], line[(pos - 1) % D]
    dev = to_next.device
    s_next = _to_comm(to_next.contiguous(), g)
    s_prev = _to_comm(to_prev.contiguous(), g)
    r_prev = torch.empty_like(s_next)
    r_next = torch.empty_like(s_prev)
    ops = [dist.P2POp(dist.isend, s_next, nxt, g, _TAG_TO_NEXT),
           dist.P2POp(dist.irecv, r_prev, prv, g, _TAG_TO_NEXT),
           dist.P2POp(dist.isend, s_prev, prv, g, _TAG_TO_PREV),
           dist.P2POp(dist.irecv, r_next, nxt, g, _TAG_TO_PREV)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return r_prev.to(dev), r_next.to(dev)


_TAG_TO_NEXT = 1
_TAG_TO_PREV = 2
