"""Multi-device sharding on `torch.distributed`: the source batch and
the grid axes.

Counterpart of `raytracer_tpu/parallel`, with its public names.  A mesh
is a list of ranks (one process and one device each, `mesh.py`); every
sharded function is called by every rank of its mesh and returns the
whole result on each:
  * source batch (multisource.py, refine_shard.py) - tables and bends
    with no collective inside the solves, one gather at the end;
  * grid theta axis (theta_shard.py) - domain decomposition with a
    +-2-column ring halo per Gauss-Seidel round, for fields beyond one
    card;
  * 3-D grid slabs (shard3d.py) - the same for the structured 3-D box
    (+-1-plane halo per triaxial sweep round).
`launch.run_group` spawns a local group (the tests and chip_smoke.py);
torchrun starts one as well.
"""
from .mesh import (SOURCE_AXIS, make_mesh, pad_sources, replicated,
                   source_sharding)
from .multisource import (
    solve_sharded,
    travel_time_table,
    travel_time_table_3d,
    travel_time_table_circulant,
    travel_time_table_stream,
    travel_time_table_sweep,
    travel_time_table_twrapped,
)
from .refine_shard import refine_paths_sharded
from .theta_shard import THETA_AXIS, make_theta_mesh, solve_sweep_theta_sharded
from .shard3d import SHARD3D_AXIS, make_shard3d_mesh, solve3d_sharded
