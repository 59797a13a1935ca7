"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises and
the exit code is non-zero):
  1. environment: torch, CUDA, nvcc release, ninja, the card's name and
     power limit;
  2. build: every CUDA kernel of the port, one nvcc per source, all
     started together;
  3. every kernel against its plain PyTorch version on the card, with
     both timed, at the shapes of the paths below (bit equality: each
     candidate is one f32 add followed by a min, and the scans keep the
     TPU kernels' span schedules): rsweep at 180x63 (S=1 and 4 both
     directions, two lane blocks, and one 1,280-lane block, which takes
     the kernel's device-memory route), with its microseconds per row,
     and in float64 (S=1 and 4 both directions, and a 640-lane block
     whose float64 ring does not fit in shared memory: the device-memory
     route), then the float64 sweep on the card: auto at 180x63 equal to
     the CPU route in the JAX package's 15 rounds (JAX_F64_180) and the
     48x12 solve from node 0 in C.10's 4 rounds;
     titer at 180x63
     (S=1 and S=2, dup 4) and at 176x40 (S=2, dup 0), in float32 and
     (180x63 S=1, 176x40 S=2) float64, with its device time by kernel;
     band, which takes
     the field and rolls theta itself, against its plain version on the
     5 rolled pages at 1080x300 (S=1 and S=2), at the warm level's
     coarse grid (540 theta rows) and on 5 theta rows, where the wrap
     folds the rows onto each other, in float32 and float64, and a
     float64 window too wide for shared memory refused by name; (3b) witer at 183x63 (S=1 and S=2,
     dup 73), at 256x63 (S=2, dup 0) and in float64 at 183x63 (S=1),
     with its device time by kernel, at 128x100 and 1080x300 (S=1),
     where a chain column or a ring row spans several warps, and in
     float64 at 1080x300, 47x63 (the band's 32-lane tile) and 31x63 (its
     taps read from global memory); diag at
     127x63 (dup 1) and at 183x63 in float32 and float64, alone and as
     diag_step (the fan and the changed flag), and the diag engine's
     ring and chain scans at 127x63 (float32, float64) and on its first
     1,031 rows (an odd count); (3c)
     sweep3d (T sweeps of the 26-tap 3-D stencil) in float32 at (7,5,4)
     S=1 and (130,6,3) S=3 (256 lanes), in float64 at (8,8,3) and at
     (600,4,3) S=8 (640 lanes in chunks of 128), and at
     the 3-D path's 128x128x64 at S=1 and S=7 (T=8), with the bytes a
     call reads from device memory in this design (13 weights a node a
     sweep) and in one that reads all 26 each sweep; (3e) plane3d (one
     directional pass of the 3-D sweep engine) on the (9,6,5) test wedge
     at star 1 and 2, float32 and float64, every axis and direction, S=1
     and S=3 with carry_init across an opened face, on (35,5,61) (odd
     lines) on one block and on clusters of 2, 4 and 8, on planes of
     which only two or one fit in one block's shared memory and on a
     256x256 plane that none holds (clusters of 16), and one pass along
     each axis at 128x128x64 at S=1 and S=8, timed; (3d) relax at
     180x63 (S=1 and S=8, finite pad rows in the input) and in float64
     at 24x12 (S=2), fused (the whole
     solve in one cooperative launch) at 24x12 (S=2, T=3: ntheta 24 takes
     the modular ring shifts; float32 and float64), at 48x12 and 180x63
     with S=8 (the table's width) and at 180x63 with S=1, each with the
     same iterations as its plain version; (3f) bfm_step (one
     Bellman-Ford-Moore iteration on the padded ELL graph) in lockstep
     with its plain version, every field of the state equal after every
     step, over whole solves: at 180x63 (init_annulus, the reference's
     benchmark graph) S=1 and S=8 in float32, at 48x12 (spacing 150,
     halo) S=2 and on the production Delaunay annulus in float64, on the
     3-D graph of example_grid3d (24x24x16, S=3); timed over the 180x63
     solve with its bound from each step's frontier; (3g) banded_sweep
     (Jacobi iterations of the banded solve, many a cooperative launch)
     and banded_gs (a Gauss-Seidel direction) against their plain
     versions from the start field to the fixpoint, banded_sweep in
     launches of 1, 8 and the whole solve's iterations (every launch's
     field, flag and iteration count equal to the plain version's after
     as many iterations), banded_gs after every direction: on the
     production Delaunay annulus in float32 (the JAX package's 214 steps
     and 33 rounds), float64 and float32 S=8, with both kernels' routes
     that keep nothing in shared memory forced (float64), on the nr=12
     mesh in its natural order (S=2) and on 16x6 with its halo (S=2);
     the shared and global routes of banded_sweep both taken; the whole
     solve's launch timed with its device time an iteration against an
     iteration's bound; (3h) the
     level-masked bfm_step in lockstep with its plain version over
     bfm_ms's two masked stages (level 1, then level 15 restarted at the
     best Boundary_1 node) at 48x12, float32 and float64, the same `it`;
     rsweep on every destination-masked stage table of bfm_ms (levels 1
     and 15) and of PcP at 180x63, both directions, float32 and float64
     (blocks without a finite tap included), timed on level 1's table;
     (3i) paths (the predecessor walk with its COO and dense sensitivity
     rows) on the 180x63 sweep prev (150 receivers, max_len 972), on
     16x6 with its halo and on its tree with a 3-cycle and the source's
     entry -1, float64 and float32, in the three call forms (nodes, COO,
     dense): nodes and ids bit-equal, vals and dense rows within 1e-12 /
     1e-6 relative, two launches' dense rows equal; bend (the Adam
     bend in one launch) in lockstep with its twin on the five paths of
     tests/test_torch_refine.py, 2-D and 3-D, 10 and 50 steps: float64
     within 1e-6 s and 1e-3 km, float32 within twice the twin's own
     spread under a one-ulp nudge of its input (measured in the run);
     chunks equal to one launch; the 150-path --refine fan at 800 steps
     in float64 at or below its input and within twice the JAX package's
     float64 spread of the twin (JAX_REFINE_SPREAD64), timed in float32
     and float64; a table-shaped sub-batch (1,024 x 384 x 2, quad 16,
     float64) in lockstep after 10 steps and, after 200, at or below its
     input and within twice the twin's spread under a 1e-9 km nudge,
     timed;
     (3j) gridsearch (the locator's grid search: a lane's column tile
     against its warp's events, one reduction an (event, block), the
     whole catalogue in one call) against its twin on the card in both
     formulas (direct, expanded) and float32 and float64: at the
     location path's shape (the 12 station fields of the 180x63 graph, 64
     events, and the one event of `locate`) and on odd cases (K 7 over
     3,617 columns with non-finite and duplicated columns, K 100 past a
     chunk of K, an all-inf row),
     under the tie rule of ops/gridsearch_check.py (the misfit at the
     pick within the tolerance of the minimum, m and t0 to the twin's at
     that node, ids equal where no tie; float64 within 1e-12 of m in the
     direct formula and of its terms in the expanded one, float32 within
     1e-4 of m in the direct formula and a few ulps of the terms in the
     expanded one, t0 within 1e-3 s besides; exact duplicates at the
     first index), timed;
  4. the main path through the user entry points: init_annulus_circulant
     (180, 63, 20) -> AnnulusSolver(method="auto") on cuda -> solve with
     prev -> receiver fan -> paths -> travel-time CSV, held against the
     JAX package's anchors and the same solve on the CPU; the device time
     of three steady solves by kernel (torch.profiler) and the device's
     busy and idle share of the steady solve;
  5. the port's main_annulus CLI on the 180x63 grid into a temporary
     directory, and again with --dtype float64 (the JAX package's float64
     times at 60 and 150 degrees);
  6. AnnulusSolver(method="twrapped") at 180x63 (the titer kernel),
     held to the anchors and to phase 4's sweep field at every node; a
     float64 twrapped solve at 48x12 equal to the same solve on the CPU;
  7. rsweep at the 1080x300 sweep solve's tables (S=1, both directions)
     against its plain version, timed; then AnnulusSolver(method=
     "stream") at 1080x300 with warm level 1 (the
     band kernel), held to the same solve on the CPU at every node, and
     to the sweep solve of the same grid at the surface receivers
     (2e-3 s) and at every node (ENGINE_ATOL, see there); rsweep in
     float64 at 1080x300's tables; a float64 stream solve at 48x12 equal
     to the same solve on the CPU;
  8. travel_time_table of 8 sources x 150 receivers at 180x63 on
     'sweep' and 'twrapped', each row held to its single-source solve;
  9. AnnulusSolver(method="auto") at 183x63, which routes to 'wrapped'
     (the witer kernel), held to the JAX package's iteration count and
     spread from 'stream', to a tol=1e-5 stream solve at every node
     (2e-3 s), to 'stream' at the surface receivers (2e-3 s) and at every
     node (ENGINE_ATOL); explicit 'wrapped' at 180x63 held to the anchors
     and to the sweep field at every node; an 8 x 150 table; a
     device-resident result through the travel-time CSV and the npz;
 10. AnnulusSolver(method="auto") at 127x63, which routes to 'diag' (the
     diag kernel and its scans, an iteration in one launch call), held
     to the JAX package's iteration count and spread from 'stream', and
     to 'stream' and a tol=1e-5 stream solve at every node
     (ENGINE_ATOL); a float64 diag solve at 47x6 equal to the same solve
     on the CPU; explicit 'diag' at 180x63 held to the anchors and to
     the sweep field (ENGINE_ATOL);
 11. the 3-D path at 128x128x64 (1,048,576 nodes) on the chip-campaign
     wedge of benchmarks/chip_dsweep3d.py: grid3d -> prepare3d ->
     solve3d(engine="auto"), which takes the kernel engine (the sweep3d
     kernel): the 3x3 surface table held to the JAX package's (JAX_WEDGE,
     0.01 s); a single-source full-field solve held bit-equal, with the
     same iterations, to the same route on the CPU (the plain twin); the
     64-source x 1024-receiver table (source batch 7), three of its rows
     held to single-source solves (5e-3 s); recover_prev3d equal to the
     CPU recovery, three backtraces descending to the source;
 12. the port's example_grid3d CLI at its defaults on the card, its
     table held to the root example's (JAX_EXAMPLE, 0.01 s);
 13. AnnulusSolver(method="pallas") (the relax kernel) and
     AnnulusSolver(method="fused") (the fused kernel) at 180x63, through
     the entry points of phase 4: the anchors, the JAX package's
     iterations and spread from a tol=1e-5 twrapped solve (JAX_CONTRIB),
     pallas within ENGINE_ATOL of the sweep field and fused within 2e-3 s
     of the tight solve at every node, the prev tree equal to
     recover_prev with as many receiver paths reaching the source
     without a cycle as in the JAX package (ROADMAP C.9), a 48x12 solve
     bit-equal to the same route on the CPU, an 8 x 150 table (S=8) with
     three rows held to single solves;
 14. the 3-D sweep engine at 128x128x64 (phase 11's grid):
     solve3d(engine="sweep") for one source and for 8 sources in one
     group (the plane3d kernel, 6 launches a round), each within rtol
     1e-6 / atol 5e-3 s of the kernel engine's field in at most
     MAX_ROUNDS rounds; star 2 (98 taps), where auto takes the sweep
     engine, within 1e-3 s of the star-2 xla engine and at or below star
     1 + 1e-3 s; solve3d_reflection (PcP) and solve3d_converted (SKS) on
     the test wedges of tests/test_grid3d_disc.py equal to the CPU route;
 15. the reference's benchmark: bfm(A, halo, source, gr, Vp) on
     init_annulus(180, 63) (the bfm_step kernel), dist and prev equal to
     the JAX package's digests in its 266 iterations (JAX_BFM_180), the
     anchors, the receiver walks that reach the source (C.9), within
     ENGINE_ATOL of the port's auto sweep field on the same graph; the
     host prepare and the steady solve timed;
 16. AnnulusSolver(method="auto") on the production Delaunay annulus:
     the JAX package's warning, 'banded' (one launch of the
     banded_sweep kernel) in 214 iterations, the field equal to the JAX
     digest (JAX_BANDED), prev
     from the host PrevRecovery; solve_banded_gs (the banded_gs kernel)
     in 33 rounds equal to its JAX digest; in float64 the Gauss-Seidel
     field within 1e-9 s of the Jacobi one and that within 1e-9 s of
     dijkstra; an 8-source table timed, rows equal to single solves;
 17. main_annulus --method ell at 180x63 (the anchors) and --method
     banded at 48x12 (its CSV equal to the CPU route's), example_grid3d
     --engine ell (within T_ATOL of the root example's table);
 18. the staged solvers on init_annulus(180, 63) (AK135, the surface
     source), each held to the JAX package's figures (JAX_STAGED,
     tools/jax_staged_reference.py: the iteration count, the finite set,
     the receiver times, the field's digest, or else the CPU route within
     CPU_ATOL at every finite node), its launches counted (one band an
     iteration, two rsweep a round) and its steady solve timed (median of
     3): bfm_ms at levels (1, 15) on stream, sweep and ell (dist and prev
     digests; one steady solve of each profiled, its kernel's device time
     and the card's busy share), reflected_travel_times (PcP) and the SKS class on stream
     and sweep, bfm_multiphase on stream and sweep (3 levels) and on ell
     at 48x12; stream and sweep within ENGINE_ATOL of each other;
 19. main_annulus --phases PcP,SKS at 180x63, its CSV's times held to the
     JAX package's;
 20. the paths slice: main_annulus --refine at 180x63 (one bend launch),
     its refined CSV within twice the JAX package's float32 spread of
     its times (JAX_REFINE, JAX_REFINE_SPREAD) and at or below the SPM
     CSV; AnnulusSolver.sensitivity_matrix at 180x63 for the 150
     receivers (one paths launch) equal to the CPU route, timed;
     refined_travel_time_table for 8 sources x 150 receivers at its
     defaults (m 384, quad 16, 1600 steps, multistart), timed with the
     bend's share; example_tomography at its defaults (12 paths
     launches), its misfit reduction and correlation within 0.02 of the
     JAX package's (JAX_TOMO).  The --refine run also takes --q 600 --freq
     1 (the amplitude CSV, checked in 21);
 21. location and amplitudes at 180x63 (benchmarks/chip_locate.py's
     workload: phase 3f's graph, AK135 Vp, 12 stations every 30 degrees,
     64 events from default_rng(0) with 0.2 s of noise): station_fields
     cold (3j) and warm, one gridsearch launch timed, locate_many with
     Gauss-Newton (one launch) against the CPU route on the same fields
     (tie rule; positions within 1e-6 km and t0 within 1e-9 s where the
     picks agree) and the JAX package's hits and errors (JAX_LOCATE: 2
     hits, 10 % + 1 km); bend=True on 8 events (8 bend launches); one P+S
     locate_phases event (the S fields inf in the liquid core) found at
     its node; locate_many3d on a 64x64x32 wedge, 8 stations, 16 on-grid
     events found within 1e-6 km and 1e-9 s; example_location at its
     defaults within 10 % of the JAX driver's (JAX_EXAMPLE_LOCATION);
     phase 20's amplitude CSV at 30, 60, 90 and 150 degrees: spreading,
     the PcP/P ratio and valid within 1e-9 relative of the JAX CLI's
     (JAX_AMPLITUDE), t* along the bent polylines within 5e-3;
 22. the xla sweep engine (the surface source, float32), all six modes,
     at 180x63 but r and kernel-r at 48x12 (their radial sweeps are the
     plain `_sweep_r`, ~54 k launches a sweep at 180x63): each mode's
     rounds equal to the JAX package's (JAX_SHARD,
     tools/jax_shard_reference.py), t(60) and t(150) within CPU_ATOL of
     its and, at 180x63, at the anchors, each field within ENGINE_ATOL of
     the pallas route at its size (C.5; kernel-r, seam-blind, printed),
     tsweep launched twice a round where the mode has column sweeps
     (3k: tsweep bit-equal to its plain twin _sweep in float32 and
     float64, both directions, col_relax on and off, with and without
     carry_init, at 48x12 (every case) and 180x63 (four covering
     cases), S=1 and S=8, at 90x80 (1,664 lanes: two a thread) and with
     two and four lanes a thread forced at 180x63; timed);
 23. a one-rank NCCL group on cuda:0 (a one-rank mesh runs no
     collective, as a one-device JAX mesh): every multisource table at
     180x63, 8 x 150 (ell, twrapped, stream, sweep, circulant; the 3-D
     table 64 x 1024 on the pallas engine), each bit-equal to the
     single-device table; the theta-sharded solve at 180x63 (D = 1) in
     the JAX package's rounds with its bits; the slab solve at
     128x128x64 within ENGINE_ATOL of the single-device sweep solve; the
     sharded bend of the --refine fan equal to refine_paths_batch;
 24. two ranks sharing cuda:0 over gloo (launch.run_group; the
     exchanges staged through host memory): the theta-sharded solve at
     D = 2 in the JAX package's rounds with its bits, its time a round
     and the share of one round's exchange, fan minimum and vote; the
     2x1 (source, theta) mesh, each row equal to its one-rank solve; the
     slab solve with 2 slabs along phi within ENGINE_ATOL of the sweep
     solve; every multisource table over 2 ranks (the ELL one on the
     48x12 graph, each rank preparing its copy): sweep, twrapped, stream
     and ELL equal to single-device blocks of 4 (a rank's batch), the
     circulant and 3-D tables (a source at a time) to phase 23's
     one-rank tables; the bend over 2 ranks equal to one rank's; then,
     in a group of its own, which gloo collectives take CUDA tensors
     (all_reduce, broadcast, barrier, all_gather, then isend/irecv, whose
     failure may end the group: the probe reports where);
 25. the reference-faithful mesh (init_annulus(..., faithful=True), the
     reference mesher's duplicated coincident secondary nodes; constants
     from tools/jax_faithful_reference.py): at 180x50 spacing 50 the
     counts and digests of benchmarks/faithful_digests.json exactly and
     the float64 auto field's 150 receiver times within 5.1e-5 s of its
     4-decimal Dijkstra times; at 180x63 spacing 20 (205,021 nodes, its
     adjacency on the native g++ builder, asserted) AnnulusSolver(method=
     "auto") -> sweep with rsweep at M = 1,139 slots a column, float32
     within 2e-3 s of the anchors, the prev tree, the paths and the CSV,
     the receiver walks that reach the source equal to the JAX package's
     count, rsweep on these tables bit-equal to its plain version (its
     route and time a launch printed), the Chrome trace of
     utils.profiling.trace naming the rsweep kernel; float64 auto in the
     JAX package's rounds and walks within 1e-5 s of Dijkstra; twrapped
     (the titer kernel) within ENGINE_ATOL of the sweep field;
     main_annulus --model iasp91 --wave Vs --dtype float64 --nr 63
     --cache-dir within 1e-5 s of Dijkstra, cold then warm (the cache
     read, not rewritten; --plot writes the PNG, or refuses by name
     where matplotlib cannot be imported); iteration_stats at 48x12 on
     the card equal to the CPU route's.
Every kernel-launch count is set to 0 just before each path (4, 6, 7,
9, 10, 11, 13, 14, 15, 16, 17, each solve of 18, 19, each path of 20,
21, 22, 23, 24 and each solve and CLI run of 25) and read just after
it.  Then one JSON
line of kernel numbers, the card's name and power limit from nvidia-smi,
and as the last line {"ok": true, "device": {...}}.  The kernels line
lists eighteen kernels:
the eight Pallas counterparts, the diag engine's two scans, plane3d, the
generic graphs' bfm_step, banded_sweep and banded_gs, the paths slice's
paths and bend, the location slice's gridsearch, and the multi-device
slice's tsweep.

Needs no network and writes only to a temporary directory and to the
package's `_build/`.  Without CUDA, or without the package beside it, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# JAX package's values on this grid (surface source, AK135 Vp)
T60_REF, T150_REF, T_ATOL = 610.742, 1050.994, 0.01
CPU_ATOL = 2e-3          # two tol units of f32 termination slack
MAX_ROUNDS = 10
TABLE_SOURCES, TABLE_RECEIVERS = 8, 150
# One engine against another over every node.  Every engine stops once
# no node improves by more than tol = 1e-3 s in one iteration or round,
# and that slack adds up (ROADMAP C.5): on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit, at 1080x300 the default-tol sweep sat up to 8.9 ms
# above a stream solve run to tol = 1e-5 and the warm stream up to
# 7.9 ms (the two differed by up to 8.1 ms, in the inner core); at
# 183x63 the stream itself sits up to 3.9 ms above it, so 'wrapped'
# (within 1.8 ms of it) differs from 'stream' by 2.5 ms.  'diag' also
# sits up to 4.4 ms BELOW the tol = 1e-5 solve: its ring scan's closed
# form (cumulative minima of b - j*c, then + j*c) rounds some sums below
# every real path (ROADMAP C.7).  The JAX package run on the CPU gives
# the same spreads (JAX_SPREAD).  Phases 7, 9 and 10 print each figure.
ENGINE_ATOL = 1e-2
TIGHT_TOL = 1e-5
# the JAX package's engines on the CPU (tools/jax_engine_spread.py):
# iterations of the engine, and its max |field - stream field| (s)
JAX_SPREAD = {"wrapped 183x63": (108, 2.50244140625e-3),
              "diag 127x63": (92, 4.2724609375e-3)}
# the JAX package's quarantined engines on the CPU at 180x63
# (tools/jax_contrib_reference.py): iterations (-1: fused keeps its count
# on the device) and the most the field sits above and below a twrapped
# solve at tol=1e-5 (124 iterations).  pallas sits below it: its ring
# scan's closed form rounds below the fixpoint (ROADMAP C.7).
# The last figure: how many of the 150 receivers' predecessor walks
# reach the source without a cycle (ROADMAP C.9).
JAX_CONTRIB = {"pallas": (95, 0.002685546875, 0.004364013671875, 6),
               "fused": (-1, 0.0008544921875, 0.0, 147),
               "twrapped tight": 124}
SPREAD_ATOL = 1e-6
# the JAX package's float64 sweep at 180x63 on the CPU (tol 0 in float64:
# it runs until no node improves): rounds, t(60), t(150)
# (tools/jax_float64_reference.py)
JAX_F64_180 = (15, 610.7424599684254, 1050.9944170319238)
# ROADMAP C.10: the float64 sweep at 48x12 (spacing 150) from node 0
C10_ROUNDS, C10_TMAX = 4, 610.4519199802852
# The JAX package's 3x3 travel-time tables (s) on the CPU, float32, 3
# surface sources x 3 surface receivers (tools/jax_grid3d_reference.py):
# the root example_grid3d.py at its defaults (24x24x16, xla engine), and
# the 128x128x64 chip-campaign wedge (xla engine, scan_every 0).
JAX_EXAMPLE = [[118.82701110839844, 231.0539093017578, 447.36053466796875],
               [218.8846435546875, 231.0298309326172, 225.4295654296875],
               [426.60101318359375, 424.41326904296875, 156.23204040527344]]
JAX_WEDGE = [[96.63719177246094, 207.28045654296875, 444.18426513671875],
             [198.22744750976562, 207.27886962890625, 242.14430236816406],
             [427.5814514160156, 423.6245422363281, 137.81248474121094]]
WEDGE_DIMS = (128, 128, 64)
TABLE3D_SOURCES, TABLE3D_RECEIVERS, TABLE3D_BATCH = 64, 1024, 7
# a source group's row against its single-source solve: the tolerance of
# the JAX package's test_solve3d_source_batched_matches_single
BATCH_ATOL = 5e-3
# The JAX package's generic-graph solvers on the CPU
# (tools/jax_graph_reference.py), float32, AK135 Vp, the surface source at
# theta 0.  bfm on init_annulus(180, 63, spacing=20): iterations, the
# receiver walks of the 150-receiver fan that reach the source (ROADMAP
# C.9), and sha256 of dist (float32) and prev (int64).  solve_banded and
# solve_banded_gs (block 512, passes 2) on the production Delaunay annulus
# (DELAUNAY, node_adjacency star 0, no halo): iterations (rounds) and the
# sha256 of the field.
JAX_BFM_180 = (266, 150,
               "28a0279bc5c499916c808bcb125761b9ce84055d56a8cae8df7c8d41043ffac8",
               "d017b590cf3e31b75262887a93ebe9fc7f6ea6dd4f7af580610f7814dd7adebb")
JAX_BANDED = {
    "jacobi": (214, "2062a7ccf1a12eef69a330d87e6bef8ab42701eb6b0857b91f07cc437cda1068"),
    "gs": (33, "2062a7ccf1a12eef69a330d87e6bef8ab42701eb6b0857b91f07cc437cda1068")}
DELAUNAY = dict(nr=60, spacing=120.0)   # benchmarks/chip_banded_gs.py
# The JAX package's staged solvers on the CPU (tools/jax_staged_reference.py)
# on init_annulus(180, 63, spacing=20), float32, AK135 Vp (Vs for the S
# legs), the surface source at theta 0; bfm_multiphase on 'ell' at
# init_annulus(48, 12, spacing=150).  Per solve: iterations summed over
# the stages (rounds on 'sweep'; each level's count on 'ell'), finite
# nodes, sha256 of the packed finite mask and of dist (float32), the
# times at the surface receivers at 30, 60 and 90 degrees, and on 'ell'
# sha256 of prev (int64).
JAX_STAGED = {
    'bfm_ms stream': (
        49, 4500,
        'f77c572759449ddf952af5d889c815247006f75a061fb2ed0a1330fe1e892d10',
        '478a106610fb9e8668c5a1e81c05da6269ad763f9630d06bd8af90a3c0fdbe6e',
        (573.6251220703125, 1146.844482421875, 1720.073974609375)
    ),
    'bfm_ms sweep': (
        7, 5095,
        '04cc0be107fdf0691de8ff5ea8b130afae8c8fd55416663431b981ef797ae17d',
        '4e7849c4e677703236326bc073361bb8295e765167c13441cf2f79f3eb241bc9',
        (573.6251220703125, 1146.84423828125, 1720.073486328125)
    ),
    'bfm_ms ell': (
        [47, 47], 4500,
        'f77c572759449ddf952af5d889c815247006f75a061fb2ed0a1330fe1e892d10',
        '478a106610fb9e8668c5a1e81c05da6269ad763f9630d06bd8af90a3c0fdbe6e',
        (573.6251220703125, 1146.844482421875, 1720.073974609375),
        '432cde09800597f4b3fdd7ec1aaff5bb06a718595c528abb05808ea45d950e41'
    ),
    'PcP stream': (
        114, 97020,
        '6b979adc3c0f731bc50dd861d8286c373f71807af9121a06cf7488c77e04a2b0',
        'd08a0e3ef187c843b38d8fb565d170c3f5fa5f99cb416bac421e131ac084bcd2',
        (554.53759765625, 656.6795654296875, 785.3890380859375)
    ),
    'PcP sweep': (
        7, 97020,
        '6b979adc3c0f731bc50dd861d8286c373f71807af9121a06cf7488c77e04a2b0',
        '5d6a0454ecb07ea33827fbdd0ea2bfb5e32ddfaf195c6ab63562598010fd0940',
        (554.53759765625, 656.6795654296875, 785.3890380859375)
    ),
    'SKS stream': (
        179, 97020,
        '6b979adc3c0f731bc50dd861d8286c373f71807af9121a06cf7488c77e04a2b0',
        '81b813dae1d772887aeb311c0efc969e802ae251219dcc43174299ccb54e4072',
        (1018.7841796875, 1209.6473388671875, 1420.60498046875)
    ),
    'SKS sweep': (
        10, 97020,
        '6b979adc3c0f731bc50dd861d8286c373f71807af9121a06cf7488c77e04a2b0',
        '246ba87870de08da3a8d3c38e3a42359d950f0be523ac526e6714aa2d7ad1f56',
        (1018.7841796875, 1209.6473388671875, 1420.60498046875)
    ),
    'bfm_multiphase stream': (
        95, 4500,
        'f77c572759449ddf952af5d889c815247006f75a061fb2ed0a1330fe1e892d10',
        'b2d53d71a7f19a7076f28f86a561e3dc75614f5944ee7db9f3f87f11f0ab078f',
        (573.6251220703125, 1146.844482421875, 1720.073974609375)
    ),
    'bfm_multiphase sweep': (
        7, 4500,
        'f77c572759449ddf952af5d889c815247006f75a061fb2ed0a1330fe1e892d10',
        'cdff4388819faa2d4625b84ffc2058f24347d11b7670fce73db8fcf96a24c380',
        (573.6251220703125, 1146.84423828125, 1720.073486328125)
    ),
    'bfm_multiphase 48x12 ell': (
        [14, 15, 0], 576,
        '44def26eabcbdbd585476147a57f3b4e6774dc4dc8164d08b9462c581097923d',
        'b69ec2a116926c28aad341e5cbc5f6179f0e780e786d18c7c80ea9624aa7aac9',
        (572.645751953125, 1144.3504638671875, 1716.0550537109375),
        'd08a48958277bb69bfb1071be1a48dbd0588d02cad06ad7dfd8ed941ce92373c'
    ),
}
STAGED_DEGREES = (30.0, 60.0, 90.0)
# The JAX package's bending refinement on the CPU
# (tools/jax_refine_reference.py): the root main_annulus.py --nr 63
# --refine at 180x63, float32 as that driver runs (its solver's CPU route,
# the 150-receiver fan, refine_paths_batch at m 128, 800 steps, quad 8);
# the refined times, and the most any of them moves when the input
# polylines are nudged (four nudges: one float32 ulp of each coordinate,
# since a 1e-9 km nudge is below float32's resolution there; in float64
# under x64, 1e-9 km).  800 Adam steps at lr 3 have not settled: vertices
# slide along the ray, where the time is flat, so the port is held to
# twice that spread.  And the root example_tomography.py at its defaults
# (float64 under x64).
JAX_REFINE = [38.341129302978516, 62.71937561035156, 90.16062927246094,
              117.62275695800781, 145.01702880859375, 172.38230895996094,
              199.69662475585938, 226.4705810546875, 251.56549072265625,
              274.03717041015625, 295.55810546875, 316.78631591796875,
              334.4834289550781, 352.44696044921875, 370.20599365234375,
              387.48828125, 405.0798645019531, 422.4538879394531,
              439.3857421875, 455.9944152832031, 472.61968994140625,
              488.7898864746094, 504.6390075683594, 520.33251953125,
              535.7432861328125, 550.860107421875, 565.5847778320312,
              579.7648315429688, 594.2508544921875, 607.8329467773438,
              621.5660400390625, 634.9871826171875, 648.0535888671875,
              660.8041381835938, 673.1753540039062, 685.2875366210938,
              697.252685546875, 708.6790161132812, 719.90185546875,
              730.8634033203125, 741.5142211914062, 751.8594360351562,
              761.8701171875, 771.5941162109375, 781.0046997070312,
              790.2298583984375, 799.4046020507812, 808.4691162109375,
              817.4832153320312, 826.384033203125, 835.27197265625,
              844.1682739257812, 853.0650024414062, 861.958251953125,
              870.8348999023438, 879.7122192382812, 888.65185546875,
              897.5272216796875, 906.4127197265625, 915.3251953125,
              924.0955200195312, 933.2236328125, 941.9900512695312,
              950.8284301757812, 959.8421630859375, 968.640380859375,
              977.6717529296875, 986.5660400390625, 995.3448486328125,
              1004.290283203125, 1013.252197265625, 1022.122314453125,
              1030.879638671875, 1039.889404296875, 1048.65380859375,
              1048.65380859375, 1039.889404296875, 1030.879638671875,
              1022.122314453125, 1013.252197265625, 1004.290283203125,
              995.3448486328125, 986.5660400390625, 977.6717529296875,
              968.640380859375, 959.8421630859375, 950.8284301757812,
              941.9900512695312, 933.2236328125, 924.0955200195312,
              915.3251953125, 906.4127197265625, 897.5272216796875,
              888.65185546875, 879.7122192382812, 870.8348999023438,
              861.958251953125, 853.0650024414062, 844.1682739257812,
              835.27197265625, 826.384033203125, 817.4832153320312,
              808.138916015625, 799.0538330078125, 790.2298583984375,
              780.5072021484375, 771.5941162109375, 761.8701171875,
              751.8594360351562, 741.5142211914062, 730.8634033203125,
              719.90185546875, 708.6790161132812, 697.252685546875,
              685.2875366210938, 673.1753540039062, 660.8041381835938,
              648.0535888671875, 634.9871826171875, 621.5660400390625,
              607.8329467773438, 594.2508544921875, 579.7648315429688,
              565.5847778320312, 550.860107421875, 535.7432861328125,
              520.33251953125, 504.6390075683594, 488.7898864746094,
              472.61968994140625, 455.9944152832031, 439.3857421875,
              422.4538879394531, 405.0798645019531, 387.48828125,
              370.20599365234375, 352.44696044921875, 334.4834289550781,
              316.78631591796875, 295.55810546875, 274.03717041015625,
              251.56549072265625, 226.4705810546875, 199.69662475585938,
              172.38230895996094, 145.01702880859375, 117.62275695800781,
              90.16062927246094, 62.71937561035156, 38.341129302978516]
JAX_REFINE_SPREAD = 0.347137451171875      # s, float32, one-ulp nudges
JAX_REFINE_SPREAD64 = 0.2969410109733417    # s, float64, 1e-9 km nudges
JAX_TOMO = {'misfit0': 166.3869370505062, 'misfit1': 12.6883003705345,
            'corr': 0.340739033992204}
# wrapper -> the CUDA kernels it launches, by their names in a profile
KERNEL_NAMES = {"band": ("band_kernel",),
                "banded_sweep": ("banded_jacobi_kernel",),
                "rsweep": ("rsweep_shared", "rsweep_global"),
                "bfm_step": ("push_step_kernel", "relax_merge_kernel",
                             "frontier_kernel"),
                "gridsearch": ("search_kernel", "finish_kernel")}
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores, same sheet
H100_F64_OPS_PER_S = 34e12   # f64 outside the tensor cores, same sheet
H100_F64_TC_OPS_PER_S = 67e12   # f64 matrix products in the tensor cores


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _smi() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])


def _cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of fn() over n calls, timed with CUDA events
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def _launch_counters():
    """name -> the wrapper whose `launches` counts that kernel."""
    from raytracer_tpu_torch.contrib import fused_circulant, pallas_circulant
    from raytracer_tpu_torch.ops import (diag_circulant, diag_wrapped,
                                         stream_t, sweep3d, sweep_theta,
                                         wrapped_t)

    from raytracer_tpu_torch.ops import (banded, bend, gridsearch, paths,
                                         plane3d, relax)

    return {"rsweep": sweep_theta.rsweep, "titer": wrapped_t.titer,
            "band": stream_t.band, "witer": diag_wrapped.witer,
            "diag": diag_circulant.diag_sweep,
            "ring_scan": diag_circulant.ring_scan,
            "chain_scan": diag_circulant.chain_scan,
            "sweep3d": sweep3d.sweep3d_T, "relax": pallas_circulant.relax,
            "fused": fused_circulant.fused,
            "plane3d": plane3d.plane_sweep3d, "bfm_step": relax.bfm_step,
            "banded_sweep": banded.banded_step, "banded_gs": banded.banded_gs,
            "paths": paths.paths, "bend": bend.bend,
            "gridsearch": gridsearch.grid_search, "tsweep": sweep_theta.tsweep}


def _reset_counts():
    for fn in _launch_counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def _max_err(got, want) -> float:
    """Max abs difference over finite entries; inf when the +inf
    patterns differ."""
    import torch

    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        return float("inf")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _reaching(prev, source, receivers) -> list:
    """The receivers whose predecessor walk reaches `source` without
    meeting a node twice.  A walk that meets a cycle never reaches it
    (recontruct_path would walk n nodes and then append the source)."""
    out = []
    for r in receivers:
        node, seen = r, set()
        while node != source and node not in seen:
            seen.add(node)
            node = int(prev[node])
        if node == source:
            out.append(r)
    return out


def _steady_ms(solver, source, n):
    """Median host milliseconds of n single-source solves, each one
    between two synchronizes."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(source, want_prev=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _bound_ms(nbytes: float, ops: float, ops_per_s=H100_F32_OPS_PER_S):
    t_b, t_o = nbytes / H100_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _kernel_split_ms(fn, n: int) -> dict:
    """Device milliseconds per call of fn, by CUDA kernel (and copy),
    from torch.profiler's CUDA trace over n calls after one warm-up.
    Host-side operator entries (aten::...) also carry the device time of
    the kernels they launched; those kernels are counted under their own
    names, so the host entries are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a window now and then comes back without device events (seen on
    # the card for a phase's first profile): take the next one
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_time_total > 0 for e in events):
            break
    out = {}
    for e in events:
        t = e.device_time_total
        if t > 0 and e.device_type != DeviceType.CPU:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0].split("<")[0]
            name = name.strip()
            out[name] = out.get(name, 0.0) + t / 1e3 / n
    return out


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    from raytracer_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    release = [ln for ln in _run([nvcc, "--version"]).splitlines()
               if "release" in ln]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    print("phase 1 environment: "
          f"python={sys.version.split()[0]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} triton={triton_version} nvcc={nvcc} "
          f"({release[0].strip() if release else 'release unknown'}) "
          f"ninja={'present' if shutil.which('ninja') else 'absent'} "
          f"device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} smi=[{_smi()}]", flush=True)


def phase_build():
    from raytracer_tpu_torch import kernels

    names = sorted(f[:-3] for f in os.listdir(kernels.CSRC_DIR)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        secs = dict(zip(names, pool.map(kernels.build, names)))
    for name in names:
        kernels.load(name)
    print(f"phase 2 build: {len(names)} kernel(s) in "
          f"{time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{n}={s:.2f}s" for n, s in secs.items()), flush=True)


def _rsweep_buffer(rng, rst, nt, S, upward, dtype=None):
    """Random T-layout field at the main path's layout: finite travel
    times with some +inf (unreached) cells in the field rows, +inf pad
    rows and pad lanes (float32 unless `dtype` says otherwise)."""
    import numpy as np
    import torch

    dtype = dtype or np.float32
    buf = np.full((S, rst.MT + rst.K8, rst.NTL), np.inf, dtype)
    vals = rng.uniform(0.0, 1500.0, (S, rst.MT, nt)).astype(dtype)
    vals[rng.random(vals.shape) < 0.3] = np.inf
    off = rst.K8 if upward else 0
    buf[:, off: off + rst.MT, :nt] = vals
    return torch.from_numpy(buf).cuda()


def _rsweep_work(wtab, rst, nt, S, upward):
    """(bytes, operations, finite weights) of one sweep: the buffer read
    and written once, the weight and tap tables read once; one add and
    one min per real theta lane for every finite (row, tap) weight."""
    import numpy as np

    taps = rst.taps_up if upward else rst.taps_dn
    w = wtab.cpu().numpy()
    item = w.dtype.itemsize
    cols = [iw for _, _, iw in taps]
    finite = int(np.isfinite(w[:, cols]).sum())
    nbytes = (2 * S * (rst.MT + rst.K8) * rst.NTL * item + w.size * item
              + len(taps) * 3 * 4)
    return nbytes, 2 * finite * nt * S, finite


def _rsweep_check(rng, cases, nt, wdn, wup) -> float:
    """Each (statics, S, upward) case through the kernel and the plain
    version on the same random field; raises unless bit-equal.  Returns
    the largest abs difference (0.0)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops.sweep_theta import rsweep, rsweep_reference

    dtype = np.float64 if wdn.dtype == torch.float64 else np.float32
    max_err = 0.0
    for st, S, up in cases:
        buf = _rsweep_buffer(rng, st, nt, S, up, dtype)
        wtab = wup if up else wdn
        out_k = rsweep(buf.clone(), wtab, st, up)
        out_r = rsweep_reference(buf.clone(), wtab, st, up)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        max_err = max(max_err, err)
        if not torch.equal(out_k, out_r):
            raise AssertionError(
                f"rsweep kernel != plain version ({np.dtype(dtype).name}, "
                f"S={S}, upward={up}, NTB={st.NTB}/{st.NTL}): max abs err "
                f"{err}")
    return max_err


def phase_kernels(rec: dict):
    import numpy as np

    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops.sweep_theta import (_kernel_tables,
                                                     device_tables, rsweep,
                                                     rsweep_reference)
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    _, cg, _ = init_annulus_circulant(180, 63, spacing=20.0)
    ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
    _, static, wdn, wup, rst = device_tables(ws, cg, np.float32, "cuda")
    nt = static.nt
    blocked = rst._replace(NTB=rst.NTL // 2)
    # the same taps on one 1,280-lane block: the ring would not fit in
    # shared memory, so the kernel takes its device-memory route
    wide = rst._replace(NTL=1280, NTB=1280)
    rng = np.random.default_rng(0)
    cases = [(rst, 1, False), (rst, 1, True), (rst, 4, False),
             (rst, 4, True), (blocked, 2, False), (blocked, 2, True),
             (wide, 1, False), (wide, 1, True)]
    max_err = _rsweep_check(rng, cases, nt, wdn, wup)
    routes = sorted({"shared" if _kernel_tables(wup if up else wdn, st,
                                                up)[0].shared else "global"
                     for st, _, up in cases})
    times = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": [],
             "finite": []}
    for up in (False, True):
        wtab = wup if up else wdn
        buf = _rsweep_buffer(rng, rst, nt, 1, up)
        times["ms"].append(_cuda_ms(lambda: rsweep(buf, wtab, rst, up), 20))
        times["plain_ms"].append(
            _cuda_ms(lambda: rsweep_reference(buf, wtab, rst, up), 2))
        nbytes, ops, finite = _rsweep_work(wtab, rst, nt, 1, up)
        times["finite"].append(finite)
        t_b, t_o = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
        times["bound_ms"].append(1e3 * max(t_b, t_o))
        times["bound_by"].append("bytes" if t_b >= t_o else "operations")
    buf4 = _rsweep_buffer(rng, rst, nt, 4, False)
    ms4 = _cuda_ms(lambda: rsweep(buf4, wdn, rst, False), 10)
    # float64: the same cases, and the 640-lane block whose float64 ring
    # does not fit in shared memory (its float32 one does): the kernel's
    # device-memory route
    _, cg64, _ = init_annulus_circulant(180, 63, spacing=20.0,
                                        dtype=np.float64)
    ws64 = pack_twrapped_stencil(cg64, dtype=np.float64, band_closure=0)
    _, _, wdn64, wup64, rst64 = device_tables(ws64, cg64, np.float64, "cuda")
    mid64 = rst64._replace(NTL=640, NTB=640)
    cases64 = [(rst64, 1, False), (rst64, 1, True), (rst64, 4, False),
               (rst64, 4, True), (mid64, 1, False), (mid64, 1, True)]
    max_err = max(max_err, _rsweep_check(rng, cases64, nt, wdn64, wup64))
    routes64 = {f"{st.NTB} lanes": "shared" if _kernel_tables(
        wup64 if up else wdn64, st, up)[0].shared else "global"
        for st, _, up in cases64}
    assert routes64 == {"256 lanes": "shared", "640 lanes": "global"}, \
        routes64
    assert _kernel_tables(wdn, rst._replace(NTL=640, NTB=640),
                          False)[0].shared      # float32: the ring route
    ms64 = []
    for up in (False, True):
        wtab = wup64 if up else wdn64
        buf = _rsweep_buffer(rng, rst64, nt, 1, up, np.float64)
        ms64.append(_cuda_ms(lambda: rsweep(buf, wtab, rst64, up), 20))
    f64 = _f64_auto_gates()
    rec["rsweep"] = {
        "max_abs_err": max_err,
        "ms": statistics.mean(times["ms"]),
        "plain_ms": statistics.mean(times["plain_ms"]),
        "bound_ms": statistics.mean(times["bound_ms"]),
        "bound_by": times["bound_by"][0],
    }
    print(f"phase 3 kernels: rsweep bit-equal to rsweep_reference in "
          f"{len(cases)} cases (S=1,4 both directions; lane-blocked "
          f"NTB={blocked.NTB}<NTL={rst.NTL}; one {wide.NTB}-lane block, "
          f"both directions; routes {routes}); at S=1 (MT={rst.MT}, "
          f"K8={rst.K8}, NTL={rst.NTL}, {len(rst.taps_dn)}+"
          f"{len(rst.taps_up)} taps, {times['finite'][0]}/"
          f"{times['finite'][1]} finite (row, tap) weights) kernel down/up "
          f"{times['ms'][0]:.4f}/{times['ms'][1]:.4f} ms = "
          f"{1e3 * times['ms'][0] / rst.MT:.3f}/"
          f"{1e3 * times['ms'][1] / rst.MT:.3f} us per row, plain "
          f"{times['plain_ms'][0]:.1f}/{times['plain_ms'][1]:.1f} ms, "
          f"bound {times['bound_ms'][0]:.5f}/{times['bound_ms'][1]:.5f} ms "
          f"({times['bound_by'][0]}); kernel at S=4 down {ms4:.4f} ms; "
          f"float64 bit-equal in {len(cases64)} cases (S=1,4 both "
          f"directions; routes {routes64}), kernel down/up at S=1 "
          f"{ms64[0]:.4f}/{ms64[1]:.4f} ms = "
          f"{ms64[0] / times['ms'][0]:.2f}/{ms64[1] / times['ms'][1]:.2f}x "
          f"float32; {f64}", flush=True)


def _f64_auto_gates() -> str:
    """The float64 sweep on the card (ROADMAP C.11): AnnulusSolver(
    method="auto") at 180x63 equal to the CPU route node for node in the
    JAX package's rounds, its anchors within T_ATOL; the 48x12 (spacing
    150) solve from node 0 in C.10's 4 rounds to its largest time.
    Returns a line that says so."""
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U = rt.init_annulus_circulant(180, 63, 20.0, dtype=np.float64)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    out = {}
    for device in ("cuda", "cpu"):
        solver = rt.AnnulusSolver(gr, None, None, U,
                                  rt.SolverConfig(dtype="float64"),
                                  method="auto", circulant=cg, device=device)
        t0 = time.perf_counter()
        d = solver.solve(source, want_prev=False).dist
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = (d, solver.last_iterations, solver.method,
                       time.perf_counter() - t0)
    (d_k, it_k, m_k, t_k), (d_c, it_c, _, t_c) = out["cuda"], out["cpu"]
    rounds, t60_ref, t150_ref = JAX_F64_180
    assert m_k == "sweep" and d_k.dtype == np.float64, m_k
    assert it_k == it_c == rounds, (it_k, it_c)
    assert np.array_equal(d_k, d_c), float(np.abs(d_k - d_c).max())
    tt = {deg: float(d_k[rt.closest_point(gr, np.deg2rad(deg), rt.R,
                                          system="polar")])
          for deg in (60.0, 150.0)}
    assert abs(tt[60.0] - T60_REF) <= T_ATOL, tt
    assert abs(tt[150.0] - T150_REF) <= T_ATOL, tt
    assert abs(tt[60.0] - t60_ref) <= 1e-9 and abs(tt[150.0] - t150_ref) \
        <= 1e-9, tt
    g48, cg48, U48 = rt.init_annulus_circulant(48, 12, 150.0,
                                               dtype=np.float64)
    s48 = rt.AnnulusSolver(g48, None, None, U48,
                           rt.SolverConfig(dtype="float64"), method="sweep",
                           circulant=cg48)
    d48 = s48.solve(0, want_prev=False).dist
    tmax = float(np.max(d48[np.isfinite(d48)]))
    assert s48.last_iterations == C10_ROUNDS and tmax == C10_TMAX, \
        (s48.last_iterations, tmax)
    return (f"float64 auto at 180x63 on the card: {m_k}, {it_k} rounds (the "
            f"JAX package's {rounds}), equal to the CPU route at every node, "
            f"t(60)={tt[60.0]:.6f} s, t(150)={tt[150.0]:.6f} s, first solve "
            f"{t_k:.3f} s (CPU route {t_c:.1f} s); float64 sweep at 48x12 "
            f"from node 0: {s48.last_iterations} rounds, largest time "
            f"{tmax!r} s (C.10)")


def phase_main_path(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.main_annulus import receiver_degrees

    t_build = time.perf_counter()
    gr, cg, U = rt.init_annulus_circulant(180, 63, spacing=20.0)
    t_build = time.perf_counter() - t_build
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")

    solver = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    degs = receiver_degrees()
    receivers = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                 for d in degs]
    paths = [rt.recontruct_path(D.prev, source, r) for r in receivers]
    csv_path = os.path.join(tmp, "main_path_travel_times.csv")
    tt = rt.travel_times(D, gr, receivers, isave=True, flname=csv_path)
    launches = counts["rsweep"]
    rounds = solver.last_iterations

    assert solver.method == "sweep", solver.method
    assert str(solver.device).startswith("cuda"), solver.device
    assert rounds is not None and 1 <= rounds <= MAX_ROUNDS, rounds
    assert launches == 2 * rounds, (launches, rounds)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert abs(t60 - T60_REF) <= T_ATOL, t60
    assert abs(t150 - T150_REF) <= T_ATOL, t150
    for r, p in zip(receivers, paths):
        assert p[0] == r and p[-1] == source and len(p) > 1, (r, p[:3])
    reach = _reaching(D.prev, source, receivers)
    with open(csv_path) as f:
        assert len(f.read().strip().splitlines()) == len(degs) + 1

    cpu = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg,
                           device="cpu")
    d_cpu = cpu.solve(source, want_prev=False).dist
    err_cpu = float(np.abs(D.dist - d_cpu).max())
    assert err_cpu <= CPU_ATOL, err_cpu

    steady_ms = _steady_ms(solver, source, 5)
    # device time of a steady solve by kernel, and the device's busy share
    split = _kernel_split_ms(lambda: solver.solve(source, want_prev=False),
                             3)
    busy = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = solver.recover_prev(D.dist)
    torch.cuda.synchronize()
    t_prev = time.perf_counter() - t0
    prev[source] = source
    assert np.array_equal(prev, D.prev)

    rec["rsweep"]["launches"] = launches
    rec["sweep_ms"] = steady_ms
    rec["sweep_180"] = (gr, cg, U, source, D, receivers, degs)
    print(f"phase 4 main path: {gr.nnods} nodes (grid {t_build:.2f} s), "
          f"method={solver.method} on {solver.device}, {rounds} rounds, "
          f"rsweep launches={launches}, t(60)={t60:.4f} s, "
          f"t(150)={t150:.4f} s, max |cuda - cpu| = {err_cpu:.3g} s, "
          f"{len(paths)} paths end at the source, {len(reach)} of them "
          f"without a cycle (ROADMAP C.9); first solve+prev "
          f"{t_first:.3f} s, steady solve median of 5 "
          f"{steady_ms:.2f} ms, prev recovery "
          f"{1e3 * t_prev:.2f} ms; launches on this path {counts}; device "
          f"ms per steady solve (torch.profiler, 3 solves) {busy:.3f} = "
          f"{100 * busy / steady_ms:.1f} % of the steady solve (idle "
          f"{100 * (1 - busy / steady_ms):.1f} %), by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in top[:8])
          + f" and {len(top) - 8} more" * (len(top) > 8),
          flush=True)


def phase_cli(tmp: str):
    from raytracer_tpu_torch import main_annulus

    prefix = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    main_annulus.main(["--ntheta", "180", "--nr", "63", "--out-prefix",
                       prefix])
    with open(f"{prefix}_travel_times.csv") as f:
        n_rows = len(f.read().strip().splitlines())
    assert n_rows == 151, n_rows
    assert os.path.getsize(f"{prefix}.npz") > 0
    t_cli = time.perf_counter() - t0
    # --dtype float64 (the JAX CLI's option): the float64 sweep on the card
    import numpy as np

    t0 = time.perf_counter()
    main_annulus.main(["--ntheta", "180", "--nr", "63", "--dtype", "float64",
                       "--out-prefix", f"{prefix}64"])
    tt = np.loadtxt(f"{prefix}64_travel_times.csv", delimiter=",",
                    skiprows=1)
    t60 = float(tt[np.argmin(np.abs(tt[:, 0] - 60.0)), 1])
    t150 = float(tt[np.argmin(np.abs(tt[:, 0] - 150.0)), 1])
    assert tt.shape == (150, 2), tt.shape
    assert abs(t60 - JAX_F64_180[1]) <= 1e-9, t60
    assert abs(t150 - JAX_F64_180[2]) <= 1e-9, t150
    with np.load(f"{prefix}64.npz") as f:
        assert f["dist"].dtype == np.float64
    print(f"phase 5 cli: main_annulus wrote {n_rows - 1} travel times and "
          f"the npz in {t_cli:.2f} s; with --dtype float64 in "
          f"{time.perf_counter() - t0:.2f} s, t(60)={t60!r} s, "
          f"t(150)={t150!r} s (the JAX package's float64 values)",
          flush=True)


def _titer_work(ws, st, S, iters):
    """(bytes, operations) of one titer launch: the field and the centre
    values read and written once, the tables read once (the band's
    weights as the stencil's finite ones, each with an int32 index, in
    the tables' dtype); one add and one min per candidate - ring and
    chain steps over the whole page, band taps only where the weight is
    finite (an +inf weight is no work a kernel must do), one band a row,
    the duplicate merge one min per merged lane, the fan's reduce and
    broadcast."""
    import numpy as np

    from raytracer_tpu_torch.ops.wrapped_t import _scan_plan

    ring_statics, n_ring, chain_statics, chain_rep, n_chain = _scan_plan(st)
    rows, ML, NTT = S * st.NTT, st.ML, st.NTT
    n_dm5 = (2 * st.maxdm + 1) * 5
    ring = 2 * 2 * ML * S * sum(NTT - s for s in ring_statics
                                + (16,) * n_ring)
    chain = 2 * rows * ML * (len(chain_statics) + n_chain) * 2
    finite = int(np.isfinite(ws.wrows[:n_dm5]).sum())
    dup = NTT - st.nt
    band = 2 * S * NTT * finite
    merge = 2 * dup * ML * S
    fan = 2 * 2 * rows * ML
    ops = iters * (ring + chain + band + merge + fan)
    item = ws.wrows.dtype.itemsize
    tables = item * sum(a.size for a in (ws.ring_f, ws.ring_b, ws.cfl,
                                         ws.cbl, ws.fan_w))
    nbytes = item * (2 * rows * ML + 2 * S) + tables + (item + 4) * finite
    return nbytes, ops


def _band_work(wrows, maxdm, S, nt, ML):
    """(bytes, operations) of one band sweep in the field form the kernel
    takes: the field read once, the output written once, the weight rows
    read once; one add and one min per finite weight entry per (source,
    theta row)."""
    import numpy as np

    w = wrows.cpu().numpy()[: (2 * maxdm + 1) * 5]
    nbytes = w.dtype.itemsize * (2 * S * nt * ML + wrows.numel())
    return nbytes, 2 * S * nt * int(np.isfinite(w).sum())


def _random_field(rng, shape, Mp, dtype=None):
    """Finite travel times with ~half +inf cells and +inf pad lanes
    [Mp, ML), the invariant the kernels' tables keep (float32 unless
    `dtype` says otherwise)."""
    import numpy as np
    import torch

    v = rng.uniform(0.0, 1500.0, shape).astype(dtype or np.float32)
    v[rng.random(shape) < 0.5] = np.inf
    v[..., Mp:] = np.inf
    return torch.from_numpy(v).cuda()


def phase_jacobi_kernels(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch import kernels
    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops import stream_t, wrapped_t

    rng = np.random.default_rng(5)
    titer_rows = []
    # the path's shape (180x63, S=1) first; S=2 and a dup-0 grid (176x40);
    # float64 at both shapes
    for ntheta, nr, S, dtype in ((180, 63, 1, np.float32),
                                 (180, 63, 2, np.float32),
                                 (176, 40, 2, np.float32),
                                 (180, 63, 1, np.float64),
                                 (176, 40, 2, np.float64)):
        _, cg, _ = init_annulus_circulant(ntheta, nr, spacing=20.0)
        ws = wrapped_t.pack_twrapped_stencil(cg, dtype=dtype, band_closure=1)
        st = wrapped_t.TWStatic(ws.Mp, ws.ML, ws.NTT, ws.nt, ws.maxdm)
        tbl = wrapped_t.device_twrapped_tables(ws, "cuda")
        dist = _random_field(rng, (S * ws.NTT, ws.ML), ws.Mp, dtype)
        cen = torch.tensor(rng.uniform(0.0, 1500.0, S).astype(dtype),
                           device="cuda")
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        d_k, c_k = wrapped_t.titer(st, dist, cen, tbl, 4)
        d_r, c_r = wrapped_t.titer_reference(st, dist, cen, tbl, 4)
        torch.cuda.synchronize()
        err = max(_max_err(d_k, d_r), _max_err(c_k, c_r))
        if not (torch.equal(d_k, d_r) and torch.equal(c_k, c_r)):
            raise AssertionError(
                f"titer kernel != plain version at {name} S={S} "
                f"(dup {ws.NTT - ws.nt}): max abs err {err}")
        ms = _cuda_ms(lambda: wrapped_t.titer(st, dist, cen, tbl, 4), 20)
        plain = _cuda_ms(lambda: wrapped_t.titer_reference(st, dist, cen,
                                                           tbl, 4), 2)
        if not titer_rows:  # the phase split at the path's shape (S=1)
            rec["titer_split"] = _kernel_split_ms(
                lambda: wrapped_t.titer(st, dist, cen, tbl, 4), 5)
        nbytes, ops = _titer_work(ws, st, S, 4)
        bound, by = _bound_ms(nbytes, ops)
        titer_rows.append(dict(
            grid=name, S=S, dup=ws.NTT - ws.nt, max_abs_err=err,
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, ops=ops))
    band_rows = []
    _, cg, _ = init_annulus_circulant(1080, 300, spacing=20.0)
    ws = wrapped_t.pack_twrapped_stencil(cg, dtype=np.float32,
                                         band_closure=1)
    coarse = stream_t._warm_stencils(ws, cg, np.float32, 1, 1)[0]
    ws64 = wrapped_t.pack_twrapped_stencil(cg, dtype=np.float64,
                                           band_closure=1)
    coarse64 = stream_t._warm_stencils(ws64, cg, np.float64, 1, 1)[0]
    # the stream path's levels (the fine grid at S=1 and 2, the warm
    # level's coarse grid) and 5 theta rows, where the wrap folds the
    # rows dc = -2..2 onto each other; float64 (ROADMAP C.11) on the
    # same shapes
    for name, w_, S, nt in (("1080x300", ws, 1, ws.nt),
                            ("1080x300", ws, 2, ws.nt),
                            ("1080x300 coarse", coarse, 1, coarse.nt),
                            ("1080x300, 5 rows", ws, 2, 5),
                            ("1080x300 f64", ws64, 1, ws64.nt),
                            ("1080x300 coarse f64", coarse64, 1,
                             coarse64.nt),
                            ("1080x300, 5 rows f64", ws64, 2, 5)):
        wrows = torch.tensor(w_.wrows, device="cuda")
        assert stream_t.band_smem_bytes(w_.maxdm, wrows.element_size()) \
            <= kernels.BLOCK_SMEM
        v = _random_field(rng, (S, nt, w_.ML), w_.Mp, w_.wrows.dtype)
        out_k = stream_t.band(v, wrows, w_.maxdm)
        out_r = stream_t.band_reference(stream_t._band_stack(v), wrows,
                                        w_.maxdm)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"band kernel != plain version at {name} "
                                 f"S={S}: max abs err {err}")
        ms = _cuda_ms(lambda: stream_t.band(v, wrows, w_.maxdm), 50)
        plain = _cuda_ms(lambda: stream_t.band_reference(
            stream_t._band_stack(v), wrows, w_.maxdm), 3)
        nbytes, ops = _band_work(wrows, w_.maxdm, S, nt, w_.ML)
        bound, by = _bound_ms(nbytes, ops)
        band_rows.append(dict(
            grid=name, S=S, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, nbytes=nbytes, ops=ops))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    for name, rows in (("titer", titer_rows), ("band", band_rows)):
        # times at the main paths' shape (S=1), errors over every case
        rec[name] = {k: rows[0][k] for k in keys}
        rec[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    # a window wider than an H100 block's shared memory is refused by
    # name before the launch (the widest the stream engine builds here is
    # maxdm=8)
    v64 = _random_field(rng, (1, 5, 1024), 1024, np.float64)
    wide = torch.zeros((5 * (2 * 391 + 1), 1024), dtype=torch.float64,
                       device="cuda")
    try:
        stream_t.band(v64, wide, 391)
        raise AssertionError("band took a 391-lane window in float64")
    except ValueError as e:
        assert "232448" in str(e), e
    print("phase 3a kernels: titer (T=4) bit-equal to titer_reference: "
          + "; ".join(f"{r['grid']} S={r['S']} dup={r['dup']}: kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['ops'] / 1e9:.3f} G ops)" for r in titer_rows)
          + ". titer at 180x63 S=1 by kernel (torch.profiler, device ms per "
          "launch; ring_kernel also merges the duplicate rows and applies "
          "the fan, band_kernel folds the centre): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rec["titer_split"].items())
          + ". band (field form) bit-equal to band_reference on the "
          "rolled stack: "
          + "; ".join(f"{r['grid']} S={r['S']}: kernel {r['ms']:.4f} ms, "
                      f"plain {r['plain_ms']:.2f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e6:.1f} M "
                      f"ops)" for r in band_rows),
          flush=True)


def phase_twrapped(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U, source, D_sweep, receivers, degs = rec["sweep_180"]
    solver = rt.AnnulusSolver(gr, None, None, U, method="twrapped",
                              circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    assert solver.method == "twrapped", solver.method
    assert counts["titer"] > 0 and counts["titer"] * 4 == iters, \
        (counts, iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    tt = rt.travel_times(D, gr, receivers)
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert abs(t60 - T60_REF) <= T_ATOL, t60
    assert abs(t150 - T150_REF) <= T_ATOL, t150
    err = float(np.abs(D.dist - D_sweep.dist).max())
    assert err <= CPU_ATOL, err
    rec["titer"]["launches"] = counts["titer"]
    rec["twrapped_solver"] = solver
    rec["twrapped_ms"] = _steady_ms(solver, source, 3)
    f64 = _f64_against_cpu(rt, "twrapped", 48, 12, 150.0)
    print(f"phase 6 twrapped: {gr.nnods} nodes, method={solver.method}, "
          f"{iters} iterations, titer launches={counts['titer']} "
          f"(path counts {counts}), t(60)={t60:.4f} s, t(150)={t150:.4f} s,"
          f" max |twrapped - sweep| = {err:.3g} s over every node; first "
          f"solve {t_first:.3f} s, steady solve median of 3 "
          f"{rec['twrapped_ms']:.2f} ms; {f64}", flush=True)


def _f64_against_cpu(rt, method, ntheta, nr, spacing):
    """A float64 solve of `method` on the card equal to the same solve on
    the CPU (the plain versions), node for node, with the same
    iterations; returns a line that says so."""
    import numpy as np

    gr, cg, U = rt.init_annulus_circulant(ntheta, nr, spacing,
                                          dtype=np.float64)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    out = []
    for device in ("cuda", "cpu"):
        solver = rt.AnnulusSolver(gr, None, None, U,
                                  rt.SolverConfig(dtype="float64"),
                                  method=method, circulant=cg, device=device)
        d = solver.solve(source, want_prev=False).dist
        assert solver.method == method and d.dtype == np.float64
        out.append((d, solver.last_iterations))
    (d_k, it_k), (d_c, it_c) = out
    assert it_k == it_c and np.array_equal(d_k, d_c), (method, it_k, it_c)
    return (f"float64 {method} at {ntheta}x{nr} on the card equals the CPU "
            f"route ({it_k} iterations, largest time "
            f"{np.max(d_k[np.isfinite(d_k)]):.6f} s)")


def phase_stream(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.main_annulus import receiver_degrees
    from raytracer_tpu_torch.ops.stream_t import auto_warm_levels
    from raytracer_tpu_torch.ops.sweep_theta import (_kernel_tables,
                                                     device_tables, rsweep)

    gr, cg, U = rt.init_annulus_circulant(1080, 300, spacing=20.0)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    sweep = rt.AnnulusSolver(gr, None, None, U, method="sweep", circulant=cg)
    d_sweep = sweep.solve(source, want_prev=False).dist
    rounds = sweep.last_iterations
    # the radial kernel at this grid's tables, against its plain version
    _, st7, wdn, wup, rst7 = device_tables(sweep._packed(sweep=True), cg,
                                           np.float32, "cuda")
    rng = np.random.default_rng(3)
    err7 = _rsweep_check(rng, [(rst7, 1, False), (rst7, 1, True)], st7.nt,
                         wdn, wup)
    rs7 = []
    for up in (False, True):
        wtab = wup if up else wdn
        buf = _rsweep_buffer(rng, rst7, st7.nt, 1, up)
        nbytes, ops, _ = _rsweep_work(wtab, rst7, st7.nt, 1, up)
        rs7.append((_cuda_ms(lambda: rsweep(buf, wtab, rst7, up), 10),
                    _kernel_tables(wtab, rst7, up)[0].shared,
                    *_bound_ms(nbytes, ops)))
    # float64 at this grid's tables: the ring needs 229,824 of the 232,448
    # bytes, still the shared-memory route
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    ws64 = pack_twrapped_stencil(cg, dtype=np.float64, band_closure=0)
    _, _, wdn64, wup64, rst64 = device_tables(ws64, cg, np.float64, "cuda")
    err7 = max(err7, _rsweep_check(rng, [(rst64, 1, False), (rst64, 1, True)],
                                   st7.nt, wdn64, wup64))
    rs7_64 = []
    for up in (False, True):
        wtab = wup64 if up else wdn64
        buf = _rsweep_buffer(rng, rst64, st7.nt, 1, up, np.float64)
        rs7_64.append((_cuda_ms(lambda: rsweep(buf, wtab, rst64, up), 10),
                       _kernel_tables(wtab, rst64, up)[0].shared))
    rec["rsweep"]["max_abs_err"] = max(rec["rsweep"]["max_abs_err"], err7)
    solver = rt.AnnulusSolver(gr, None, None, U, method="stream",
                              circulant=cg)
    assert auto_warm_levels(cg.ntheta) == 1 and solver.config.warm_levels \
        is None
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    assert solver.method == "stream", solver.method
    assert counts["band"] == iters > 0, (counts, iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    err_all = float(np.abs(D.dist - d_sweep).max())
    assert err_all <= ENGINE_ATOL, err_all
    recs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in receiver_degrees()]
    err_rec = float(np.abs(D.dist[recs] - d_sweep[recs]).max())
    assert err_rec <= CPU_ATOL, err_rec
    cpu = rt.AnnulusSolver(gr, None, None, U, method="stream", circulant=cg,
                           device="cpu")
    t0 = time.perf_counter()
    d_cpu = cpu.solve(source, want_prev=False).dist
    t_cpu = time.perf_counter() - t0
    err_cpu = float(np.abs(D.dist - d_cpu).max())
    assert err_cpu <= CPU_ATOL, err_cpu
    assert cpu.last_iterations == iters, (cpu.last_iterations, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    iters_by = {}
    fields = {}
    for name, cfg in (("cold", rt.SolverConfig(warm_levels=0)),
                      ("tight", rt.SolverConfig(warm_levels=0, tol=TIGHT_TOL,
                                                max_iters=5000))):
        s_ = rt.AnnulusSolver(gr, None, None, U, cfg, method="stream",
                              circulant=cg)
        fields[name] = s_.solve(source, want_prev=False).dist
        iters_by[name] = s_.last_iterations
    ref = fields["tight"]
    above = {name: float((d - ref).max()) for name, d in
             (("sweep", d_sweep), ("warm stream", D.dist),
              ("cold stream", fields["cold"]))}
    for name, a in above.items():
        assert -CPU_ATOL <= a <= ENGINE_ATOL, (name, a)
    rec["band"]["launches"] = counts["band"]
    rec["stream_ms"] = 1e3 * steady
    f64 = _f64_against_cpu(rt, "stream", 48, 12, 150.0)
    print(f"phase 7 rsweep at 1080x300 (MT={rst7.MT}, K8={rst7.K8}, "
          f"NTL={rst7.NTL}, {len(rst7.taps_dn)}+{len(rst7.taps_up)} taps): "
          f"bit-equal to rsweep_reference at S=1 both directions; kernel "
          f"down/up " + "/".join(f"{r[0]:.4f}" for r in rs7) + " ms = "
          + "/".join(f"{1e3 * r[0] / rst7.MT:.3f}" for r in rs7)
          + " us per row, bound " + "/".join(f"{r[2]:.5f}" for r in rs7)
          + f" ms ({rs7[0][3]}), "
          + ("shared-memory" if rs7[0][1] else "device-memory") + " route; "
          f"float64 bit-equal, kernel down/up "
          + "/".join(f"{r[0]:.4f}" for r in rs7_64) + " ms, "
          + ("shared-memory" if rs7_64[0][1] else "device-memory")
          + " route", flush=True)
    print(f"phase 7 stream: 1080x300, {gr.nnods} nodes, warm level 1, "
          f"{iters} iterations over both levels, band launches="
          f"{counts['band']} (path counts {counts}); max |cuda - cpu| = "
          f"{err_cpu:.3g} s over every node (the CPU solve through the "
          f"plain versions took {t_cpu:.1f} s, same iterations); max "
          f"|stream - sweep| = {err_rec:.3g} s over the {len(recs)} "
          f"surface receivers and {err_all:.3g} s over every node (sweep "
          f"{rounds} rounds); first solve {t_first:.3f} s, steady solve "
          f"{1e3 * steady:.1f} ms; cold stream {iters_by['cold']} "
          f"iterations; against a cold stream solve at tol={TIGHT_TOL:g} "
          f"({iters_by['tight']} iterations) the most any node sits above "
          f"is " + ", ".join(f"{n} {a:.3g} s" for n, a in above.items())
          + f"; {f64}", flush=True)


def phase_tables(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U, _, _, receivers, _ = rec["sweep_180"]
    recs = np.asarray(receivers[:TABLE_RECEIVERS])
    assert len(recs) == TABLE_RECEIVERS
    srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(0.0, 315.0, TABLE_SOURCES)]
    parts = []
    for method in ("sweep", "twrapped"):
        solver = rt.AnnulusSolver(gr, None, None, U, method=method,
                                  circulant=cg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = solver.travel_time_table(srcs, recs, batch=8)
        torch.cuda.synchronize()
        t_table = time.perf_counter() - t0
        single = np.stack([solver.solve(s, want_prev=False).dist[recs]
                           for s in srcs])
        assert table.shape == (TABLE_SOURCES, TABLE_RECEIVERS)
        assert np.isfinite(table).all()
        err = float(np.abs(table - single).max())
        assert err <= CPU_ATOL, (method, err)
        parts.append(f"{method}: {1e3 * t_table:.1f} ms, max |table - "
                     f"single solves| = {err:.3g} s"
                     f"{' (bit-equal)' if err == 0.0 else ''}")
    print(f"phase 8 tables: {TABLE_SOURCES} sources x {TABLE_RECEIVERS} "
          f"receivers at 180x63, batch=8; " + "; ".join(parts), flush=True)


def _witer_work(ws, S, iters):
    """(bytes, operations) of one witer launch: the field and the centre
    values read and written once, the tables read once (the band's taps
    as the kernel's per-row lists); one add and one min per candidate -
    ring and chain steps over the whole field, band taps only where a
    diagonal's weight is finite (one band per lane; the duplicate merge
    is one min per merged lane), the fan's reduce and broadcast."""
    import numpy as np

    from raytracer_tpu_torch.ops.diag_wrapped import (_chain_plan,
                                                      _ring_plan,
                                                      wrapped_tap_lists)

    ring_statics, n_ring = _ring_plan(ws.NTL)
    chain_statics, _, n_chain = _chain_plan(ws.Mp)
    Mp, NTL, NTLT = ws.Mp, ws.NTL, S * ws.NTL
    dup = NTL - ws.nt
    ring = 2 * 2 * Mp * S * sum(NTL - s for s in ring_statics
                                + (16,) * n_ring)
    chain = 2 * 2 * Mp * NTLT * (len(chain_statics) + n_chain)
    finite = int(np.isfinite(ws.wpT[:ws.D, :Mp]).sum())
    band = 2 * NTLT * finite
    merge = 2 * dup * Mp * S
    fan = 2 * 2 * Mp * NTLT
    ops = iters * (ring + chain + band + merge + fan)
    item = ws.wpT.dtype.itemsize
    taps = sum(a.nbytes for a in wrapped_tap_lists(ws))
    tables = item * (ws.ring_f.size + ws.ring_b.size + ws.cfl.size
                     + ws.cbl.size + ws.fan_w.size)
    return item * (2 * Mp * NTLT + 2 * S) + tables + taps, ops


def _diag_work(ds):
    """(bytes, operations) of one diag sweep: the field read and written
    once, the stencil's finite (row, diagonal) weights that a row reads
    (source row in [0, Mp)) with their indices (the per-row tap lists)
    read once, in the stencil's dtype; one add and one min per theta
    lane for every such weight."""
    from raytracer_tpu_torch.ops.diag_circulant import diag_tap_lists

    tl = diag_tap_lists(ds)
    item = ds.wp.dtype.itemsize
    nbytes = item * 2 * ds.Mp * ds.NTL + sum(a.nbytes for a in tl)
    return nbytes, 2 * ds.ntheta * len(tl.w)


def _ring_scan_work(Mp, NTL, nt, itemsize):
    """(bytes, operations) of one ring scan: the field read and written
    once, the two hop costs a row; per theta lane and direction a
    product, a difference, two cumulative minima, three sums and two
    minima."""
    return itemsize * (2 * Mp * NTL + 2 * Mp), 2 * 9 * Mp * nt


def _chain_scan_work(Mp, NTL, itemsize):
    """(bytes, operations) of one chain scan: the field read and written
    once, the two chain costs a row; per lane an add and a min for each
    pair up the recursion's levels and each even value down them, both
    directions, and the final two minima."""
    pairs, n = 0, Mp
    while n >= 2:
        pairs += n // 2 + (n - 1) // 2
        n >>= 1
    return itemsize * (2 * Mp * NTL + 2 * Mp), 2 * (2 * pairs + Mp) * NTL


def phase_wrapped_diag_kernels(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant
    from raytracer_tpu_torch.ops import diag_circulant, diag_wrapped

    rng = np.random.default_rng(6)
    witer_rows = []
    # the path's shape (183x63, S=1) first; 128x100 (1,328 slots) and
    # 1080x300 (1,152 lanes) spread a chain column and a ring row over
    # several warps of a block; in float64 the band's coarse-theta tiles:
    # 47x63 with 32 lanes, 31x63 with its taps read from global memory
    for ntheta, nr, S, dtype in ((183, 63, 1, np.float32),
                                 (183, 63, 2, np.float32),
                                 (256, 63, 2, np.float32),
                                 (183, 63, 1, np.float64),
                                 (128, 100, 1, np.float32),
                                 (1080, 300, 1, np.float32),
                                 (1080, 300, 1, np.float64),
                                 (47, 63, 1, np.float64),
                                 (31, 63, 1, np.float64)):
        _, cg, _ = init_annulus_circulant(ntheta, nr, spacing=20.0)
        ws = diag_wrapped.pack_wrapped_stencil(cg, dtype=dtype)
        st = diag_wrapped.WStatic(ws.rho_starts, ws.Mp, ws.NTL, ws.pad2,
                                  ws.nt)
        tbl = diag_wrapped.device_wrapped_tables(ws, "cuda")
        # every lane of the wrapped cover is real data: no +inf pad lanes
        dist = _random_field(rng, (ws.Mp, S * ws.NTL), S * ws.NTL, dtype)
        cen = torch.tensor(rng.uniform(0.0, 1500.0, S).astype(dtype),
                           device="cuda")
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        d_k, c_k = diag_wrapped.witer(st, dist, cen, tbl, 4)
        d_r, c_r = diag_wrapped.witer_reference(st, dist, cen, tbl, 4)
        torch.cuda.synchronize()
        err = max(_max_err(d_k, d_r), _max_err(c_k, c_r))
        if not (torch.equal(d_k, d_r) and torch.equal(c_k, c_r)):
            raise AssertionError(
                f"witer kernel != plain version at {name} S={S} "
                f"(dup {ws.NTL - ws.nt}): max abs err {err}")
        ms = _cuda_ms(lambda: diag_wrapped.witer(st, dist, cen, tbl, 4), 20)
        plain = _cuda_ms(lambda: diag_wrapped.witer_reference(
            st, dist, cen, tbl, 4), 1)
        if not witer_rows:  # the phase split at the path's shape (S=1)
            rec["witer_split"] = _kernel_split_ms(
                lambda: diag_wrapped.witer(st, dist, cen, tbl, 4), 5)
        nbytes, ops = _witer_work(ws, S, 4)
        bound, by = _bound_ms(nbytes, ops)
        lanes, staged = diag_wrapped.witer_launch_plan(
            st, np.dtype(dtype).itemsize,
            diag_wrapped.band_block_taps(tbl.tap_ptr.cpu().numpy()))
        witer_rows.append(dict(
            grid=name, S=S, dup=ws.NTL - ws.nt, max_abs_err=err,
            tile=f"{lanes} lanes, taps in {'shared' if staged else 'global'}",
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, ops=ops))
    diag_rows = []
    for ntheta, dtype in ((127, np.float32), (183, np.float32),
                          (127, np.float64), (183, np.float64)):
        _, cg, _ = init_annulus_circulant(ntheta, 63, spacing=20.0)
        ds = diag_circulant.pack_diag_stencil(cg, dtype=dtype)
        st = diag_circulant.DiagStatic(ds.D, ds.Mp, ds.NTL, ds.pad,
                                       ds.ntheta)
        tbl = diag_circulant.device_diag_tables(ds, "cuda")
        dist = _random_field(rng, (ds.Mp, ds.NTL), ds.NTL, dtype)
        name = f"{ntheta}x63" + ("" if dtype == np.float32 else " f64")
        out_k = diag_circulant.diag_sweep(st, dist, tbl)
        out_r = diag_circulant.diag_sweep_reference(st, dist, tbl)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"diag kernel != plain version at {name}: "
                                 f"max abs err {err}")
        ms = _cuda_ms(lambda: diag_circulant.diag_sweep(st, dist, tbl), 50)
        plain = _cuda_ms(lambda: diag_circulant.diag_sweep_reference(
            st, dist, tbl), 3)
        # the sweep with the fan and the changed test: a changed and an
        # unchanged iteration
        sc = diag_circulant.device_diag_scan_tables(ds, "cuda")
        tol = torch.tensor(1e-3, dtype=dist.dtype, device="cuda")
        dcen = torch.tensor(300.0, dtype=dist.dtype, device="cuda")
        step = []
        for old in (dist, None):
            if old is None:  # the last step's own output: unchanged
                old, dcen = step[-1][0], step[-1][1]
            got = diag_circulant.diag_step(st, dist, tbl, sc, old, dcen, tol)
            want = diag_circulant.diag_step_reference(st, dist, tbl, sc, old,
                                                      dcen, tol)
            torch.cuda.synchronize()
            err = max(err, _max_err(got[0], want[0]),
                      _max_err(got[1], want[1]))
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])
                    and bool(got[2]) == bool(want[2])):
                raise AssertionError(f"diag_step != plain version at {name} "
                                     f"(changed {bool(want[2])})")
            step.append(want)
        assert bool(step[0][2]) and not bool(step[1][2]), "changed flags"
        nbytes, ops = _diag_work(ds)
        bound, by = _bound_ms(nbytes, ops)
        lanes, staged = diag_circulant.diag_launch_plan(
            st, np.dtype(dtype).itemsize,
            diag_circulant.band_block_taps(tbl.tap_ptr.cpu().numpy()))
        diag_rows.append(dict(
            grid=name, dup=ds.NTL - ds.ntheta, D=ds.D, max_abs_err=err,
            tile=f"{lanes} lanes, taps in {'shared' if staged else 'global'}",
            ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, nbytes=nbytes,
            ops=ops))
    # the scans at 127x63, and on its first 1,031 rows (an odd number of
    # slots: every level of the chain's recursion has an odd length then)
    scan_rows = []
    _, cg, _ = init_annulus_circulant(127, 63, spacing=20.0)
    for dtype, rows in ((np.float32, None), (np.float64, None),
                        (np.float32, 1031)):
        ds = diag_circulant.pack_diag_stencil(cg, dtype=dtype)
        if rows is not None:
            cut = dict(ring_f=ds.ring_f[:rows], ring_b=ds.ring_b[:rows],
                       chain_f=ds.chain_f[:rows], chain_b=ds.chain_b[:rows],
                       fan_w=ds.fan_w[:rows], Mp=rows)
            ds = dataclasses.replace(ds, **cut)
        sc = diag_circulant.device_diag_scan_tables(ds, "cuda")
        x = _random_field(rng, (ds.Mp, ds.NTL), ds.NTL, dtype)
        name = (f"127x63" + ("" if rows is None else f" first {rows} rows")
                + ("" if dtype == np.float32 else " f64"))
        for kname, kern, plain_fn, work in (
                ("ring_scan",
                 lambda: diag_circulant.ring_scan(x, sc, ds.ntheta),
                 lambda: diag_circulant._ring_scan(x, sc.ring_f, sc.ring_b,
                                                   ds.ntheta),
                 _ring_scan_work(ds.Mp, ds.NTL, ds.ntheta,
                                 np.dtype(dtype).itemsize)),
                ("chain_scan", lambda: diag_circulant.chain_scan(x, sc),
                 lambda: diag_circulant._chain_scan(x, sc.chain_f,
                                                    sc.chain_b),
                 _chain_scan_work(ds.Mp, ds.NTL, np.dtype(dtype).itemsize))):
            got, want = kern(), plain_fn()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"{kname} kernel != plain version at "
                                     f"{name}: max abs err {err}")
            bound, by = _bound_ms(*work)
            scan_rows.append(dict(
                kernel=kname, grid=name, max_abs_err=err,
                ms=_cuda_ms(kern, 50), plain_ms=_cuda_ms(plain_fn, 5),
                bound_ms=bound, bound_by=by))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    for name, rows in (("witer", witer_rows), ("diag", diag_rows),
                       ("ring_scan", [r for r in scan_rows
                                      if r["kernel"] == "ring_scan"]),
                       ("chain_scan", [r for r in scan_rows
                                       if r["kernel"] == "chain_scan"])):
        # times at the main paths' shapes (S=1; 127x63 for diag and the
        # scans), errors over every case
        rec[name] = {k: rows[0][k] for k in keys}
        rec[name]["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    rec["witer_rows"], rec["diag_rows"] = witer_rows, diag_rows
    print("phase 3b kernels: witer (T=4) bit-equal to witer_reference: "
          + "; ".join(f"{r['grid']} S={r['S']} dup={r['dup']} "
                      f"(band {r['tile']}): kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['ops'] / 1e9:.3f} G ops)" for r in witer_rows)
          + ". diag bit-equal to diag_sweep_reference, and with the fan and "
          "changed test (diag_step, a changed and an unchanged iteration) "
          "to diag_step_reference: "
          + "; ".join(f"{r['grid']} dup={r['dup']} D={r['D']} "
                      f"({r['tile']}): kernel "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e6:.1f} M "
                      f"ops)" for r in diag_rows)
          + ". the diag scans bit-equal to _ring_scan and _chain_scan: "
          + "; ".join(f"{r['kernel']} {r['grid']}: kernel {r['ms']:.4f} ms, "
                      f"plain {r['plain_ms']:.3f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
                      for r in scan_rows)
          + ". witer at 183x63 S=1 by phase (torch.profiler, device ms per "
          "launch; ring_kernel also merges the duplicate lanes and applies "
          "the fan, band_kernel folds the centre): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rec["witer_split"].items()),
          flush=True)


def _engine_checks(rt, gr, cg, U, source, d, name):
    """The stream and tol=1e-5 stream fields on this grid, and d's
    spread from them: (stream iterations, every-node and receiver
    |d - stream|, most above and below the tight field, receivers)."""
    import numpy as np

    from raytracer_tpu_torch.main_annulus import receiver_degrees

    stream = rt.AnnulusSolver(gr, None, None, U, method="stream",
                              circulant=cg)
    d_stream = stream.solve(source, want_prev=False).dist
    tight = rt.AnnulusSolver(gr, None, None, U,
                             rt.SolverConfig(warm_levels=0, tol=TIGHT_TOL,
                                             max_iters=5000),
                             method="stream", circulant=cg)
    d_tight = tight.solve(source, want_prev=False).dist
    recs = [rt.closest_point(gr, np.deg2rad(x), rt.R, system="polar")
            for x in receiver_degrees()]
    out = dict(
        stream_iters=stream.last_iterations,
        tight_iters=tight.last_iterations,
        all=float(np.abs(d - d_stream).max()),
        recs=float(np.abs(d[recs] - d_stream[recs]).max()),
        above=float((d - d_tight).max()), below=float((d - d_tight).min()),
        stream_above=float((d_stream - d_tight).max()))
    print(f"  {name}: max |{name} - stream| = {out['all']:.6g} s over every "
          f"node, {out['recs']:.3g} s over the {len(recs)} surface "
          f"receivers (stream {out['stream_iters']} iterations); against a "
          f"cold stream solve at tol={TIGHT_TOL:g} ({out['tight_iters']} "
          f"iterations) {name} sits at most {out['above']:.3g} s above and "
          f"{max(0.0, -out['below']):.3g} s below it, the default stream "
          f"{out['stream_above']:.3g} s above", flush=True)
    return out


def _anchors(rt, solver, receivers, degs, source):
    """(t(60), t(150), field) of a single solve at 180x63."""
    import numpy as np

    D = solver.solve(source, want_prev=False)
    tt = rt.travel_times(D, solver.gr, receivers)
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert abs(t60 - T60_REF) <= T_ATOL, (solver.method, t60)
    assert abs(t150 - T150_REF) <= T_ATOL, (solver.method, t150)
    return t60, t150, D.dist


def phase_wrapped(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U = rt.init_annulus_circulant(183, 63, spacing=20.0)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    solver = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    ref_iters, ref_spread = JAX_SPREAD["wrapped 183x63"]
    assert solver.method == "wrapped", solver.method
    assert counts["witer"] > 0 and counts["witer"] * 4 == iters, \
        (counts, iters)
    assert iters == ref_iters, (iters, ref_iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    chk = _engine_checks(rt, gr, cg, U, source, D.dist, "wrapped")
    assert abs(chk["all"] - ref_spread) <= SPREAD_ATOL, chk["all"]
    assert chk["all"] <= ENGINE_ATOL and chk["recs"] <= CPU_ATOL, chk
    assert -CPU_ATOL <= chk["below"] and chk["above"] <= CPU_ATOL, chk
    steady = _steady_ms(solver, source, 3)

    # a device-resident result through the outputs (ROADMAP C.1)
    Dd = solver.solve(source, device_dist=True)
    assert isinstance(Dd.dist, torch.Tensor) and Dd.dist.is_cuda
    _, _, _, _, D_sweep, receivers180, degs = rec["sweep_180"]
    recs = [rt.closest_point(gr, np.deg2rad(x), rt.R, system="polar")
            for x in degs]
    tt = rt.travel_times(Dd, gr, recs, isave=True,
                         flname=os.path.join(tmp, "wrapped_183.csv"))
    assert np.array_equal(tt, D.dist[recs])
    npz = os.path.join(tmp, "wrapped_183.npz")
    rt.save_solution_npz(npz, Dd, gr, source)
    with np.load(npz) as f:
        assert np.array_equal(f["dist"], D.dist)

    # 8 x 150 table against single solves
    srcs = [rt.closest_point(gr, np.deg2rad(x), rt.R, system="polar")
            for x in np.linspace(0.0, 315.0, TABLE_SOURCES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = solver.travel_time_table(srcs, np.asarray(recs), batch=8)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    single = np.stack([solver.solve(x, want_prev=False).dist[recs]
                       for x in srcs])
    assert table.shape == (TABLE_SOURCES, TABLE_RECEIVERS)
    err_table = float(np.abs(table - single).max())
    assert err_table <= CPU_ATOL, err_table

    # explicit 'wrapped' at 180x63: the anchors and the sweep field
    gr180, cg180, U180, source180 = (rec["sweep_180"][0], rec["sweep_180"][1],
                                     rec["sweep_180"][2], rec["sweep_180"][3])
    w180 = rt.AnnulusSolver(gr180, None, None, U180, method="wrapped",
                            circulant=cg180)
    t60, t150, d180 = _anchors(rt, w180, receivers180, degs, source180)
    err_sweep = float(np.abs(d180 - D_sweep.dist).max())
    assert err_sweep <= CPU_ATOL, err_sweep

    rec["witer"]["launches"] = counts["witer"]
    rec["wrapped_ms"] = steady
    rec["wrapped_launches"] = counts["witer"]
    print(f"phase 9 wrapped: 183x63, {gr.nnods} nodes, auto -> "
          f"{solver.method}, {iters} iterations (the JAX package: "
          f"{ref_iters}), witer launches={counts['witer']} (path counts "
          f"{counts}); first solve {t_first:.3f} s, steady solve median of "
          f"3 {steady:.2f} ms; a device_dist result through travel_times "
          f"and save_solution_npz equals the host one; 8x150 table "
          f"{1e3 * t_table:.1f} ms, max |table - single solves| = "
          f"{err_table:.3g} s; explicit wrapped at 180x63 "
          f"({w180.last_iterations} iterations): t(60)={t60:.4f} s, "
          f"t(150)={t150:.4f} s, max |wrapped - sweep| = {err_sweep:.3g} s "
          f"over every node", flush=True)


def phase_diag(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U = rt.init_annulus_circulant(127, 63, spacing=20.0)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    solver = rt.AnnulusSolver(gr, None, None, U, method="auto", circulant=cg)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source, want_prev=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    iters = solver.last_iterations
    ref_iters, ref_spread = JAX_SPREAD["diag 127x63"]
    assert solver.method == "diag", solver.method
    assert counts["diag"] == iters > 0, (counts, iters)
    assert iters == ref_iters, (iters, ref_iters)
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    chk = _engine_checks(rt, gr, cg, U, source, D.dist, "diag")
    assert abs(chk["all"] - ref_spread) <= SPREAD_ATOL, chk["all"]
    assert chk["all"] <= ENGINE_ATOL, chk
    assert -ENGINE_ATOL <= chk["below"] and chk["above"] <= ENGINE_ATOL, chk
    assert counts["ring_scan"] == counts["chain_scan"] == iters, counts
    steady = _steady_ms(solver, source, 3)
    # an iteration's scans on the converged field, and the whole
    # iteration
    from raytracer_tpu_torch.ops import diag_circulant as pdc

    ds = pdc.pack_diag_stencil(cg, dtype=np.float32)
    st = pdc.DiagStatic(ds.D, ds.Mp, ds.NTL, ds.pad, ds.ntheta)
    tbl = pdc.device_diag_tables(ds, "cuda")
    sc = pdc.device_diag_scan_tables(ds, "cuda")
    x = torch.full((ds.Mp, ds.NTL), float("inf"), device="cuda")
    valid = cg.cmap.m_of >= 0
    x[torch.as_tensor(cg.cmap.m_of[valid], device="cuda"),
      torch.as_tensor(cg.cmap.c_of[valid], device="cuda")] = torch.as_tensor(
        D.dist[valid], device="cuda")
    ring_ms = _cuda_ms(lambda: pdc.ring_scan(x, sc, ds.ntheta), 20)
    chain_ms = _cuda_ms(lambda: pdc.chain_scan(x, sc), 20)
    tol = torch.tensor(1e-3, device="cuda")
    dcen = torch.tensor(float(D.dist[cg.cmap.center]) if cg.cmap.center >= 0
                        else float("inf"), device="cuda")
    step_ms = _cuda_ms(lambda: pdc.diag_step(st, x, tbl, sc, x, dcen, tol,
                                             True), 20)
    f64 = _f64_against_cpu(rt, "diag", 47, 6, 400.0)

    gr180, cg180, U180, source180, D_sweep, receivers180, degs = \
        rec["sweep_180"]
    d180s = rt.AnnulusSolver(gr180, None, None, U180, method="diag",
                             circulant=cg180)
    t60, t150, d180 = _anchors(rt, d180s, receivers180, degs, source180)
    err_sweep = float(np.abs(d180 - D_sweep.dist).max())
    assert err_sweep <= ENGINE_ATOL, err_sweep
    for name in ("diag", "ring_scan", "chain_scan"):
        rec[name]["launches"] = counts[name]
    rec["diag_ms"] = steady
    rec["diag_launches"] = counts["diag"]
    print(f"phase 10 diag: 127x63, {gr.nnods} nodes, auto -> "
          f"{solver.method}, {iters} iterations (the JAX package: "
          f"{ref_iters}), diag launches={counts['diag']}, ring_scan "
          f"{counts['ring_scan']}, chain_scan {counts['chain_scan']} (path "
          f"counts {counts}); first solve {t_first:.3f} s, steady solve "
          f"median of 3 {steady:.2f} ms, of it per iteration the ring scan "
          f"{ring_ms:.4f} ms and the chain scan {chain_ms:.4f} ms each "
          f"alone, the whole iteration in one diag_step call (the scans, the "
          f"sweep, the fan and the changed test) {step_ms:.4f} ms (CUDA "
          f"events); {f64}; explicit diag at 180x63 "
          f"({d180s.last_iterations} iterations): t(60)={t60:.4f} s, "
          f"t(150)={t150:.4f} s, max |diag - sweep| = {err_sweep:.3g} s "
          f"over every node", flush=True)


def _wedge3d(dims, lo_deg, hi_deg, depth):
    """A (theta, phi, r) wedge grid, theta and phi in [lo, hi] deg, r from
    R - depth to R, and its AK135 Vp."""
    import numpy as np

    import raytracer_tpu_torch as rt

    g = rt.grid3d((np.deg2rad(lo_deg), np.deg2rad(lo_deg), rt.R - depth),
                  (np.deg2rad(hi_deg), np.deg2rad(hi_deg), rt.R), dims)
    prof = rt.velocity_profile("ak135")
    return g, rt.LinearInterpolation(prof.r, prof.Vp)(g.r)


def _sweep3d_work(W4, S, T, itemsize):
    """(bytes, operations, streamed bytes of a 26-weight design, streamed
    bytes of this design) of one sweep3d call of T sweeps.  The bound's
    bytes read each input once and write each output once: the weights
    and the S fields in, the S fields out.  One add and one min per
    finite weight per field per sweep.  The streamed bytes are the floor
    of a design that reads the weights from device memory in every sweep
    (at 1M nodes they exceed the 50 MB L2): all 26 a node in a kernel
    that reads W4, the 13 of the mirrored layout in this one."""
    import torch

    finite = int(torch.isfinite(W4).sum())
    field = W4.shape[0] * W4.shape[2] * W4.shape[3]
    nbytes = itemsize * (W4.numel() + 2 * S * field)
    streamed = itemsize * (T * W4.numel() + 2 * S * field)
    mirrored = itemsize * (T * W4.numel() // 2 + 2 * S * field)
    return nbytes, 2 * finite * S * T, streamed, mirrored


def _field3d(rng, plan, S, dtype):
    """S packed fields of random travel times, ~30 % +inf."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops.sweep3d import pack_field

    v = rng.uniform(0.0, 1500.0, (S,) + plan.shape)
    v[rng.random(v.shape) < 0.3] = np.inf
    return pack_field(torch.from_numpy(v.astype(dtype)).cuda(), plan)


def phase_sweep3d_kernel(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import sweep3d
    from raytracer_tpu_torch.solvers.solve3d import (_shifted_weights,
                                                     prepare3d)
    import raytracer_tpu_torch as rt

    rng = np.random.default_rng(7)
    max_err = 0.0
    small = []
    # the last case's four plane tiles of 8 float64 fields do not fit
    # with all 640 lanes: the kernel takes lane chunks of 128
    for dims, dtype, S, block_rows in (((7, 5, 4), np.float32, 1, 32),
                                       ((130, 6, 3), np.float32, 3, 32),
                                       ((8, 8, 3), np.float64, 1, 1024),
                                       ((600, 4, 3), np.float64, 8, 1024)):
        g, U = _wedge3d(dims, 80.0, 100.0, 600.0)
        plan = sweep3d.plan_sweep3d(_shifted_weights(g, U, dtype), block_rows)
        W4 = torch.from_numpy(plan.W4).cuda()
        f = _field3d(rng, plan, S, dtype)
        args = (W4, plan.n1, plan.BR, plan.NB, plan.L0, plan.H8, 3)
        out_k = sweep3d.sweep3d_T_batched(f, *args)
        out_r = sweep3d.sweep3d_reference(f, *args)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        max_err = max(max_err, err)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"sweep3d kernel != plain version at {dims} "
                                 f"{np.dtype(dtype).name} S={S}: max abs "
                                 f"err {err}")
        small.append(f"{dims} {np.dtype(dtype).name} S={S} L0={plan.L0}")

    t0 = time.perf_counter()
    g, U = _wedge3d(WEDGE_DIMS, 60.0, 120.0, 2500.0)
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = prepare3d(g, U, rt.SolverConfig(dtype="float32"))
    t_prep = time.perf_counter() - t0
    rec["wedge"] = (g, U, packed, t_grid, t_prep)
    plan = packed.plan
    W4 = torch.from_numpy(plan.W4).cuda()
    T = 8
    rows = []
    for S in (1, TABLE3D_BATCH):
        f = _field3d(rng, plan, S, np.float32)
        args = (W4, plan.n1, plan.BR, plan.NB, plan.L0, plan.H8, T)
        out_k = sweep3d.sweep3d_T_batched(f, *args)
        out_r = sweep3d.sweep3d_reference(f, *args)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        max_err = max(max_err, err)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"sweep3d kernel != plain version at "
                                 f"{WEDGE_DIMS} S={S}: max abs err {err}")
        ms = _cuda_ms(lambda: sweep3d.sweep3d_T_batched(f, *args), 10)
        plain = _cuda_ms(lambda: sweep3d.sweep3d_reference(f, *args), 2)
        nbytes, ops, streamed, mirrored = _sweep3d_work(W4, S, T, 4)
        bound, by = _bound_ms(nbytes, ops)
        rows.append(dict(S=S, ms=ms, plain_ms=plain, bound_ms=bound,
                         bound_by=by, nbytes=nbytes, ops=ops,
                         stream_ms=_bound_ms(streamed, ops)[0],
                         streamed=streamed,
                         mirror_ms=_bound_ms(mirrored, ops)[0],
                         mirrored=mirrored))
    rec["sweep3d"] = {k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")}
    rec["sweep3d"]["max_abs_err"] = max_err
    rec["sweep3d_rows"] = rows
    print("phase 3c kernels: sweep3d (T=3) bit-equal to sweep3d_reference at "
          + "; ".join(small) + f"; at {WEDGE_DIMS} (NB={plan.NB}, "
          f"BR={plan.BR}, L0={plan.L0}, W4 {W4.numel() * 4 / 1e6:.2f} MB) "
          f"T={T}: " + "; ".join(
              f"S={r['S']}: kernel {r['ms']:.4f} ms per call, plain "
              f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}, {r['nbytes'] / 1e6:.1f} MB, "
              f"{r['ops'] / 1e9:.3f} G ops); bytes from device memory per "
              f"call of this design (13 weights a node a sweep, the mirror "
              f"reads in L2) {r['mirrored'] / 1e6:.1f} MB, floor "
              f"{r['mirror_ms']:.5f} ms; of a design that reads all 26 a "
              f"sweep "
              f"{r['streamed'] / 1e6:.1f} MB, floor {r['stream_ms']:.5f} ms"
              for r in rows)
          + f"; grid {t_grid:.2f} s, prepare3d {t_prep:.2f} s", flush=True)


def _opened_faces(W, shifts, axis):
    """The weights with the box face across `axis` opened: a cross tap
    whose source leaves the box along `axis` only gets a finite weight, so
    carry_init planes reach the field; a tap that leaves the plane keeps
    its +inf (what lets the kernel skip such taps)."""
    import numpy as np

    W = W.copy()
    shape = W.shape[1:]
    idx = np.meshgrid(*[np.arange(m) for m in shape], indexing="ij")
    for s, sh in enumerate(shifts):
        if sh[axis] == 0:
            continue
        inside = np.ones(shape, bool)
        for a in (0, 1, 2):
            if a != axis:
                inside &= (idx[a] + sh[a] >= 0) & (idx[a] + sh[a] < shape[a])
        leaves = (idx[axis] + sh[axis] < 0) | (idx[axis] + sh[axis]
                                              >= shape[axis])
        W[s][inside & leaves] = 37.0
    return W


def _plane3d_work(layout, taps, S):
    """(bytes, operations) of one directional pass: the S fields read and
    written once, the pass's weight planes (its taps) and the four
    scan-cost stacks read once; one add and one min per finite tap
    weight, and per level update of the scans (the min component's
    levels, both directions along both plane axes)."""
    import torch

    from raytracer_tpu_torch.ops.plane3d import tree_levels

    W = layout.W
    nA, _, p0, p1 = W.shape
    used = sorted({int(t) for t in taps[:, 0].tolist()})
    Wu = W[:, used]
    finite = int(torch.isfinite(Wu).sum())
    n = nA * p0 * p1
    nbytes = W.element_size() * (2 * S * n + Wu.numel() + 4 * n)

    def updates(m):
        return sum(k // 2 + (k - 1) // 2 for _, k in tree_levels(m))

    scan = nA * 2 * (updates(p0) * p1 + updates(p1) * p0)
    return nbytes, 2 * S * (finite + scan)


def phase_plane3d_kernel(rec: dict):
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import plane3d
    from raytracer_tpu_torch.solvers import solve3d as s3

    rng = np.random.default_rng(13)
    max_err, n_cases, routes = 0.0, 0, set()

    def check(d, lay, axis, down, ci, shifts, what):
        nonlocal max_err, n_cases
        out_k = plane3d.plane_sweep3d(d, lay, axis, down, ci, shifts)
        out_r = plane3d.plane_sweep3d_reference(d, lay, axis, down, ci,
                                                shifts)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        max_err = max(max_err, err)
        n_cases += 1
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"plane3d kernel != plain version ({what}, "
                                 f"axis {axis}, down={down}): max abs err "
                                 f"{err}")

    def field(shape, dtype, frac=0.3):
        v = rng.uniform(0.0, 500.0, shape).astype(dtype)
        v[rng.random(shape) < frac] = np.inf
        return torch.from_numpy(v).cuda()

    # the test wedge (lines of 5, 6 and 9 nodes): star 1 and 2, float32
    # and float64, every axis and direction; S=1 on the masked box, S=3
    # with carry_init across an opened face (one plane at star 1, a tuple
    # of two at star 2); then lines of 35 and 61 (odd) at star 1
    g, U = _wedge3d((9, 6, 5), 80.0, 100.0, 600.0)
    for star in (1, 2):
        shifts = s3.shifts_star(star)
        for dtype in (np.float32, np.float64):
            Wn = s3._shifted_weights(g, U, dtype, shifts)
            shape = Wn.shape[1:]
            for axis in (0, 1, 2):
                pshape = tuple(m for a, m in enumerate(shape) if a != axis)
                for S, carry in ((1, False), (3, True)):
                    W = torch.from_numpy(_opened_faces(Wn, shifts, axis)
                                         if carry else Wn).cuda()
                    lay = s3._sweep_layout3d(W, s3._scan_costs_of(W, shifts),
                                             axis)
                    d = field((S,) + shape, dtype)
                    ci = None
                    if carry:
                        planes = tuple(field((S,) + pshape, dtype, 0.2)
                                       for _ in range(star))
                        ci = planes[0] if star == 1 else planes
                    for down in (True, False):
                        check(d, lay, axis, down, ci, shifts,
                              f"(9,6,5) star {star} {np.dtype(dtype).name} "
                              f"S={S} carry={carry}")
    # lines of 35 and 61 (odd) at star 1: one block a source (the route
    # plane3d_plan takes for planes under 4,096 nodes), and forced onto
    # clusters of 2, 4 and 8 blocks (the 61-row planes in bands of 31/30,
    # 16/16/16/13 and 8 x 7 + 5 rows; the 5-row planes on at most 2 blocks,
    # 3/2 rows, since a band holds at least its 2 halo rows)
    g, U = _wedge3d((35, 5, 61), 80.0, 100.0, 600.0)
    W = torch.from_numpy(s3._shifted_weights(g, U, np.float32)).cuda()
    sc = s3._scan_costs_of(W, s3.SHIFTS)
    keep = plane3d.PLANE3D_CLUSTER, plane3d.PLANE3D_CLUSTER_NODES
    try:
        for cluster in (1, 2, 4, 8):
            plane3d.PLANE3D_CLUSTER = cluster
            plane3d.PLANE3D_CLUSTER_NODES = 1
            for axis in (0, 1, 2):
                lay = s3._sweep_layout3d(W, sc, axis)
                d = field((1,) + tuple(W.shape[1:]), np.float32)
                p0, p1 = (m for a, m in enumerate(W.shape[1:]) if a != axis)
                routes.add(plane3d.plane3d_plan(p0, p1, 4).cluster)
                for down in (True, False):
                    check(d, lay, axis, down, None, s3.SHIFTS,
                          f"(35,5,61) star 1, cluster {cluster}")
    finally:
        plane3d.PLANE3D_CLUSTER, plane3d.PLANE3D_CLUSTER_NODES = keep

    # planes that took two or one shared-memory planes on one block
    # (float32 160x128 along axis 0, float64 96x128 and 160x128), and a
    # 256x256 float32 plane (256 KB), over what one block may hold: on
    # clusters of 16 (the non-portable size)
    for dims, dtype in (((128, 160, 3), np.float32), ((128, 96, 3), np.float64),
                        ((128, 160, 3), np.float64), ((256, 256, 3), np.float32)):
        g, U = _wedge3d(dims, 80.0, 100.0, 600.0)
        W = torch.from_numpy(s3._shifted_weights(g, U, dtype)).cuda()
        sc = s3._scan_costs_of(W, s3.SHIFTS)
        lay = s3._sweep_layout3d(W, sc, 0)
        d = field((2,) + tuple(W.shape[1:]), dtype)
        cluster = plane3d.plane3d_plan(dims[1], dims[0],
                                       W.element_size()).cluster
        assert cluster == 16, (dims, cluster)
        routes.add(cluster)
        for down in (True, False):
            check(d, lay, 0, down, None, s3.SHIFTS,
                  f"{dims} {np.dtype(dtype).name} S=2, cluster {cluster}")

    # the global route (ROADMAP C.15): forced (no shared memory) on the
    # test wedge, every case above; then the smallest planes no cluster
    # holds, 256x256 float64 (S=2, and S=2 with carry_init across an
    # opened face) and 1024x1024 float32 (S=1), both directions, timed
    keep = plane3d.BLOCK_SMEM
    try:
        plane3d.BLOCK_SMEM = 0
        g, U = _wedge3d((9, 6, 5), 80.0, 100.0, 600.0)
        for star in (1, 2):
            shifts = s3.shifts_star(star)
            for dtype in (np.float32, np.float64):
                Wn = s3._shifted_weights(g, U, dtype, shifts)
                shape = Wn.shape[1:]
                for axis in (0, 1, 2):
                    pshape = tuple(m for a, m in enumerate(shape) if a != axis)
                    W = torch.from_numpy(_opened_faces(Wn, shifts, axis)).cuda()
                    lay = s3._sweep_layout3d(W, s3._scan_costs_of(W, shifts),
                                             axis)
                    d = field((3,) + shape, dtype)
                    planes = tuple(field((3,) + pshape, dtype, 0.2)
                                   for _ in range(star))
                    for ci in (None, planes[0] if star == 1 else planes):
                        for down in (True, False):
                            check(d, lay, axis, down, ci, shifts,
                                  f"(9,6,5) star {star} "
                                  f"{np.dtype(dtype).name} S=3, forced onto "
                                  f"the global route")
        routes.add(plane3d.plane3d_plan(6, 5, 4).cluster)
    finally:
        plane3d.BLOCK_SMEM = keep
    glob = []
    for dims, dtype, S in (((256, 256, 3), np.float64, 2),
                           ((1024, 1024, 2), np.float32, 1)):
        g, U = _wedge3d(dims, 80.0, 100.0, 600.0)
        Wn = s3._shifted_weights(g, U, dtype)
        for carry in ((False, True) if S == 2 else (False,)):
            W = torch.from_numpy(_opened_faces(Wn, s3.SHIFTS, 0) if carry
                                 else Wn).cuda()
            lay = s3._sweep_layout3d(W, s3._scan_costs_of(W, s3.SHIFTS), 0)
            cluster = plane3d.plane3d_plan(dims[1], dims[0],
                                           W.element_size()).cluster
            assert cluster == 0, (dims, cluster)
            routes.add(cluster)
            d = field((S,) + tuple(W.shape[1:]), dtype)
            ci = field((S, dims[1], dims[0]), dtype, 0.2) if carry else None
            for down in (True, False):
                check(d, lay, 0, down, ci, s3.SHIFTS,
                      f"{dims} {np.dtype(dtype).name} S={S} carry={carry} "
                      f"on the global route")
            if not carry:
                ms = _cuda_ms(lambda: plane3d.plane_sweep3d(
                    d, lay, 0, True, None, s3.SHIFTS), 3)
                glob.append(f"{dims[1]}x{dims[0]} x {dims[2]} planes "
                            f"{np.dtype(dtype).name} S={S} {ms:.3f} ms a pass")
            del W, lay
        del Wn

    # a pass at the 3-D path's 128x128x64 along each axis, S=1 and S=8,
    # timed (clusters of 16 blocks a source)
    g, U, packed, _, _ = rec["wedge"]
    lays = s3._device_layout(packed, "sweep", torch.device("cuda"))
    rows = []
    for S in (1, 8):
        d = field((S,) + packed.shape, np.float32)
        for axis in (0, 1, 2):
            check(d, lays[axis], axis, True, None, packed.shifts,
                  f"128x128x64 star 1 S={S}")
            ms = _cuda_ms(lambda: plane3d.plane_sweep3d(
                d, lays[axis], axis, True, None, packed.shifts), 5)
            plain = _cuda_ms(lambda: plane3d.plane_sweep3d_reference(
                d, lays[axis], axis, True, None, packed.shifts), 1)
            taps = plane3d._tap_table(packed.shifts, axis, True, "cuda")
            nbytes, ops = _plane3d_work(lays[axis], taps, S)
            bound, by = _bound_ms(nbytes, ops)
            _, p0, p1 = lays[axis].W.shape[0], *lays[axis].W.shape[2:]
            cluster = plane3d.plane3d_plan(p0, p1, 4).cluster
            routes.add(cluster)
            rows.append(dict(axis=axis, S=S, planes=lays[axis].W.shape[0],
                             cluster=cluster, ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by, nbytes=nbytes,
                             ops=ops))
    assert routes == {0, 1, 2, 4, 8, 16}, routes
    one = [r for r in rows if r["S"] == 1]
    rec["plane3d"] = {k: statistics.mean(r[k] for r in one)
                      for k in ("ms", "plain_ms", "bound_ms")}
    rec["plane3d"]["bound_by"] = rows[0]["bound_by"]
    rec["plane3d"]["max_abs_err"] = max_err
    print(f"phase 3e kernels: plane3d bit-equal to plane_sweep3d_reference "
          f"in {n_cases} passes ((9,6,5) star 1 and 2, float32 and float64, "
          f"S=1 and S=3 with carry_init, every axis and direction; (35,5,61) "
          f"star 1 on one block and on clusters of 2, 4 and 8; axis-0 planes of "
          f"160x128 in float32 and 96x128 and 160x128 in float64, and "
          f"256x256 float32 (over one block's shared memory); the global "
          f"route (cluster 0 below) forced on the (9,6,5) cases and taken by "
          f"256x256 float64 and 1024x1024 float32 ({'; '.join(glob)}); "
          f"{WEDGE_DIMS} S=1 and S=8) on clusters of {sorted(routes)} "
          f"blocks; at "
          f"{WEDGE_DIMS} star 1, down: " + "; ".join(
              f"axis {r['axis']} S={r['S']} ({r['planes']} planes, cluster "
              f"{r['cluster']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}, {r['nbytes'] / 1e6:.1f} MB, "
              f"{r['ops'] / 1e6:.1f} M ops)" for r in rows), flush=True)


def phase_grid3d(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.example_grid3d import (RECEIVER_DEGREES,
                                                    SOURCE_DEGREES,
                                                    surface_nodes)
    from raytracer_tpu_torch.solvers.solve3d import (_auto_source_batch,
                                                     select_engine3d)

    g, U, packed, t_grid, t_prep = rec["wedge"]
    cfg = rt.SolverConfig(dtype="float32")
    n = len(g)
    route = select_engine3d(packed, "auto", np.float32)
    batch = _auto_source_batch(packed.plan, 4, TABLE3D_SOURCES)
    assert route == "pallas" and batch == TABLE3D_BATCH, (route, batch)

    # the main 3-D path: one source's whole field
    src = n - n // 2
    _reset_counts()
    t0 = time.perf_counter()
    d1, it1 = rt.solve3d(g, U, [src], cfg, _packed=packed)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    launches = counts["sweep3d"]
    assert launches > 0 and launches * 8 == it1, (counts, it1)
    assert d1.shape == (1, n) and np.isfinite(d1).all()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.solve3d(g, U, [src], cfg, _packed=packed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steady = 1e3 * statistics.median(times)
    # device time of one solve by kernel (torch.profiler)
    split = _kernel_split_ms(
        lambda: rt.solve3d(g, U, [src], cfg, _packed=packed), 1)
    t0 = time.perf_counter()
    d_cpu, it_cpu = rt.solve3d(g, U, [src], cfg, _packed=packed, device="cpu")
    t_cpu = time.perf_counter() - t0
    assert it_cpu == it1, (it_cpu, it1)
    assert np.array_equal(d1, d_cpu), float(np.abs(d1 - d_cpu).max())

    # the example's 3 surface sources x 3 receivers against the JAX package
    srcs3 = surface_nodes(g, SOURCE_DEGREES)
    recs3 = surface_nodes(g, RECEIVER_DEGREES)
    tab3, it3 = rt.solve3d(g, U, srcs3, cfg, receivers=recs3, _packed=packed)
    err3 = float(np.abs(tab3 - np.asarray(JAX_WEDGE)).max())
    assert err3 <= T_ATOL, (err3, tab3)

    # the 64-source x 1024-receiver table (benchmarks/chip_dsweep3d.py)
    rng = np.random.default_rng(0)
    srcs64 = rng.integers(0, n, TABLE3D_SOURCES).tolist()
    recs = rng.integers(0, n, TABLE3D_RECEIVERS).tolist()
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table, it_tab = rt.solve3d(g, U, srcs64, cfg, receivers=recs,
                               _packed=packed)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    tab_launches = _counts()["sweep3d"]
    assert table.shape == (TABLE3D_SOURCES, TABLE3D_RECEIVERS)
    assert np.isfinite(table).all()
    err_rows = 0.0
    for q in (0, TABLE3D_SOURCES // 2, TABLE3D_SOURCES - 1):
        row, _ = rt.solve3d(g, U, [srcs64[q]], cfg, receivers=recs,
                            _packed=packed)
        err_rows = max(err_rows, float(np.abs(row[0] - table[q]).max()))
    assert err_rows <= BATCH_ATOL, err_rows

    # the predecessor tree of the single source, on the card and the CPU
    prev = rt.recover_prev3d(g, U, d1, [src], cfg, _packed=packed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = rt.recover_prev3d(g, U, d1, [src], cfg, _packed=packed)
    torch.cuda.synchronize()
    t_prev = time.perf_counter() - t0
    prev_cpu = rt.recover_prev3d(g, U, d1, [src], cfg, _packed=packed,
                                 device="cpu")
    assert np.array_equal(prev, prev_cpu)
    hops = []
    for r in recs3:
        p = rt.recontruct_path(prev[0], src, r)
        assert p[0] == r and p[-1] == src and len(p) > 1, (r, p[:3])
        assert np.all(np.diff(d1[0][p]) < 0), r
        hops.append(len(p) - 1)

    ms1 = rec["sweep3d"]["ms"]
    ms7 = rec["sweep3d_rows"][1]["ms"]
    rec["sweep3d"]["launches"] = launches
    rec["grid3d_ms"] = steady
    rec["grid3d_launches"] = launches
    rec["grid3d_single"] = (src, d1, srcs64)
    print(f"phase 11 grid3d: {WEDGE_DIMS}, {n} nodes (grid {t_grid:.2f} s, "
          f"prepare3d {t_prep:.2f} s), auto -> {route}, source batch "
          f"{batch} for {TABLE3D_SOURCES} sources. Single source {src}: "
          f"{it1} iterations, sweep3d launches={launches} (path counts "
          f"{counts}); first solve {t_first:.3f} s, steady solve median of 3 "
          f"{steady:.2f} ms, of it the kernel {launches} x {ms1:.4f} ms = "
          f"{100 * launches * ms1 / steady:.1f} %; device ms per solve "
          f"by kernel (torch.profiler): " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items())
          + f" (busy {100 * sum(split.values()) / steady:.1f} % of the "
          f"steady solve); bit-equal to the CPU "
          f"route ({it_cpu} iterations, {t_cpu:.1f} s through the plain "
          f"twin). 3x3 surface table ({it3} iterations) within "
          f"{err3:.3g} s of the JAX package's. {TABLE3D_SOURCES}x"
          f"{TABLE3D_RECEIVERS} table: {1e3 * t_table:.1f} ms = "
          f"{1e3 * t_table / TABLE3D_SOURCES:.2f} ms per source, {it_tab} "
          f"iterations at most, {tab_launches} launches, of it the kernel "
          f"{tab_launches} x {ms7:.4f} ms = "
          f"{100 * tab_launches * ms7 / (1e3 * t_table):.1f} %; three rows "
          f"within {err_rows:.3g} s of their single solves. recover_prev3d "
          f"{1e3 * t_prev:.2f} ms, equal to the CPU recovery; backtraces of "
          f"{hops} hops descend to the source", flush=True)


def phase_example3d():
    import numpy as np

    t0 = time.perf_counter()
    out = _run([sys.executable, "-m", "raytracer_tpu_torch.example_grid3d"])
    rows = [ln for ln in out.splitlines() if ln.strip().startswith("src (")]
    got = np.array([[float(v) for v in ln.split(":")[1].split()]
                    for ln in rows])
    assert got.shape == (3, 3), out
    assert "engine pallas" in out and "on cuda" in out, out
    # printed to 0.01 s: |printed - JAX| <= 0.005 + |port - JAX|
    err = float(np.abs(got - np.asarray(JAX_EXAMPLE)).max())
    assert err <= T_ATOL, (err, out)
    solve_line = [ln for ln in out.splitlines() if "solve" in ln][0]
    print(f"phase 12 example_grid3d: defaults on the card, "
          f"'{solve_line.strip()}', table within {err:.3g} s of the root "
          f"example's ({time.perf_counter() - t0:.1f} s)", flush=True)


def _stencil_bytes(ts):
    """Bytes of the lane-gather stencil that a sweep must read: one weight
    and one source lane for each finite (k, lane) weight, each row's
    source (u_of) and each tile's first row (offs), not the kernels'
    padded forms of it."""
    import numpy as np

    finite = int(np.isfinite(ts.w).sum())
    return (4 + ts.w.dtype.itemsize) * finite + 4 * (ts.u_of.size
                                                    + ts.offs.size)


def _relax_work(ts, S, itemsize):
    """(bytes, operations) of one relax sweep: the state read and written
    once, the stencil's finite weights once (`_stencil_bytes`); one add
    and one min per finite (k, lane) weight for every real theta row of
    every source."""
    import numpy as np

    nt = ts.ntheta
    state = ts.T * S * (-(-nt // 8) * 8) * 128 * itemsize
    nbytes = 2 * state + _stencil_bytes(ts)
    return nbytes, 2 * int(np.isfinite(ts.w).sum()) * nt * S


def _fused_work(ts, tbl, S, iters, itemsize):
    """(bytes, operations) of one fused solve of `iters` iterations (the
    count the kernel returned for these inputs).  Bytes: the stencil's
    finite weights (`_stencil_bytes`) and the ring, chain and fan weights
    once, the state and the centre in and out once.  Operations per iteration,
    over the real theta rows only (pad rows never reach a real one): the
    ring steps (a multiply, an add and two mins per element of a ring whose
    hop cost is finite), the chain steps (an add and a min per finite jump
    cost), the relaxation (an add and a min per finite weight), the fan (an
    add and a min each way per finite fan weight) and the convergence
    compare (one per element)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.contrib.fused_circulant import RING_STEPS

    nt = ts.ntheta
    steps = sum(1 for k in range(RING_STEPS) if (1 << k) % nt)
    ring = 4 * steps * int(np.isfinite(ts.ring_w).sum()) * nt
    chain = 2 * int(torch.isfinite(tbl.pdn).sum()
                    + torch.isfinite(tbl.pup).sum()) * nt
    relax = 2 * int(np.isfinite(ts.w).sum()) * nt
    fan = 4 * int(np.isfinite(ts.fan_w).sum()) * nt
    compare = ts.T * 128 * nt
    ops = iters * S * (ring + chain + relax + fan + compare)
    state = ts.T * S * (-(-nt // 8) * 8) * 128 * itemsize
    tables = _stencil_bytes(ts) + sum(
        t.numel() * t.element_size()
        for t in (tbl.ring_w, tbl.pdn, tbl.pup, tbl.fan_w))
    return tables + 2 * state + 2 * S * itemsize, ops


def _lane_field(rng, ts, S):
    """Random (T, S, ntp, 128) travel times in the stencil's dtype, ~30 %
    +inf, with finite pad rows (the fan writes such rows; a sweep must
    reset them to +inf)."""
    import numpy as np
    import torch

    nt = ts.ntheta
    ntp = -(-nt // 8) * 8
    d = rng.uniform(0.0, 1500.0, (ts.T, S, ntp, 128)).astype(ts.w.dtype)
    d[rng.random(d.shape) < 0.3] = np.inf
    d[:, :, nt:] = rng.uniform(0.0, 1500.0, d[:, :, nt:].shape)
    return torch.from_numpy(d).cuda()


def phase_lane_gather_kernels(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.contrib import fused_circulant as pfc
    from raytracer_tpu_torch.contrib import pallas_circulant as ppc

    rng = np.random.default_rng(8)
    relax_rows = []
    # the path's shapes (180x63, S=1; the table's S=8) and float64 at 24x12
    for (ntheta, nr, spacing), S, dtype in (
            ((180, 63, 20.0), 1, np.float32), ((180, 63, 20.0), 8, np.float32),
            ((24, 12, 150.0), 2, np.float64)):
        _, cg, _ = rt.init_annulus_circulant(ntheta, nr, spacing=spacing)
        ts = ppc.pack_tiled_stencil(cg, dtype)
        nt = ts.ntheta
        ntp = -(-nt // 8) * 8
        tb = ppc.device_pallas_tables(ts, "cuda")
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        x = _lane_field(rng, ts, S)
        args = (tb.offs, tb.u_of, tb.idx, tb.w, ts.T, nt, S, ntp)
        out_k = ppc.relax(x, *args)
        out_r = ppc.relax_reference(x, *args)
        torch.cuda.synchronize()
        err = _max_err(out_k, out_r)
        if not torch.equal(out_k, out_r):
            raise AssertionError(f"relax kernel != plain version at {name} "
                                 f"S={S}: max abs err {err}")
        ms = _cuda_ms(lambda: ppc.relax(x, *args, ), 50)
        plain = _cuda_ms(lambda: ppc.relax_reference(x, *args), 2)
        nbytes, ops = _relax_work(ts, S, np.dtype(dtype).itemsize)
        bound, by = _bound_ms(nbytes, ops)
        dev = _kernel_split_ms(lambda: ppc.relax(x, *args), 5)
        chunks = ppc._kernel_chunks(*args[:5])[0].shape[0]
        relax_rows.append(dict(
            grid=name, S=S, T=ts.T, K=ts.idx.shape[0],
            chunks=int(chunks), max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, nbytes=nbytes,
            ops=ops, device_ms=dev))

    fused_rows, cuts = [], []
    eight = tuple(np.linspace(0.0, 360.0, 8, endpoint=False))
    # the modular ring shifts (24x12, S=2, also in float64), the table's
    # width (48x12 and 180x63, S=8) and the solve (180x63, S=1)
    for ntheta, nr, spacing, degs, dtype in (
            (24, 12, 150.0, (0.0, 97.0), np.float32),
            (24, 12, 150.0, (0.0, 97.0), np.float64),
            (48, 12, 150.0, eight, np.float32),
            (180, 63, 20.0, (0.0,), np.float32),
            (180, 63, 20.0, eight, np.float32)):
        gr, cgf, _ = rt.init_annulus_circulant(ntheta, nr, spacing=spacing)
        tsf = ppc.pack_tiled_stencil(cgf, dtype)
        ntf = tsf.ntheta
        ntpf = -(-ntf // 8) * 8
        srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                for d in degs]
        S = len(srcs)
        d0, c0 = ppc.initial_state(cgf, srcs, tsf.T, ntpf, dtype)
        x0 = torch.from_numpy(d0.reshape(tsf.T, S * ntpf, 128)).cuda()
        cen0 = torch.from_numpy(c0).cuda()
        tbl = pfc.device_fused_tables(tsf, "cuda")
        st = pfc.FusedStatic(tsf.T, ntf, ntpf, S)
        name = f"{ntheta}x{nr}" + ("" if dtype == np.float32 else " f64")
        # the loop cut at max_iters: no iteration, and three (the last
        # fan and the snapshot's copy back at the cut)
        for m in ((0, 3) if ntheta == 24 else ()):
            x_k, c_k, it_k = pfc.fused(x0, cen0, tbl, st, m)
            x_r, c_r, it_r = pfc.fused_reference(x0, cen0, tbl, st, m)
            torch.cuda.synchronize()
            if not (torch.equal(x_k, x_r) and torch.equal(c_k, c_r)
                    and int(it_k) == it_r):
                raise AssertionError(
                    f"fused kernel != plain version at {name} S={S} cut at "
                    f"max_iters={m}: max abs err "
                    f"{max(_max_err(x_k, x_r), _max_err(c_k, c_r))}, "
                    f"iterations {int(it_k)} and {it_r}")
            cuts.append(f"{name} S={S} max_iters={m}: {it_r} iterations")
        x_k, c_k, it_k = pfc.fused(x0, cen0, tbl, st, 100_000)
        it_k = int(it_k)
        t0 = time.perf_counter()
        x_r, c_r, it_r = pfc.fused_reference(x0, cen0, tbl, st, 100_000)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        err = max(_max_err(x_k, x_r), _max_err(c_k, c_r))
        if not (torch.equal(x_k, x_r) and torch.equal(c_k, c_r)
                and it_k == it_r):
            raise AssertionError(
                f"fused kernel != plain version at {ntheta}x{nr} S={S}: max "
                f"abs err {err}, iterations {it_k} and {it_r}")
        ms = _cuda_ms(lambda: pfc.fused(x0, cen0, tbl, st, 100_000), 3)
        nbytes, ops = _fused_work(tsf, tbl, S, it_k,
                                  np.dtype(dtype).itemsize)
        bound, by = _bound_ms(nbytes, ops)
        fused_rows.append(dict(
            grid=name, S=S, T=tsf.T, iters=it_k, max_abs_err=err,
            ms=ms, plain_ms=1e3 * t_plain,
            bound_ms=bound, bound_by=by, nbytes=nbytes, ops=ops,
            chunks=int(tbl.ck_info.shape[0])))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    # times at the main paths' shapes (180x63, S=1), errors over every case
    rec["relax"] = {k: relax_rows[0][k] for k in keys}
    rec["relax"]["max_abs_err"] = max(r["max_abs_err"] for r in relax_rows)
    rec["fused"] = {k: fused_rows[3][k] for k in keys}
    rec["fused"]["max_abs_err"] = max(r["max_abs_err"] for r in fused_rows)
    rec["fused_iters"] = fused_rows[3]["iters"]
    print("phase 3d kernels: relax bit-equal to relax_reference (finite pad "
          "rows in): "
          + "; ".join(f"{r['grid']} S={r['S']} (T={r['T']}, K_tot={r['K']}, "
                      f"{r['chunks']} chunks): kernel {r['ms']:.4f} ms (device "
                      "ms by kernel, torch.profiler: "
                      + ", ".join(f"{k} {v:.4f}"
                                  for k, v in r['device_ms'].items())
                      + f"), plain {r['plain_ms']:.2f} ms, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e6:.1f} M "
                      f"ops)" for r in relax_rows)
          + ". fused bit-equal to fused_reference, same iterations: "
          + "; ".join(f"{r['grid']} S={r['S']} T={r['T']}: {r['iters']} "
                      f"iterations, {r['chunks']} chunks, kernel "
                      f"{r['ms']:.3f} ms per solve "
                      f"({1e3 * r['ms'] / r['iters']:.2f} us per iteration), "
                      f"plain {r['plain_ms'] / 1e3:.2f} s, bound "
                      f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
                      f"{r['nbytes'] / 1e6:.2f} MB, {r['ops'] / 1e9:.3f} G "
                      f"ops)" for r in fused_rows)
          + ". fused cut at max_iters, bit-equal: " + "; ".join(cuts),
          flush=True)


def phase_contrib(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    gr, cg, U, source, D_sweep, receivers, degs = rec["sweep_180"]
    tight = rt.AnnulusSolver(gr, None, None, U,
                             rt.SolverConfig(tol=TIGHT_TOL, max_iters=5000),
                             method="twrapped", circulant=cg)
    d_tight = tight.solve(source, want_prev=False).dist
    assert tight.last_iterations == JAX_CONTRIB["twrapped tight"], \
        tight.last_iterations
    gs, cgs, Us = rt.init_annulus_circulant(48, 12, spacing=150.0)
    src_s = rt.closest_point(gs, 0.0, rt.R, system="polar")
    srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(0.0, 315.0, TABLE_SOURCES)]
    recs = np.asarray(receivers[:TABLE_RECEIVERS])
    parts = []
    for method, kernel in (("pallas", "relax"), ("fused", "fused")):
        t_engine = time.perf_counter()
        solver = rt.AnnulusSolver(gr, None, None, U, method=method,
                                  circulant=cg)
        _reset_counts()
        t0 = time.perf_counter()
        D = solver.solve(source)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = _counts()
        iters = solver.last_iterations
        ref_iters, ref_above, ref_below, ref_reach = JAX_CONTRIB[method]
        assert solver.method == method and iters == ref_iters, \
            (solver.method, iters)
        if method == "pallas":
            assert counts["relax"] == iters, counts
        else:
            assert counts["fused"] == 1, counts
        assert sum(counts.values()) == counts[kernel], counts
        assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
        tt = rt.travel_times(D, gr, receivers)
        t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
        t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
        assert abs(t60 - T60_REF) <= T_ATOL, (method, t60)
        assert abs(t150 - T150_REF) <= T_ATOL, (method, t150)
        above = float((D.dist - d_tight).max())
        below = float(-(D.dist - d_tight).min())
        assert abs(above - ref_above) <= SPREAD_ATOL, (method, above)
        assert abs(below - ref_below) <= SPREAD_ATOL, (method, below)
        err_sweep = float(np.abs(D.dist - D_sweep.dist).max())
        if method == "pallas":
            assert err_sweep <= ENGINE_ATOL, err_sweep
        else:
            assert max(above, below) <= CPU_ATOL, (above, below)
        reach = _reaching(D.prev, source, receivers)
        assert len(reach) == ref_reach, (method, len(reach))
        paths = [rt.recontruct_path(D.prev, source, r) for r in reach]
        for r, p in zip(reach, paths):
            assert p[0] == r and p[-1] == source and len(p) > 1, (r, p[:3])
        prev = solver.recover_prev(D.dist)
        prev[source] = source
        assert np.array_equal(prev, D.prev)
        # the same route on the CPU, bit for bit, at 48x12
        t_small = time.perf_counter()
        small = [rt.AnnulusSolver(gs, None, None, Us, method=method,
                                  circulant=cgs, device=dev)
                 for dev in ("cuda", "cpu")]
        d_small = [s.solve(src_s, want_prev=False).dist for s in small]
        t_small = time.perf_counter() - t_small
        assert np.array_equal(d_small[0], d_small[1]), method
        assert small[0].last_iterations == small[1].last_iterations
        # 8 x 150 table (S = 8 on the kernel's rows), rows against singles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = solver.travel_time_table(srcs, recs, batch=8)
        torch.cuda.synchronize()
        t_table = time.perf_counter() - t0
        assert table.shape == (TABLE_SOURCES, TABLE_RECEIVERS)
        assert np.isfinite(table).all()
        rows = (0, 3, 7)
        assert srcs[0] == source  # row 0 is D's
        err_table = float(max(np.abs(
            table[i] - (D.dist if i == 0 else solver.solve(
                srcs[i], want_prev=False).dist)[recs]).max() for i in rows))
        assert err_table <= CPU_ATOL, (method, err_table)
        steady = _steady_ms(solver, source, 3)
        rec[kernel]["launches"] = counts[kernel]
        rec[f"{method}_ms"] = steady
        parts.append(
            f"{method}: {iters} iterations (the JAX package: {ref_iters}), "
            f"{kernel} launches={counts[kernel]}, t(60)={t60:.4f} s, "
            f"t(150)={t150:.4f} s; against twrapped at tol={TIGHT_TOL:g} "
            f"{above:.6g} s above and {below:.6g} s below (the JAX package: "
            f"{ref_above:.6g} and {ref_below:.6g}); max |{method} - sweep| = "
            f"{err_sweep:.3g} s over every node; prev tree equal to "
            f"recover_prev, {len(reach)} of {len(receivers)} receiver paths "
            f"reach the source without a cycle (the JAX package: "
            f"{ref_reach}); 48x12 bit-equal to the CPU "
            f"route ({small[0].last_iterations} iterations, both solves "
            f"{t_small:.1f} s); 8x150 table "
            f"{1e3 * t_table:.1f} ms, rows {rows} within {err_table:.3g} s "
            f"of single solves; first solve+prev {t_first:.3f} s, steady "
            f"solve median of 3 {steady:.2f} ms "
            f"({time.perf_counter() - t_engine:.1f} s)")
    print(f"phase 13 pallas and fused: 180x63, {gr.nnods} nodes, twrapped at "
          f"tol={TIGHT_TOL:g} {tight.last_iterations} iterations; "
          + "; ".join(parts), flush=True)


STAGED_DIMS = (128, 128, 60)   # + 5 twin levels of the AK135 interfaces


def _staged_at_scale(cfg, radii, prof) -> list:
    """PcP and SKS timed on CMB-spanning wedges of ~1M nodes (no CPU
    route at this size): one call each by the host clock (the masked
    weights and their layouts are built in every call, the weights on
    the host), the rounds, the plane3d launches (6 a round), and the
    relations of
    tests/test_grid3d_disc.py: PcP at least the direct P field and 50 s
    above it at 10 deg, SKS at most ScS (its reflection class) + 0.05 s,
    +inf below the CMB."""
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.example_grid3d import surface_nodes

    def timed(fn):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, it = fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        launches = _counts()["plane3d"]
        assert 1 <= it and launches == 6 * it, (it, launches)
        return d, it, launches, t

    lines = []
    for name, c0, c1, deg in (
            ("PcP", (np.deg2rad(60.0), np.deg2rad(60.0), 3000.0),
             (np.deg2rad(120.0), np.deg2rad(120.0), rt.R), 90.0),
            ("SKS", (0.0, np.deg2rad(60.0), 1400.0),
             (np.deg2rad(130.0), np.deg2rad(120.0), rt.R), 0.0)):
        t0 = time.perf_counter()
        gw = rt.grid3d(c0, c1, STAGED_DIMS, force_radii=radii)
        Up = rt.velocity3d(gw, rt.LinearInterpolation(prof.r, prof.Vp))
        t_grid = time.perf_counter() - t0
        src = surface_nodes(gw, [(deg, 90.0)])
        if name == "PcP":
            d, it, launches, ts = timed(lambda: rt.solve3d_reflection(
                gw, Up, src, 3481.5, cfg))
            dP, _ = rt.solve3d(gw, Up, src, cfg)
            fin = np.isfinite(d[0])
            assert fin.sum() == int((gw.r >= 3481.5 - 1e-6).sum())
            assert np.all(d[0][fin] >= dP[0][fin] - BATCH_ATOL)
            rec_ = surface_nodes(gw, [(deg + 10.0, 90.0)])[0]
            assert d[0, rec_] > dP[0, rec_] + 50.0
            check = (f"at 10 deg {d[0, rec_] - dP[0, rec_]:.1f} s above "
                     f"direct P")
        else:
            Us = rt.velocity3d(gw, rt.LinearInterpolation(prof.r, prof.Vs))
            d, it, launches, ts = timed(lambda: rt.solve3d_converted(
                gw, Us, Up, src, 3481.5, config=cfg))
            scs, _ = rt.solve3d_reflection(gw, Us, src, 3481.5, cfg)
            fin = np.isfinite(scs[0])
            assert np.all(d[0][fin] <= scs[0][fin] + 5e-2)
            assert not np.isfinite(d[0][gw.r < 3481.45 - 1e-6]).any()
            rec_ = surface_nodes(gw, [(125.0, 90.0)])[0]
            check = (f"at 125 deg {scs[0, rec_] - d[0, rec_]:.1f} s below "
                     f"ScS")
        lines.append(f"{name} on {gw.nnods} ({len(gw)} nodes, grid "
                     f"{t_grid:.2f} s): {it} rounds, {launches} launches, "
                     f"the call {1e3 * ts:.1f} ms, {check}")
    return lines


def phase_sweep3d_engine(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.example_grid3d import surface_nodes
    from raytracer_tpu_torch.models.velocity import table_interface_radii
    from raytracer_tpu_torch.solvers.solve3d import select_engine3d

    g, U, packed, _, _ = rec["wedge"]
    src, d_k, srcs64 = rec["grid3d_single"]
    cfg = rt.SolverConfig(dtype="float32")

    # the 3-D path on the sweep engine: one source's whole field
    _reset_counts()
    t0 = time.perf_counter()
    d_s, it_s = rt.solve3d(g, U, [src], cfg, engine="sweep", _packed=packed)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    launches = counts["plane3d"]
    assert 1 <= it_s <= MAX_ROUNDS and launches == 6 * it_s, (it_s, counts)
    assert d_s.shape == d_k.shape and np.isfinite(d_s).all()
    err_k = float(np.abs(d_s - d_k).max())
    np.testing.assert_allclose(d_s, d_k, rtol=1e-6, atol=BATCH_ATOL)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.solve3d(g, U, [src], cfg, engine="sweep", _packed=packed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steady = 1e3 * statistics.median(times)
    split = _kernel_split_ms(lambda: rt.solve3d(
        g, U, [src], cfg, engine="sweep", _packed=packed), 1)

    # 8 sources in one group through the kernel's source dimension
    srcs8 = srcs64[:8]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d8, it8 = rt.solve3d(g, U, srcs8, cfg, engine="sweep", source_batch=8,
                         _packed=packed)
    torch.cuda.synchronize()
    t8 = time.perf_counter() - t0
    launches8 = _counts()["plane3d"]
    assert 1 <= it8 <= MAX_ROUNDS and launches8 == 6 * it8, (it8, launches8)
    k8, _ = rt.solve3d(g, U, srcs8, cfg, _packed=packed)
    err8 = float(np.abs(d8 - k8).max())
    np.testing.assert_allclose(d8, k8, rtol=1e-6, atol=BATCH_ATOL)

    # star 2 (98 taps): auto -> sweep, against star-2 xla and star 1
    t0 = time.perf_counter()
    packed2 = rt.prepare3d(g, U, cfg, star=2)
    t_prep2 = time.perf_counter() - t0
    assert select_engine3d(packed2, "auto", np.float32) == "sweep"
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2, it2 = rt.solve3d(g, U, [src], cfg, _packed=packed2)
    torch.cuda.synchronize()
    t2 = time.perf_counter() - t0
    launches2 = _counts()["plane3d"]
    assert 1 <= it2 <= MAX_ROUNDS and launches2 == 6 * it2, (it2, launches2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2x, it2x = rt.solve3d(g, U, [src], cfg, engine="xla", _packed=packed2)
    torch.cuda.synchronize()
    t2x = time.perf_counter() - t0
    err2 = float(np.abs(d2 - d2x).max())
    assert err2 <= 1e-3, err2
    assert np.all(d2 <= d_s + 1e-3), float((d2 - d_s).max())
    gain = float(np.mean(d_s - d2))
    packed2.dcache.clear()

    # the staged solves on the test wedges (tests/test_grid3d_disc.py)
    radii = table_interface_radii("ak135")
    prof = rt.velocity_profile("ak135")
    staged = []
    for name, c0, c1, dims, deg in (
            ("PcP", (np.deg2rad(60.0), np.deg2rad(88.0), 3000.0),
             (np.deg2rad(120.0), np.deg2rad(92.0), rt.R), (61, 3, 35), 90.0),
            ("SKS", (0.0, np.deg2rad(88.0), 1400.0),
             (np.deg2rad(130.0), np.deg2rad(92.0), rt.R), (66, 3, 42), 0.0)):
        gw = rt.grid3d(c0, c1, dims, force_radii=radii)
        Up = rt.velocity3d(gw, rt.LinearInterpolation(prof.r, prof.Vp))
        Us = rt.velocity3d(gw, rt.LinearInterpolation(prof.r, prof.Vs))
        sw = surface_nodes(gw, [(deg, 90.0)])
        out = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            if name == "PcP":
                out[device] = rt.solve3d_reflection(gw, Up, sw, 3481.5, cfg,
                                                    device=device)
            else:
                out[device] = rt.solve3d_converted(gw, Us, Up, sw, 3481.5,
                                                   config=cfg, device=device)
            out[device] += (time.perf_counter() - t0,)
        (dk, ik, tk), (dc, ic, tc) = out["cuda"], out["cpu"]
        assert ik == ic and np.array_equal(dk, dc), (name, ik, ic)
        staged.append(f"{name} on {dims}: {ik} rounds, equal to the CPU "
                      f"route, {1e3 * tk:.1f} ms on the card (CPU "
                      f"{tc:.2f} s)")
    staged += _staged_at_scale(cfg, radii, prof)

    rec["plane3d"]["launches"] = launches
    rec["sweep3d_engine_ms"] = steady
    rec["sweep3d_engine_launches"] = launches
    ms = rec["plane3d"]["ms"]
    print(f"phase 14 3-D sweep engine: {WEDGE_DIMS}, star 1, one source: "
          f"{it_s} rounds, plane3d launches={launches} (path counts "
          f"{counts}), max |sweep - kernel engine| = {err_k:.3g} s; first "
          f"solve {t_first:.3f} s, steady solve median of 3 {steady:.2f} ms, "
          f"of it the kernel {launches} x {ms:.4f} ms = "
          f"{100 * launches * ms / steady:.1f} %; device ms per solve by "
          f"kernel (torch.profiler): " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items())
          + f" (busy {100 * sum(split.values()) / steady:.1f} %). 8 sources "
          f"in one group: {it8} rounds, {launches8} launches, "
          f"{1e3 * t8:.1f} ms = {1e3 * t8 / 8:.2f} ms per source, max "
          f"|sweep - kernel engine| = {err8:.3g} s. star 2 (98 taps, "
          f"prepare3d {t_prep2:.2f} s): auto -> sweep, {it2} rounds, "
          f"{launches2} launches, {1e3 * t2:.1f} ms; xla {it2x} iterations "
          f"{1e3 * t2x:.1f} ms, max |sweep - xla| = {err2:.3g} s, mean gain "
          f"over star 1 {gain:.3f} s. Staged: " + "; ".join(staged),
          flush=True)


# ----------------------------------------------------------------------
# the generic graphs: the ELL BFM solver and the banded solver
# ----------------------------------------------------------------------

def _digest(a, dtype) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(np.asarray(a), dtype=dtype)
                          .tobytes()).hexdigest()


def _no_halo():
    import numpy as np

    return np.empty((0, 2), np.int64)


def _ak135_vp(gr):
    import raytracer_tpu_torch as rt

    prof = rt.velocity_profile("ak135")
    return rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                                prof.Vp))


def _ell_work(g, front, itemsize):
    """(bytes, operations) of one BFM iteration on this frontier: the
    state read and written once (dist, prev, front of every field), the
    neighbour ids of every real slot read once (the frontier rows'
    relaxation and the new frontier both need them), the weights of the
    real slots of the frontier rows (a row read once for all fields);
    one add and one min per real slot of each field's frontier rows."""
    S, n_pad = front.shape
    deg = g.deg.long()
    union = int(deg[front.any(0)].sum())
    per_field = int((deg[None, :] * front).sum())
    state = 2 * S * n_pad * (itemsize + 4 + 1)
    return state + 4 * int(deg.sum()) + itemsize * union, 2 * per_field


def _ell_work_push(g, front, itemsize):
    """(bytes, operations) of one BFM iteration with the push frontier
    on a symmetric graph: the state read and written once, the neighbour
    ids and weights of the real slots of the frontier rows only (the
    relaxation reads them, and an improved row pushes from the ids it
    has just read: no row outside the frontier reads its list); the
    operations as `_ell_work`."""
    S, n_pad = front.shape
    deg = g.deg.long()
    union = int(deg[front.any(0)].sum())
    per_field = int((deg[None, :] * front).sum())
    state = 2 * S * n_pad * (itemsize + 4 + 1)
    return state + (4 + itemsize) * union, 2 * per_field


def _ell_lockstep(g, srcs, dtype, what):
    """bfm_step (the kernel) and bfm_step_reference (its plain version)
    from init_state until the frontier empties, every field of the two
    states equal after every step; returns the steps and each step's
    (bytes, operations) by `_ell_work`, then by `_ell_work_push`."""
    import torch

    from raytracer_tpu_torch.ops import relax

    sk = sr = relax.init_state(g, srcs, dtype)
    work = []
    while True:
        front = sr.front if sr.front.dim() == 2 else sr.front[None]
        work.append(_ell_work(g, front, g.w.element_size())
                    + _ell_work_push(g, front, g.w.element_size()))
        sk = relax.bfm_step(sk, g)
        sr = relax.bfm_step_reference(sr, g)
        for f in sk._fields:
            if not torch.equal(getattr(sk, f), getattr(sr, f)):
                raise AssertionError(f"bfm_step kernel != plain version "
                                     f"({what}, {f}, step {len(work)})")
        if not int(sr.live):
            return len(work), work


def _asym_graph(g, n_cut, seed):
    """A copy of the DeviceGraph `g` on its device with `n_cut` directed
    edges taken out (the slot pointed back at its row, weight +inf): its
    real slots are no longer symmetric, so bfm_step takes the pull."""
    import numpy as np

    from raytracer_tpu_torch.ops import relax

    nbr, w = g.nbr.cpu().numpy().copy(), g.w.cpu().numpy().copy()
    rng = np.random.default_rng(seed)
    r = np.flatnonzero(g.deg.cpu().numpy() > 1)[:g.n]
    for i in rng.choice(r, n_cut, replace=False):
        nbr[i, 0], w[i, 0] = i, np.inf
    h = relax.device_graph(nbr, w, g.halo_src.cpu().numpy(),
                           g.halo_dst.cpu().numpy(), g.n, g.nbr.device)
    assert not h.symmetric
    return h


def _steps_ms(step, state, n):
    """Mean milliseconds of a call of step over n calls from `state`,
    CUDA events around the calls (the plain version reads the host at
    each call)."""
    import torch

    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        state = step(state)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_graph_kernels(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops import relax

    # the reference's benchmark graph, built and packed once for phases
    # 3f and 15
    t0 = time.perf_counter()
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0)
    U = _ak135_vp(gr)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    G = rt.prepare(A, halo, gr, U)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    src = rt.closest_point(gr, 0.0, rt.R, system="polar")
    rec["graph_180"] = (gr, A, halo, U, src, G, t_build, t_prep)

    n1, work1 = _ell_lockstep(G, src, "float32", "180x63 S=1")
    srcs8 = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
             for d in np.linspace(0.0, 315.0, 8)]
    n8, work8 = _ell_lockstep(G, srcs8, "float32", "180x63 S=8")
    assert n1 == JAX_BFM_180[0], n1
    # float64: 48x12 (spacing 150, halo), the production Delaunay mesh;
    # float32: the 3-D graph of example_grid3d (24x24x16, 3 sources)
    cases = [f"180x63 S=1 and S=8 ({n1} and {n8} steps)"]
    gs, As, hs = rt.init_annulus(48, 12, spacing=150.0)
    g48 = rt.prepare(As, hs, gs, _ak135_vp(gs), rt.SolverConfig(
        dtype="float64"))
    src48 = rt.closest_point(gs, 0.0, rt.R, system="polar")
    n, _ = _ell_lockstep(g48, [src48, 11], "float64", "48x12 float64")
    cases.append(f"48x12 float64 S=2 ({n})")
    # the pull route: the 48x12 graph with 7 directed edges taken out,
    # with and without a level mask
    ga = _asym_graph(g48, 7, 3)
    n, _ = _ell_lockstep(ga, [src48, 11], "float64", "48x12 pull")
    nm = _ell_masked_lockstep(ga, src48, "float64", gs, "48x12 pull masked")
    cases.append(f"the pull route on 48x12 float64 less 7 directed edges "
                 f"S=2 ({n}; level-masked {nm[0]} + {nm[1]})")
    assert G.symmetric and g48.symmetric and not ga.symmetric
    dg = rt.add_midpoints(rt.triangle_annulus_2d(**DELAUNAY))
    dA = rt.node_adjacency(dg, star=0)
    dsrc = rt.closest_point(dg, 0.0, rt.R, system="polar")
    gd = rt.prepare(dA, _no_halo(), dg, _ak135_vp(dg),
                    rt.SolverConfig(dtype="float64"))
    n, _ = _ell_lockstep(gd, dsrc, "float64", "Delaunay float64")
    cases.append(f"the production Delaunay mesh float64 ({n})")
    rec["delaunay"] = (dg, dA, dsrc)
    from raytracer_tpu_torch.example_grid3d import (SOURCE_DEGREES,
                                                    surface_nodes)

    g3 = rt.grid3d((np.deg2rad(70.0), np.deg2rad(70.0), rt.R - 2000.0),
                   (np.deg2rad(110.0), np.deg2rad(110.0), rt.R), (24, 24, 16))
    prof = rt.velocity_profile("ak135")
    U3 = rt.LinearInterpolation(prof.r, prof.Vp)(g3.r)
    G3 = rt.prepare(rt.nodal_incidence3d(g3), _no_halo(), g3, U3)
    n, _ = _ell_lockstep(G3, surface_nodes(g3, SOURCE_DEGREES), "float32",
                         "3-D 24x24x16")
    cases.append(f"the 3-D 24x24x16 graph S=3 ({n})")

    # times over a whole single-source solve at 180x63
    st = relax.init_state(G, src, "float32")
    ms = _steps_ms(lambda s: relax.bfm_step(s, G), st, n1)
    plain = _steps_ms(lambda s: relax.bfm_step_reference(s, G), st, n1)
    nbytes = sum(w[0] for w in work1) / n1
    ops = sum(w[1] for w in work1) / n1
    bound_pull, by_pull = _bound_ms(nbytes, ops)
    nbytes_push = sum(w[2] for w in work1) / n1
    bound, by = _bound_ms(nbytes_push, ops)
    ms8 = _steps_ms(lambda s: relax.bfm_step(s, G),
                    relax.init_state(G, srcs8, "float32"), n8)
    split = _kernel_split_ms(lambda: _steps_ms(
        lambda s: relax.bfm_step(s, G), st, n1), 1)
    # the pull route (two launches) on the same graph and state
    Gp = G._replace(symmetric=False)
    pull = _steps_ms(lambda s: relax.bfm_step(s, Gp), st, n1)
    split_pull = _kernel_split_ms(lambda: _steps_ms(
        lambda s: relax.bfm_step(s, Gp), st, n1), 1)
    st48 = relax.init_state(g48, src48, "float64")
    n48 = _ell_lockstep(g48, src48, "float64", "48x12 float64 S=1")[0]
    ms48 = _steps_ms(lambda s: relax.bfm_step(s, g48), st48, n48)
    rec["bfm_step"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                           bound_by=by, max_abs_err=0.0)
    print(f"phase 3f kernels: bfm_step bit-equal to bfm_step_reference "
          f"(dist, prev, front, it, live after every step) on "
          + ", ".join(cases) + f". 180x63 ({G.nbr.shape[0]} x "
          f"{G.nbr.shape[1]} ELL, {int(G.deg.sum())} real slots; "
          f"init_annulus {t_build:.2f} s, prepare {t_prep:.2f} s with its "
          f"symmetry check): a call on the push route {ms:.4f} ms on "
          f"average over the {n1} steps of a solve (S=8: {ms8:.4f} ms; "
          f"float64 48x12 S=1 {ms48:.4f} ms over {n48} steps), the pull "
          f"route on the same steps {pull:.4f} ms, plain {plain:.3f} ms, "
          f"bound {bound:.5f} ms ({by}, {nbytes_push / 1e6:.1f} MB, "
          f"{ops / 1e6:.1f} M ops a step on average: the push's reads; "
          f"by the pull's formula, every real slot's id once, "
          f"{bound_pull:.5f} ms, {by_pull}, {nbytes / 1e6:.1f} MB); device "
          f"ms a solve by "
          f"kernel, push: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(split.items()))
          + "; pull: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   sorted(split_pull.items())),
          flush=True)


def _banded_work(bg, S, passes=1):
    """(bytes, operations) of one banded call: the fields read and written
    once, the finite taps (source row and weight) and the tap offsets
    read once; one add and one min per finite tap, field and pass."""
    itemsize = bg.tw.element_size()
    taps = int(bg.tw.numel())
    nbytes = (2 * S * bg.n_pad * itemsize + (4 + itemsize) * taps
              + 4 * int(bg.toff.numel()))
    return nbytes, 2 * taps * S * passes


def _dense_on_card(bg):
    """bg with its dense W (which only the plain versions read, kept on
    the host by prepare_banded) on the card beside the tap lists."""
    return bg._replace(W=bg.W.to(bg.tw.device))


def _banded_twin_states(bg, srcs, cfg):
    """The plain version's banded states iteration by iteration on the
    card, from the sources' start field to the fixpoint."""
    import torch

    from raytracer_tpu_torch.ops import banded as pb

    twin = _dense_on_card(bg)
    d0 = pb._sources(bg, srcs, cfg)
    one = torch.ones((), dtype=torch.int32, device=d0.device)
    states = [pb.BandedState(d0, one, torch.zeros_like(one))]
    while int(states[-1].changed):
        states.append(pb.banded_step_reference(states[-1], twin))
    return states


def _jacobi_route(bg, S):
    from raytracer_tpu_torch.ops import banded as pb

    r = pb._jacobi_route(bg, S)
    return getattr(r, "plan", r).route


def _banded_lockstep(bg, srcs, cfg, what):
    """banded_sweep in launches of 1, 8 and the whole solve's iterations,
    each launch's state (field, flag, iterations) equal to the plain
    version's after as many iterations, and banded_gs against its plain
    version after every direction, from the sources' start field to the
    fixpoint; returns (Jacobi iterations, Gauss-Seidel rounds,
    banded_sweep's route)."""
    import torch

    from raytracer_tpu_torch.ops import banded as pb

    states = _banded_twin_states(bg, srcs, cfg)
    n = len(states) - 1
    route = _jacobi_route(bg, len(srcs))
    for count in (1, 8, cfg.max_iters):
        sk, launches = states[0], 0
        while int(sk.changed):
            sk = pb.banded_step(sk, bg, cfg.max_iters, count)
            launches += 1
            want = states[min(launches * count, n)]
            for f in sk._fields:
                if not torch.equal(getattr(sk, f), getattr(want, f)):
                    raise AssertionError(
                        f"banded_sweep kernel != plain version ({what}, "
                        f"{route} route, count {count}, {f}, launch "
                        f"{launches})")
        assert launches == -(-n // count), (what, count, launches, n)
    twin = _dense_on_card(bg)
    dk = dr = pb._sources(bg, srcs, cfg)
    rounds = 0
    while True:
        start = dr
        for forward in (True, False):
            dk = pb.banded_gs(dk, bg, forward)
            dr = pb.banded_gs_reference(dr, twin, forward)
            if not torch.equal(dk, dr):
                raise AssertionError(f"banded_gs kernel != plain version "
                                     f"({what}, round {rounds}, "
                                     f"forward={forward})")
        rounds += 1
        if not bool((dr < start).any()):
            return n, rounds, route


def phase_banded_kernels(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops import banded as pb

    dg, dA, dsrc = rec["delaunay"]
    U = _ak135_vp(dg)
    cases, routes, jroutes = [], set(), set()
    for dtype in ("float32", "float64"):
        cfg = rt.SolverConfig(dtype=dtype)
        t0 = time.perf_counter()
        bg = rt.prepare_banded(dA, _no_halo(), dg, U, cfg)
        torch.cuda.synchronize()
        t_prep = time.perf_counter() - t0
        n, rounds, jr = _banded_lockstep(bg, [dsrc], cfg,
                                         f"Delaunay {dtype}")
        cases.append(f"the production Delaunay mesh {dtype} ({n} steps, "
                     f"{rounds} rounds; banded_sweep {jr})")
        routes.add((dtype, "rcm", pb._gs_route(bg, 512).plan.route))
        jroutes.add(jr)
        if dtype == "float32":
            assert (n, rounds) == (JAX_BANDED["jacobi"][0],
                                   JAX_BANDED["gs"][0]), (n, rounds)
            bg32, n32, r32, t_prep32 = bg, n, rounds, t_prep
        else:
            bg64, n64 = bg, n
    # eight sources at once (phase 16's table), float32
    srcs8 = [rt.closest_point(dg, np.deg2rad(d), rt.R, system="polar")
             for d in np.linspace(0.0, 175.0, 8)]
    cfg32 = rt.SolverConfig()
    n8, _, jr = _banded_lockstep(bg32, srcs8, cfg32, "Delaunay float32 S=8")
    cases.append(f"the production mesh float32 S=8 ({n8} steps; "
                 f"banded_sweep {jr})")
    jroutes.add(jr)
    # the routes that keep nothing in shared memory (forced: none to
    # spend) on the production mesh in float64: banded_gs's wide route
    # with its rows in global memory, banded_sweep's global route
    keep = pb.BLOCK_SMEM
    try:
        pb.BLOCK_SMEM = 0
        bgw = bg64._replace(gs={}, jacobi={})
        assert pb._gs_route(bgw, 512) == pb.GsPlan("wide", 512, 0)
        cfg = rt.SolverConfig(dtype="float64")
        n, rounds, jr = _banded_lockstep(
            bgw, [dsrc], cfg, "Delaunay float64, global routes forced")
        assert (n, jr) == (n64, "global"), (n, jr)
        cases.append(f"the production mesh float64 on banded_gs's wide "
                     f"route with its rows in global memory and "
                     f"banded_sweep's global route ({n} steps, {rounds} "
                     f"rounds)")
        routes.add(("float64", "rcm", "wide, global rows"))
        jroutes.add(jr)
    finally:
        pb.BLOCK_SMEM = keep
    # order="natural" (a band of 2,918 rows) on the nr=12 Delaunay mesh:
    # the window route in float32, the wide one in float64
    sg = rt.add_midpoints(rt.triangle_annulus_2d(nr=12, spacing=500.0))
    sA = rt.node_adjacency(sg, star=0)
    for dtype in ("float32", "float64"):
        cfg = rt.SolverConfig(dtype=dtype)
        bg = rt.prepare_banded(sA, _no_halo(), sg, _ak135_vp(sg), cfg,
                               order="natural")
        route = pb._gs_route(bg, 512)
        route = getattr(route, "plan", route).route
        routes.add((dtype, "natural", route))
        n, rounds, jr = _banded_lockstep(bg, [0, 17], cfg,
                                         f"natural nr=12 {dtype}")
        jroutes.add(jr)
        cases.append(f"order='natural' on the nr=12 Delaunay mesh {dtype} "
                     f"S=2 ({n}, {rounds}; {route} route, banded_sweep "
                     f"{jr})")
    assert {r for *_, r in routes} == {"window", "wide",
                                       "wide, global rows"}, routes
    gs, As, hs = rt.init_annulus(16, 6, spacing=200.0)
    for dtype in ("float32", "float64"):
        cfg = rt.SolverConfig(dtype=dtype)
        bg = rt.prepare_banded(As, hs, gs, _ak135_vp(gs), cfg)
        n, rounds, jr = _banded_lockstep(
            bg, [rt.closest_point(gs, 0.0, rt.R, system="polar"), 40], cfg,
            f"16x6 {dtype}")
        jroutes.add(jr)
        cases.append(f"16x6 with its halo {dtype} S=2 ({n}, {rounds}; "
                     f"{pb._gs_route(bg, 512).route} route, banded_sweep "
                     f"{jr})")
    assert jroutes == {"shared", "global"}, jroutes

    # banded_sweep on the main path's shape: the whole solve in one launch
    d0 = pb._sources(bg32, [dsrc], cfg32)
    one = torch.ones((), dtype=torch.int32, device=d0.device)
    st = pb.BandedState(d0, one, torch.zeros_like(one))
    cap = cfg32.max_iters

    def whole(g, state):
        return lambda: pb.banded_step(state, g, cap, cap)

    ms = _cuda_ms(whole(bg32, st), 10)
    call1 = _steps_ms(lambda s: pb.banded_step(s, bg32), st, n32)
    twin32 = _dense_on_card(bg32)
    plain = n32 * _steps_ms(lambda s: pb.banded_step_reference(s, twin32),
                            st, n32)
    cfg64 = rt.SolverConfig(dtype="float64")
    d64 = pb._sources(bg64, [dsrc], cfg64)
    ms64 = _cuda_ms(whole(bg64, pb.BandedState(d64, one,
                                               torch.zeros_like(one))), 10)
    st8 = pb.BandedState(pb._sources(bg32, srcs8, cfg32), one,
                         torch.zeros_like(one))
    ms8 = _cuda_ms(whole(bg32, st8), 5)
    nbytes, ops = _banded_work(bg32, 1)
    bound_it, by_it = _bound_ms(nbytes, ops)
    nbytes_s, ops_s = _banded_work(bg32, 1, passes=n32)
    bound, by = _bound_ms(nbytes_s, ops_s)
    split = _kernel_split_ms(whole(bg32, st), 3)
    on_card = sum(v for k, v in split.items()
                  if k in KERNEL_NAMES["banded_sweep"])
    plan32 = pb._jacobi_route(bg32, 1).plan
    rec["banded_sweep"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                               bound_by=by, max_abs_err=0.0,
                               ms_per_iteration=on_card / n32,
                               bound_ms_per_iteration=bound_it)
    calls = 2 * r32

    def gs_calls(fn, g):
        def run(d):
            for k in range(calls):
                d = fn(d, g, k % 2 == 0)
            return d
        return run

    gms = _steps_ms(gs_calls(pb.banded_gs, bg32), d0, 1) / calls
    gplain = _steps_ms(gs_calls(pb.banded_gs_reference, twin32), d0,
                       1) / calls
    gms64 = _steps_ms(gs_calls(pb.banded_gs, bg64), d64, 1) / calls
    gms8 = _steps_ms(gs_calls(pb.banded_gs, bg32), st8.dist, 1) / calls
    gsplit = _kernel_split_ms(lambda: gs_calls(pb.banded_gs, bg32)(d0), 1)
    lay = pb._gs_route(bg32, 512)
    gbytes, gops = _banded_work(bg32, 1, passes=2)
    gbound, gby = _bound_ms(gbytes, gops)
    rec["banded_gs"] = dict(ms=gms, plain_ms=gplain, bound_ms=gbound,
                            bound_by=gby, max_abs_err=0.0)
    print(f"phase 3g kernels: banded_sweep (in launches of 1, 8 and the "
          f"whole solve's iterations, every launch's state) and banded_gs "
          f"(every direction) bit-equal to their plain versions on "
          + ", ".join(cases)
          + f". Delaunay ({bg32.n} nodes, {len(bg32.offsets_np)} offsets, "
          f"{int(bg32.tw.numel())} finite taps; prepare_banded "
          f"{t_prep32:.2f} s): banded_sweep's whole solve ({n32} "
          f"iterations) one launch of {ms:.4f} ms (shared route: "
          f"{plan32.blocks} blocks of {plan32.R} rows, window {plan32.Wmax} "
          f"rows, {plan32.nmax} tap slots the fullest block, {plan32.smem} "
          f"bytes; float64 {ms64:.4f} ms, S=8 {ms8:.4f} ms), on the card "
          f"{on_card:.4f} ms = {on_card / n32:.5f} ms an iteration against "
          f"its bound {bound_it:.5f} ms ({by_it}, {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e6:.2f} M ops); the launch's bound {bound:.5f} ms "
          f"({by}: its inputs once, {n32} iterations' operations); "
          f"{call1:.4f} ms a call of one iteration (count 1); plain "
          f"{plain:.3f} ms the solve; device ms of the solve by kernel: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(split.items()))
          + f"; banded_gs a call (a direction, B=512, P=2, the window "
          f"route: ring {lay.plan.Wr} rows, {lay.plan.nmax} tap slots the "
          f"fullest block, {lay.plan.smem} bytes) {gms:.4f} ms (float64 "
          f"{gms64:.4f}, S=8 {gms8:.4f}), plain {gplain:.3f} ms, bound "
          f"{gbound:.5f} ms ({gby}); device ms over {calls} directions by "
          f"kernel: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                  sorted(gsplit.items()))
          + f"; routes {sorted(routes)}", flush=True)


def phase_graph_bfm(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.solvers import bfm as B

    gr, A, halo, U, src, G, t_build, t_prep = rec["graph_180"]
    # the reference's benchmark through its entry point: bfm(A, halo,
    # source, gr, Vp), packing included
    _reset_counts()
    t0 = time.perf_counter()
    D = rt.bfm(A, halo, src, gr, U)
    torch.cuda.synchronize()
    t_bfm = time.perf_counter() - t0
    counts = _counts()
    it_ref, reach_ref, dist_ref, prev_ref = JAX_BFM_180
    launches = counts["bfm_step"]
    assert launches == -(-it_ref // B.CHECK_EVERY) * B.CHECK_EVERY, counts
    assert sum(counts.values()) == launches, counts
    rec["bfm_step"]["launches"] = launches
    assert D.dist.shape == (gr.nnods,) and np.isfinite(D.dist).all()
    assert _digest(D.dist, "<f4") == dist_ref, "bfm dist != JAX digest"
    assert _digest(D.prev, "<i8") == prev_ref, "bfm prev != JAX digest"
    assert int(B.solve_state(G, src).it) == it_ref
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.solve(G, src)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steady = 1e3 * statistics.median(times)
    rec["bfm_ms"] = steady
    from raytracer_tpu_torch.main_annulus import receiver_degrees

    degs = receiver_degrees()
    receivers = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                 for d in degs]
    tt = rt.travel_times(D, gr, receivers)
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert abs(t60 - T60_REF) <= T_ATOL, t60
    assert abs(t150 - T150_REF) <= T_ATOL, t150
    reach = _reaching(D.prev, src, receivers)
    assert len(reach) == reach_ref, len(reach)
    # the port's auto route (the directional sweep) on the same graph
    t0 = time.perf_counter()
    sweep = rt.AnnulusSolver(gr, A, halo, U)
    assert sweep.method == "sweep", sweep.method
    d_sweep = sweep.solve(src, want_prev=False).dist
    t_sweep = time.perf_counter() - t0
    err = float(np.abs(D.dist - d_sweep).max())
    assert err <= ENGINE_ATOL, err
    print(f"phase 15 bfm: init_annulus(180, 63) ({gr.nnods} nodes, "
          f"{A.nnz} edges, {t_build:.2f} s), bfm(A, halo, source, gr, Vp) "
          f"{t_bfm:.2f} s with its prepare (prepare alone {t_prep:.2f} s), "
          f"{it_ref} iterations in {launches} bfm_step calls (a host read "
          f"every {B.CHECK_EVERY}), dist and prev equal to the JAX "
          f"package's digests, steady solve {steady:.2f} ms (median of "
          f"3), t(60)={t60:.3f} s, t(150)={t150:.3f} s, {len(reach)} of "
          f"{len(receivers)} receiver walks reach the source (C.9), "
          f"max |bfm - auto sweep| = {err:.3g} s (sweep built from the "
          f"graph in {t_sweep:.1f} s)", flush=True)


def phase_graph_banded(rec: dict):
    import warnings

    import numpy as np
    import torch

    import raytracer_tpu_torch as rt

    dg, dA, dsrc = rec["delaunay"]
    U = _ak135_vp(dg)
    _reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solver = rt.AnnulusSolver(dg, dA, _no_halo(), U)
    t_pack = time.perf_counter() - t0
    msgs = [str(w.message) for w in caught]
    assert solver.method == "banded", solver.method
    assert msgs == ["circulant layout unavailable (mesh has no theta-column "
                    "structure (ntheta=0)); falling back to banded"], msgs
    t0 = time.perf_counter()
    D = solver.solve(dsrc)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    it_ref, dig_ref = JAX_BANDED["jacobi"]
    launches = counts["banded_sweep"]
    assert solver.last_iterations == it_ref, solver.last_iterations
    assert launches == 1, counts       # the whole solve in one launch
    assert sum(counts.values()) == launches, counts
    rec["banded_sweep"]["launches"] = launches
    assert _digest(D.dist, "<f4") == dig_ref, "banded field != JAX digest"
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(dsrc, want_prev=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steady = 1e3 * statistics.median(times)
    rec["banded_ms"] = steady
    from raytracer_tpu_torch.main_annulus import receiver_degrees

    degs = receiver_degrees()
    receivers = [rt.closest_point(dg, np.deg2rad(d), rt.R, system="polar")
                 for d in degs]
    reach = _reaching(D.prev, dsrc, receivers)
    for r in reach[:20]:
        p = rt.recontruct_path(D.prev, dsrc, r)
        assert p[0] == r and p[-1] == dsrc
        assert (np.diff(D.dist[p]) <= 1e-3).all()
    # the Gauss-Seidel solve, on its own path
    _reset_counts()
    t0 = time.perf_counter()
    d_gs, rounds = rt.solve_banded_gs(solver.banded, [dsrc])
    torch.cuda.synchronize()
    t_gs = time.perf_counter() - t0
    counts = _counts()
    assert rounds == JAX_BANDED["gs"][0] and \
        counts["banded_gs"] == 2 * rounds, (rounds, counts)
    assert sum(counts.values()) == counts["banded_gs"], counts
    rec["banded_gs"]["launches"] = counts["banded_gs"]
    assert _digest(d_gs[0], "<f4") == JAX_BANDED["gs"][1]
    gs_err32 = float(np.abs(d_gs[0] - D.dist).max())
    # float64: Gauss-Seidel against Jacobi, Jacobi against Dijkstra
    f64 = rt.SolverConfig(dtype="float64")
    bg64 = rt.prepare_banded(dA, _no_halo(), dg, U, f64)
    d64, it64 = rt.solve_banded(bg64, [dsrc], f64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g64, r64 = rt.solve_banded_gs(bg64, [dsrc], f64)
    torch.cuda.synchronize()
    t_gs64 = time.perf_counter() - t0
    err_gs64 = float(np.abs(g64 - d64).max())
    assert err_gs64 <= 1e-9, err_gs64
    t0 = time.perf_counter()
    Dd = rt.dijkstra(dA, _no_halo(), dsrc, dg, U, f64)
    t_dij = time.perf_counter() - t0
    err_dij = float(np.abs(d64[0] - Dd.dist).max())
    assert err_dij <= 1e-9, err_dij
    # an 8-source table (benchmarks/chip_banded_gs.py's sources)
    srcs8 = [rt.closest_point(dg, np.deg2rad(d), rt.R, system="polar")
             for d in np.linspace(0.0, 175.0, 8)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = solver.travel_time_table(srcs8, receivers, batch=8)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    assert table.shape == (8, len(receivers)) and np.isfinite(table).all()
    for row in (0, 5):
        single = solver.solve(srcs8[row], want_prev=False).dist
        assert np.array_equal(table[row], single[receivers]), row
    # the 8 sources in one Gauss-Seidel solve (a block of threads each)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs8, r8 = rt.solve_banded_gs(solver.banded, srcs8)
    torch.cuda.synchronize()
    t_gs8 = time.perf_counter() - t0
    for row in (0, 5):
        single, _ = rt.solve_banded_gs(solver.banded, [srcs8[row]])
        assert np.array_equal(gs8[row], single[0]), row
    print(f"phase 16 banded: the production Delaunay annulus ({dg.nnods} "
          f"nodes, {dA.nnz} edges), AnnulusSolver(method='auto') warns and "
          f"routes to banded (packed in {t_pack:.2f} s), {it_ref} "
          f"iterations in {launches} banded_sweep calls, field equal to "
          f"the JAX package's digest, first solve with prev "
          f"{t_first:.2f} s, steady solve {steady:.2f} ms (median of 3), "
          f"{len(reach)} of {len(receivers)} receiver walks reach the "
          f"source; solve_banded_gs {rounds} rounds in {counts['banded_gs']} "
          f"banded_gs calls ({1e3 * t_gs:.1f} ms, the JAX package's "
          f"digest; float32 max |gs - jacobi| = {gs_err32:.3g} s); float64: "
          f"{it64} iterations, gs {r64} rounds ({1e3 * t_gs64:.1f} ms) "
          f"within {err_gs64:.3g} s, "
          f"dijkstra ({t_dij:.2f} s on the host) within {err_dij:.3g} s; "
          f"8 x {len(receivers)} table {1e3 * t_table:.1f} ms; "
          f"solve_banded_gs of the 8 sources at once {r8} rounds, "
          f"{1e3 * t_gs8:.1f} ms", flush=True)


def phase_graph_cli(tmp: str):
    import numpy as np

    from raytracer_tpu_torch import example_grid3d, main_annulus

    prefix = os.path.join(tmp, "ell")
    _reset_counts()
    t0 = time.perf_counter()
    main_annulus.main(["--ntheta", "180", "--nr", "63", "--method", "ell",
                       "--out-prefix", prefix])
    t_ell = time.perf_counter() - t0
    n_ell = _counts()["bfm_step"]
    assert n_ell > 0
    tt = np.loadtxt(f"{prefix}_travel_times.csv", delimiter=",", skiprows=1)
    assert tt.shape == (150, 2), tt.shape
    t60 = float(tt[np.argmin(np.abs(tt[:, 0] - 60.0)), 1])
    t150 = float(tt[np.argmin(np.abs(tt[:, 0] - 150.0)), 1])
    assert abs(t60 - T60_REF) <= T_ATOL and abs(t150 - T150_REF) <= T_ATOL
    # --method banded at 48x12, against the same run on the CPU
    small = ["--ntheta", "48", "--nr", "12", "--spacing", "150", "--method",
             "banded"]
    _reset_counts()
    t0 = time.perf_counter()
    main_annulus.main([*small, "--out-prefix", os.path.join(tmp, "bd")])
    t_banded = time.perf_counter() - t0
    n_banded = _counts()["banded_sweep"]
    assert n_banded > 0
    main_annulus.main([*small, "--device", "cpu", "--out-prefix",
                       os.path.join(tmp, "bdc")])
    with open(os.path.join(tmp, "bd_travel_times.csv")) as f1, \
            open(os.path.join(tmp, "bdc_travel_times.csv")) as f2:
        assert f1.read() == f2.read()
    # example_grid3d --engine ell
    _reset_counts()
    table, _ = example_grid3d.main(["--engine", "ell"])
    n3 = _counts()["bfm_step"]
    assert n3 > 0
    err3 = float(np.abs(table - np.asarray(JAX_EXAMPLE)).max())
    assert err3 <= T_ATOL, err3
    print(f"phase 17 drivers: main_annulus --method ell at 180x63 "
          f"{t_ell:.2f} s ({n_ell} bfm_step calls, t(60)={t60:.3f} s, "
          f"t(150)={t150:.3f} s); --method banded at 48x12 {t_banded:.2f} s "
          f"({n_banded} banded_sweep calls), its CSV equal to the CPU "
          f"route's; example_grid3d --engine ell ({n3} bfm_step calls) "
          f"within {err3:.3g} s of the root example's table", flush=True)


# ----------------------------------------------------------------------
# the staged solvers: bfm_ms, bfm_multiphase and the named phases
# ----------------------------------------------------------------------

def _ell_masked_lockstep(g, src, dtype, gr, what):
    """bfm_ms's ELL levels (1, then 15 restarted at the best Boundary_1
    node) with bfm_step (the kernel, its level mask) and
    bfm_step_reference (its plain version) in lockstep, every field of
    the two states equal after every step; returns each level's steps."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.models.partition import partition_grid
    from raytracer_tpu_torch.ops import relax
    from raytracer_tpu_torch.solvers.multiphase import _level_mask_t

    part = partition_grid(gr)
    n_pad = g.nbr.shape[0]
    steps = []
    st = None
    for level in (1, 15):
        mask = _level_mask_t(part, level, gr, n_pad, g.w.device)
        if st is None:
            st = relax.init_state(g, src, dtype, mask=mask)
        else:
            b1 = torch.as_tensor(np.flatnonzero(part.boundary_of == 1),
                                 device=g.w.device)
            new = int(b1[torch.argmin(st.dist[b1])])
            keep = torch.zeros(n_pad, dtype=torch.bool, device=g.w.device)
            keep[b1] = True
            front = relax.init_state(g, new, dtype).front & mask
            st = relax.BFMState(
                dist=torch.where(keep, st.dist, torch.full_like(
                    st.dist, float("inf"))), prev=st.prev,
                front=front, it=torch.zeros_like(st.it),
                live=front.any().to(torch.int32))
        sk = sr = st
        n = 0
        while int(sr.live):
            sk = relax.bfm_step(sk, g, None, mask)
            sr = relax.bfm_step_reference(sr, g, None, mask)
            n += 1
            for f in sk._fields:
                if not torch.equal(getattr(sk, f), getattr(sr, f)):
                    raise AssertionError(
                        f"masked bfm_step kernel != plain version ({what}, "
                        f"level {level}, {f}, step {n})")
        assert int(sk.it) == n and not bool((sk.front & ~mask).any())
        steps.append(n)
        st = sr
    return steps


def phase_staged_kernels(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops.sweep_theta import (_kernel_tables,
                                                     pack_rsweep_tables,
                                                     rsweep)
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil
    from raytracer_tpu_torch.solvers import multiphase as M
    from raytracer_tpu_torch.solvers import phases as P

    # the level-masked bfm_step over bfm_ms's two masked stages at 48x12
    gs, As, hs = rt.init_annulus(48, 12, spacing=150.0)
    src48 = rt.closest_point(gs, 0.0, rt.R, system="polar")
    steps = {}
    for dtype in ("float32", "float64"):
        g = rt.prepare(As, hs, gs, _ak135_vp(gs), rt.SolverConfig(
            dtype=dtype))
        steps[dtype] = _ell_masked_lockstep(g, src48, dtype, gs,
                                            f"48x12 {dtype}")
    # rsweep on every destination-masked stage table of bfm_ms (levels 1
    # and 15) and of PcP at 180x63, both directions, float32 and float64
    gr, A, halo, U, src, G, t_build, t_prep = rec["graph_180"]
    # and the masked push route at 180x63
    steps["180x63 float32"] = _ell_masked_lockstep(G, src, "float32", gr,
                                                   "180x63 float32")
    part = rt.partition_grid(gr)
    rng = np.random.default_rng(18)
    tables, max_err, lines = 0, 0.0, []
    ms_level1 = None
    for dtype in (np.float32, np.float64):
        cg = rt.build_circulant(gr, A, halo, U, dtype=dtype)
        ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
        _, rst = pack_rsweep_tables(ws, cg, dtype)
        stages = M._ms_stages(cg, ws, halo, part, (1, 15), dtype, "sweep")
        stages.append(M._stage("sweep", cg, ws, P._region_mask_above(
            part, P.REFLECTORS["cmb"]), dtype))
        named = [(name, sp.wtab_dn, sp.wtab_up) for name, sp in zip(
            ("bfm_ms level 1", "bfm_ms level 15", "PcP"), stages)]
        for name, wdn, wup in named:
            wdn_t, wup_t = torch.tensor(wdn).cuda(), torch.tensor(wup).cuda()
            max_err = max(max_err, _rsweep_check(
                rng, [(rst, 1, False), (rst, 1, True)], cg.cmap.ntheta,
                wdn_t, wup_t))
            tables += 1
            plans = [_kernel_tables(w, rst, up)[0]
                     for up, w in ((False, wdn_t), (True, wup_t))]
            empty = [int((p.binfo[:, 1] == 0).sum()) for p in plans]
            lines.append(f"{name} {np.dtype(dtype).name}: "
                         f"{np.isfinite(wdn[:, :len(rst.taps_dn)]).sum()}+"
                         f"{np.isfinite(wup[:, :len(rst.taps_up)]).sum()} "
                         f"finite weights, ent_cap {plans[0].ent_cap}/"
                         f"{plans[1].ent_cap}, {empty[0]}/{empty[1]} of "
                         f"{rst.MT // 8} blocks without a far tap, routes "
                         + "/".join("shared" if p.shared else "global"
                                    for p in plans))
            if name == "bfm_ms level 1" and dtype == np.float32:
                ms_level1 = (wdn_t, rst, cg.cmap.ntheta)
    wdn_t, rst, nt = ms_level1
    buf = _rsweep_buffer(rng, rst, nt, 1, False)
    ms1 = _cuda_ms(lambda: rsweep(buf, wdn_t, rst, False), 20)
    rec["rsweep_level1_ms"] = ms1
    print(f"phase 3h kernels: the level-masked bfm_step bit-equal to its "
          f"plain version (dist, prev, front, it, live after every step) "
          f"over bfm_ms's two masked stages at 48x12 (spacing 150, halo): "
          f"float32 {steps['float32']} steps, float64 {steps['float64']}, "
          f"and at 180x63 float32 {steps['180x63 float32']}; "
          f"rsweep bit-equal to rsweep_reference on {tables} "
          f"destination-masked stage tables at 180x63 (S=1, both "
          f"directions, max abs err {max_err}): " + "; ".join(lines)
          + f"; rsweep down on bfm_ms level 1's table {ms1:.4f} ms "
          f"(S=1, float32)", flush=True)


def _median_ms(fn, n: int = 3) -> float:
    """Median host milliseconds of n calls of fn, each between two
    synchronizes."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _hold_to_jax(name, dist, it, receivers, cpu_route, prev=None) -> str:
    """The card's staged field against the JAX package's figures
    (JAX_STAGED[name]): the same iteration count, the same finite set,
    the JAX times at the STAGED_DEGREES surface receivers within 2e-3 s;
    the field bit for bit (its digest), or else within CPU_ATOL of the
    port's CPU route (`cpu_route()`) at every finite node.  Returns a
    note for the phase line."""
    import numpy as np

    ref = JAX_STAGED[name]
    it_ref, n_fin, fin_sha, dist_sha, t_ref = ref[:5]
    assert it == it_ref, (name, it, it_ref)
    fin = np.isfinite(dist)
    assert int(fin.sum()) == n_fin, (name, int(fin.sum()), n_fin)
    assert _digest(np.packbits(fin), "u1") == fin_sha, (name, "finite set")
    t = [float(dist[r]) for r in receivers]
    err_t = max(abs(a - b) for a, b in zip(t, t_ref))
    assert err_t <= CPU_ATOL, (name, t, t_ref)
    if prev is not None:
        assert _digest(prev, "<i8") == ref[5], (name, "prev digest")
    if _digest(dist, "<f4") == dist_sha:
        return "bit-equal to JAX"
    d_cpu = np.asarray(cpu_route())
    assert np.array_equal(np.isfinite(d_cpu), fin), name
    err = float(np.abs(dist[fin] - d_cpu[fin]).max())
    assert err <= CPU_ATOL, (name, err)
    return (f"digest differs from JAX: within {err:.3g} s of the CPU "
            f"route, JAX receiver times within {err_t:.3g} s")


def _engines_agree(a, b, what) -> float:
    """max |a - b| over the nodes finite in a, which must be finite in b
    too; raises above ENGINE_ATOL."""
    import numpy as np

    fin = np.isfinite(a)
    assert np.isfinite(b[fin]).all(), what
    err = float(np.abs(a[fin] - b[fin]).max())
    assert err <= ENGINE_ATOL, (what, err)
    return err


def phase_staged(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.solvers import bfm as B
    from raytracer_tpu_torch.solvers import multiphase as M
    from raytracer_tpu_torch.solvers import phases as P

    gr, A, halo, U, src, _, _, _ = rec["graph_180"]
    prof = rt.velocity_profile("ak135")
    interp = rt.LinearInterpolation(prof.r, prof.Vp)
    Us = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                              prof.Vs))
    cfg = rt.SolverConfig(dtype="float32")
    receivers = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                 for d in STAGED_DEGREES]
    reuse: dict = {}
    lines, fields = [], {}

    def card_share(solve, kernel, steady):
        """One steady solve's device time (torch.profiler): the kernel's
        own and all of it, as shares of the steady solve."""
        split = _kernel_split_ms(solve, 1)
        own = sum(v for k, v in split.items() if k in KERNEL_NAMES[kernel])
        busy = sum(split.values())
        return (f"on the card {kernel} {own:.3f} ms = "
                f"{100 * own / steady:.1f} % of the steady solve, busy "
                f"{busy:.2f} ms (idle {100 * (1 - busy / steady):.1f} %)")

    def run(name, solve, cpu_route, kernel, per_it, profile=False):
        """First call (set-up included) with its launches counted, then
        the steady solve timed (median of 3), and with `profile` one
        steady solve profiled (a profile of a stream solve's ~23,000
        kernels takes seconds, so only bfm_ms's is taken)."""
        _reset_counts()
        t0 = time.perf_counter()
        dist, it = solve()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = _counts()
        assert counts[kernel] == per_it * it, (name, counts, it)
        assert sum(counts.values()) == counts[kernel], (name, counts)
        note = _hold_to_jax(name, dist, it, receivers, cpu_route)
        steady = _median_ms(solve)
        fields[name] = dist
        lines.append(f"{name} {it} {'rounds' if per_it == 2 else 'its'}, "
                     f"{counts[kernel]} {kernel} launches, steady "
                     f"{steady:.2f} ms (first {t_first:.2f} s), "
                     + (f"{card_share(solve, kernel, steady)}, "
                        if profile else "") + note)

    for m, kernel, per_it in (("stream", "band", 1), ("sweep", "rsweep", 2)):
        run(f"bfm_ms {m}",
            lambda m=m: M.bfm_ms_staged(A, halo, src, gr, U, cfg, (1, 15),
                                        m, "cuda", reuse)[:2],
            lambda m=m: M.bfm_ms_staged(A, halo, src, gr, U, cfg, (1, 15),
                                        m, "cpu")[0], kernel, per_it, True)
        run(f"PcP {m}",
            lambda m=m: P.reflected_travel_times_it(
                A, halo, src, gr, U, "cmb", cfg, "cuda", reuse, m),
            lambda m=m: P.reflected_travel_times(
                A, halo, src, gr, U, "cmb", cfg, "cpu", engine=m),
            kernel, per_it)
        run(f"SKS {m}",
            lambda m=m: P.converted_travel_times_it(
                A, halo, src, gr, Us, U, Us, "cmb", cfg, "cuda", reuse, m),
            lambda m=m: P.converted_travel_times(
                A, halo, src, gr, Us, U, Us, "cmb", cfg, "cpu", engine=m),
            kernel, per_it)
        # bfm_multiphase: its 3 levels' repacks once, then the solve
        t0 = time.perf_counter()
        cg0, ws0, stages = M.multiphase_stages(A, gr, U, interpolant=interp,
                                               config=cfg, method=m)
        t_pack = time.perf_counter() - t0
        run(f"bfm_multiphase {m}",
            lambda m=m, cg0=cg0, ws0=ws0, stages=stages: M._solve_stages(
                m, cg0, ws0, stages, src, cfg, "cuda"),
            lambda m=m: M.bfm_multiphase_staged(
                A, src, gr, U, interpolant=interp, config=cfg, method=m,
                device="cpu")[0], kernel, per_it)
        lines[-1] += f" (its 3 levels packed in {t_pack:.2f} s)"
    # public entry points on the stages kept in reuse
    D = rt.bfm_ms(A, halo, src, gr, U, cfg, levels=(1, 15), method="sweep",
                  _reuse=reuse)
    assert np.array_equal(D.dist, fields["bfm_ms sweep"])
    pcp = rt.phase_travel_times(A, halo, src, gr, U, "PcP", cfg,
                                receivers=receivers, _reuse=reuse)
    assert np.array_equal(pcp, fields["PcP stream"][receivers])
    # bfm_ms on the ELL path: its prepare once, then the masked bfm_step
    _reset_counts()
    t0 = time.perf_counter()
    De = M.bfm_ms(A, halo, src, gr, U, cfg, levels=(1, 15), method="ell",
                  _reuse=reuse)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = _counts()["bfm_step"]
    its = JAX_STAGED["bfm_ms ell"][0]
    assert launches == sum(B.CHECK_EVERY * max(1, -(-i // B.CHECK_EVERY))
                           for i in its), (launches, its)
    note = _hold_to_jax("bfm_ms ell", De.dist, its, receivers,
                        lambda: None, prev=De.prev)
    assert note == "bit-equal to JAX", note
    def ell():
        return M.bfm_ms(A, halo, src, gr, U, cfg, levels=(1, 15),
                        method="ell", _reuse=reuse)

    steady = _median_ms(ell)
    fields["bfm_ms ell"] = De.dist
    lines.append(f"bfm_ms ell {its} its, {launches} bfm_step launches, "
                 f"steady {steady:.2f} ms (first {t_first:.2f} s with its "
                 f"prepare), {card_share(ell, 'bfm_step', steady)}"
                 f", dist and prev bit-equal to JAX")
    # bfm_multiphase on the ELL path at 48x12 (a prepare a level)
    gs, As, _ = rt.init_annulus(48, 12, spacing=150.0)
    srcs = rt.closest_point(gs, 0.0, rt.R, system="polar")
    rcvs = [rt.closest_point(gs, np.deg2rad(d), rt.R, system="polar")
            for d in STAGED_DEGREES]
    _reset_counts()
    Dm = M.bfm_multiphase(As, srcs, gs, _ak135_vp(gs), interpolant=interp,
                          config=cfg)
    launches48 = _counts()["bfm_step"]
    its48 = JAX_STAGED["bfm_multiphase 48x12 ell"][0]
    assert launches48 == sum(B.CHECK_EVERY * max(1, -(-i // B.CHECK_EVERY))
                             for i in its48), (launches48, its48)
    note = _hold_to_jax("bfm_multiphase 48x12 ell", Dm.dist, its48, rcvs,
                        lambda: None, prev=Dm.prev)
    assert note == "bit-equal to JAX", note
    lines.append(f"bfm_multiphase ell 48x12 {its48} its, {launches48} "
                 f"bfm_step launches, dist and prev bit-equal to JAX")
    # the engines against each other
    errs = {k: _engines_agree(fields[f"{k} stream"], fields[f"{k} sweep"],
                              k)
            for k in ("bfm_ms", "PcP", "SKS", "bfm_multiphase")}
    errs["bfm_ms ell"] = _engines_agree(fields["bfm_ms ell"],
                                        fields["bfm_ms stream"], "ell")
    print("phase 18 staged solves at 180x63 (init_annulus, AK135, the "
          "surface source): " + "; ".join(lines) + "; max |stream - sweep| "
          + ", ".join(f"{k} {v:.3g} s" for k, v in errs.items()), flush=True)


def phase_staged_cli(tmp: str):
    import numpy as np

    from raytracer_tpu_torch import main_annulus

    prefix = os.path.join(tmp, "phases")
    _reset_counts()
    t0 = time.perf_counter()
    main_annulus.main(["--ntheta", "180", "--nr", "63", "--phases",
                       "PcP,SKS", "--out-prefix", prefix])
    t_cli = time.perf_counter() - t0
    counts = _counts()
    assert counts["band"] > 0 and counts["rsweep"] > 0, counts
    tab = np.genfromtxt(f"{prefix}_phases.csv", delimiter=",",
                        skip_header=2)
    assert tab.shape == (150, 3), tab.shape
    deg, pcp, sks = tab[:, 0], tab[:, 1], tab[:, 2]
    assert np.isfinite(pcp[deg <= 60]).all()
    mid = (deg >= 90) & (deg <= 150)
    assert np.isfinite(sks[mid]).all() and np.all(sks[mid] > pcp[mid])
    errs = []
    for name, col in (("PcP stream", pcp), ("SKS stream", sks)):
        for d, t_ref in zip(STAGED_DEGREES, JAX_STAGED[name][4]):
            errs.append(abs(float(col[np.argmin(np.abs(deg - d))]) - t_ref))
    assert max(errs) <= CPU_ATOL, errs
    print(f"phase 19 driver: main_annulus --phases PcP,SKS at 180x63 "
          f"{t_cli:.2f} s (launches {counts}), its CSV's PcP and SKS at "
          f"{STAGED_DEGREES} deg within {max(errs):.3g} s of the JAX "
          f"package's", flush=True)


# ----------------------------------------------------------------------
# paths, bending refinement and sensitivity: the paths and bend kernels
# ----------------------------------------------------------------------

def _fan(gr, n=None):
    """The 150-receiver fan of main_annulus (2..150 deg both sides)."""
    import numpy as np

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.main_annulus import receiver_degrees

    degs = receiver_degrees()
    return degs, [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                  for d in degs]


def _paths_check(gr, U, prev, src, recs, max_len, halo, dtype, what):
    """`paths` against its twin on the card in its three call forms
    (nodes, COO rows, dense rows): nodes and ids bit-equal, vals and the
    dense rows within 1e-12 (float64) or 1e-6 (float32) relative to the
    largest |val|, the forms' shared outputs equal and two launches' dense
    rows equal; returns the relative error and the (device tensors of
    the) inputs."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import paths as OP
    from raytracer_tpu_torch.solvers import sensitivity as S

    dev = torch.device("cuda")
    terms = S._device_terms(gr, np.asarray(U, dtype), halo, dev)
    prev_t = torch.as_tensor(np.asarray(prev, np.int32), device=dev)
    recs_t = torch.as_tensor(np.asarray(recs, np.int32), device=dev)
    only = OP.paths(prev_t, src, recs_t, max_len)
    coo = OP.paths(prev_t, src, recs_t, max_len, terms)
    got = OP.paths(prev_t, src, recs_t, max_len, terms, dense=True)
    again = OP.paths(prev_t, src, recs_t, max_len, terms, dense=True)
    want = OP.paths_reference(prev_t, src, recs_t, max_len, terms,
                              dense=True)
    torch.cuda.synchronize()
    assert only.ids is None and coo.dense is None, what
    for out in (only, coo, got):
        assert torch.equal(out.nodes, want.nodes), f"paths nodes {what}"
    for out in (coo, got):
        assert torch.equal(out.ids, want.ids), f"paths ids {what}"
    assert torch.equal(coo.vals, got.vals), f"paths vals {what}"
    assert torch.equal(again.dense, got.dense), f"paths two launches {what}"
    scale = float(want.vals.abs().max())
    err = max(float((got.vals - want.vals).abs().max()),
              float((got.dense - want.dense).abs().max())) / scale
    tol = 1e-12 if dtype == np.float64 else 1e-6
    assert err <= tol, (what, err)
    return err, (prev_t, recs_t, terms)


def _paths_work(n, n_rec, max_len, ndim, P, itemsize):
    """(bytes, operations) of one `paths` launch with the dense rows:
    prev, coords, U and the partner table read once, the nodes, the COO
    rows and the dense rows written once; ~(3 ndim + 8) operations a
    walked pair, each pair's two adds into the dense row."""
    K = max_len - 1
    nbytes = (4 * n + itemsize * (ndim + 1) * n + 4 * n * P + 4 * n_rec
              + 4 * n_rec * max_len + (4 + itemsize) * n_rec * 2 * K
              + itemsize * n_rec * n)
    ops = n_rec * K * (3 * ndim + 8 + 2)
    return float(nbytes), float(ops)


def _table_batch(fan):
    """A sub-batch shaped as refined_travel_time_table's: the fan's paths
    at m 384, seven copies with their interior vertices moved by up to 5
    km (seed 22), the first 1,024."""
    import numpy as np

    from raytracer_tpu_torch.solvers import refine as RF

    s384 = np.stack([RF.resample_path(p, 384) for p in fan])
    tiles = np.concatenate([s384] * 7)[:1024].copy()
    rng = np.random.default_rng(22)
    tiles[:, 1:-1] += rng.uniform(-5.0, 5.0, tiles[:, 1:-1].shape)
    return tiles


def _lift(p, ang=0.3):
    import numpy as np

    return np.stack([p[:, 0] * np.cos(ang), p[:, 0] * np.sin(ang), p[:, 1]],
                    axis=1)


def _bend_lockstep(stack, prof_r, prof_v, iters, dtype, quad=8):
    """`bend` and its twin from the same (B, m, d) stack on the card:
    (max |dt| s, max |dP| km)."""
    import torch

    from raytracer_tpu_torch.ops import bend as OB
    from raytracer_tpu_torch.solvers import refine as RF

    tdt = getattr(torch, dtype)
    tab = OB.uniform_table(*RF._uniform_slowness(prof_r, prof_v), tdt,
                           "cuda")
    P = torch.as_tensor(stack, dtype=tdt, device="cuda")
    Pk, tk = OB.bend(P, tab, 3.0, 6371.0, iters, quad)
    Pt, tt = OB.bend_reference(P, tab, 3.0, 6371.0, iters, quad)
    torch.cuda.synchronize()
    return (float((tk - tt).abs().max()), float((Pk - Pt).abs().max()))


def phase_paths_kernels(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops import bend as OB
    from raytracer_tpu_torch.ops import paths as OP
    from raytracer_tpu_torch.solvers import refine as RF

    prof = rt.velocity_profile("ak135")
    # paths at 180x63: the sweep solver's prev from phase 3f's graph (with
    # its halo), the 150-receiver fan, max_len 4 (180 + 63)
    gr, A, halo, U, src, _, _, _ = rec["graph_180"]
    t0 = time.perf_counter()
    solver = rt.AnnulusSolver(gr, A, halo, U)
    D = solver.solve(src)
    t_solve = time.perf_counter() - t0
    degs, recs = _fan(gr)
    max_len = 4 * (180 + 63)
    rec["paths_180"] = (solver, D, src, recs, max_len)
    errs = {}
    for dtype in (np.float64, np.float32):
        errs[np.dtype(dtype).name], inputs = _paths_check(
            gr, U, D.prev, src, recs, max_len, halo, dtype, "180x63")
        if dtype == np.float64:
            prev_t, recs_t, terms = inputs
    # the tiny annulus with its halo (twin hops on the walks)
    gt, At, ht = rt.init_annulus(16, 6, spacing=200.0)
    Ut = _ak135_vp(gt)
    st = rt.closest_point(gt, 0.0, rt.R, system="polar")
    Dt = rt.dijkstra(At, ht, st, gt, Ut, rt.SolverConfig(dtype="float64"))
    _, rt16 = _fan(gt)
    # and its tree with a 3-cycle that a walk enters (ROADMAP C.9) and
    # the source's own entry -1 (a walk stops at the source)
    cyc = np.asarray(Dt.prev).copy()
    walk = rt.recontruct_path(Dt.prev, st, rt16[40])
    assert len(walk) >= 4, walk
    cyc[walk[2]] = walk[0]
    cyc[st] = -1
    for dtype in (np.float64, np.float32):
        _paths_check(gt, Ut, Dt.prev, st, rt16, 88, ht, dtype, "16x6")
        _paths_check(gt, Ut, cyc, st, rt16, 88, ht, dtype,
                     "16x6 with a 3-cycle and -1")
    ms = _cuda_ms(lambda: OP.paths(prev_t, src, recs_t, max_len, terms,
                                   dense=True), 10)
    plain = _cuda_ms(lambda: OP.paths_reference(prev_t, src, recs_t,
                                                max_len, terms, dense=True),
                     2)
    nbytes, ops = _paths_work(gr.nnods, len(recs), max_len, 2,
                              terms[2].shape[1], 8)
    bound, by = _bound_ms(nbytes, ops, H100_F64_OPS_PER_S)
    rec["paths"] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                        max_abs_err=errs["float64"])

    # bend in lockstep with its twin: the tiny annulus's five paths of
    # tests/test_torch_refine.py (m 64, quad 8), in 2-D and turned into
    # 3-D, 10 and 50 steps, float64 and float32
    pts = []
    for deg in (10.0, 40.0, 80.0, 110.0, 140.0):
        r = rt.closest_point(gt, np.deg2rad(deg), rt.R, system="polar")
        p = rt.recontruct_path(Dt.prev, st, r)
        pts.append(np.stack([gt.x[p], gt.z[p]], axis=1))
    rng = np.random.default_rng(16)
    lock, f32_gate = [], {}
    for d in (2, 3):
        pl = pts if d == 2 else [_lift(p) for p in pts]
        stack = np.stack([RF.resample_path(p, 64) for p in pl])
        for iters in (10, 50):
            e64 = _bend_lockstep(stack, prof.r, prof.Vp, iters, "float64")
            assert e64[0] <= 1e-6 and e64[1] <= 1e-3, (d, iters, e64)
            e32 = _bend_lockstep(stack, prof.r, prof.Vp, iters, "float32")
            # the twin's own spread under a one-ulp nudge of its input
            s32 = stack.astype(np.float32)
            nudge = np.nextafter(s32, np.where(rng.random(s32.shape) < 0.5,
                                               np.inf, -np.inf)
                                 .astype(np.float32))
            tab = OB.uniform_table(*RF._uniform_slowness(prof.r, prof.Vp),
                                   torch.float32, "cuda")
            a = OB.bend_reference(torch.as_tensor(s32, device="cuda"), tab,
                                  3.0, rt.R, iters, 8)
            b = OB.bend_reference(torch.as_tensor(nudge, device="cuda"), tab,
                                  3.0, rt.R, iters, 8)
            spread = (float((a[1] - b[1]).abs().max()),
                      float((a[0] - b[0]).abs().max()))
            f32_gate[(d, iters)] = (e32, spread)
            lock.append(f"d={d} {iters} steps: float64 {e64[0]:.2e} s "
                        f"{e64[1]:.2e} km, float32 {e32[0]:.2e} s "
                        f"{e32[1]:.2e} km (twin's one-ulp spread "
                        f"{spread[0]:.2e} s {spread[1]:.2e} km)")
    # float32: within twice the most the twin itself moved under a
    # one-ulp nudge, over the four runs (Adam scales every gradient
    # component to about lr, so one ulp moves vertices by up to tens of
    # km within 10 steps)
    most = [max(v[k][i] for v in f32_gate.values()) for k, i in
            ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert most[0] <= 2 * most[2] and most[1] <= 2 * most[3], f32_gate
    # chunks: the same bend cut into launches
    P = torch.as_tensor(np.stack([RF.resample_path(p, 64) for p in pts]),
                        device="cuda")
    tab64 = OB.uniform_table(*RF._uniform_slowness(prof.r, prof.Vp),
                             torch.float64, "cuda")
    one = OB.bend(P, tab64, 3.0, rt.R, 120, 8)
    cut = OB.bend(P, tab64, 3.0, rt.R, 120, 8, chunk=35)
    assert torch.equal(one[0], cut[0]) and torch.equal(one[1], cut[1])

    # the --refine fan: the 150 paths of the 180x63 sweep solve, 800 steps
    # (m 128, quad 8), in float64 against the twin, and timed in float32
    # (the CLI's dtype) against the twin
    fan = [rt.recontruct_path(D.prev, src, r) for r in recs]
    fan = [np.stack([gr.x[p], gr.z[p]], axis=1) for p in fan]
    stack = np.stack([RF.resample_path(p, 128) for p in fan])
    P64 = torch.as_tensor(stack, device="cuda")
    Pk, tk = OB.bend(P64, tab64, 3.0, rt.R, 800, 8)
    Pt, tt = OB.bend_reference(P64, tab64, 3.0, rt.R, 800, 8)
    t_in = OB.ttime(P64, tab64, 8)
    assert bool((tk <= t_in + 1e-6).all()) and bool((tt <= t_in + 1e-6).all())
    fan_err = float((tk - tt).abs().max())
    assert fan_err <= 2.0 * JAX_REFINE_SPREAD64, (fan_err, JAX_REFINE_SPREAD64)
    tab32 = OB.uniform_table(*RF._uniform_slowness(prof.r, prof.Vp),
                             torch.float32, "cuda")
    P32 = torch.as_tensor(stack, dtype=torch.float32, device="cuda")
    bms = _cuda_ms(lambda: OB.bend(P32, tab32, 3.0, rt.R, 800, 8), 3)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    _, t_plain = OB.bend_reference(P32, tab32, 3.0, rt.R, 800, 8)
    e1.record()
    torch.cuda.synchronize()
    bplain = e0.elapsed_time(e1)
    bytes32, ops32 = OB.bend_work(*stack.shape, 8, 800, 4)
    bbound, bby = _bound_ms(bytes32, ops32)
    e32_fan = float((OB.bend(P32, tab32, 3.0, rt.R, 800, 8)[1] - t_plain)
                    .abs().max())
    bms64 = _cuda_ms(lambda: OB.bend(P64, tab64, 3.0, rt.R, 800, 8), 3)
    rec["bend"] = dict(ms=bms, plain_ms=bplain, bound_ms=bbound,
                       bound_by=bby, max_abs_err=e32_fan)
    # a table-shaped sub-batch (1,024 x 384 x 2, quad 16, float64; the
    # plan of refined_travel_time_table's launches, several passes of
    # segments a step): in lockstep with the twin after 10 steps (1e-6 s,
    # 1e-3 km); after 200 steps every time at or below its input's and
    # within twice the twin's own spread under a 1e-9 km nudge of the
    # interior vertices (seed 22; these perturbed candidates are flatter
    # than the fan's paths, so their spread is the yardstick, measured in
    # the run)
    Pb = torch.as_tensor(_table_batch(fan), device="cuda")
    lk = OB.bend(Pb, tab64, 3.0, rt.R, 10, 16)
    lt = OB.bend_reference(Pb, tab64, 3.0, rt.R, 10, 16)
    sub_lock = (float((lk[1] - lt[1]).abs().max()),
                float((lk[0] - lt[0]).abs().max()))
    assert sub_lock[0] <= 1e-6 and sub_lock[1] <= 1e-3, sub_lock
    _, tb_k = OB.bend(Pb, tab64, 3.0, rt.R, 200, 16)
    _, tb_t = OB.bend_reference(Pb, tab64, 3.0, rt.R, 200, 16)
    nudge = Pb.clone()
    nudge[:, 1:-1] += 1e-9 * torch.as_tensor(
        np.random.default_rng(22).choice([-1.0, 1.0], nudge[:, 1:-1].shape),
        device="cuda")
    _, tb_n = OB.bend_reference(nudge, tab64, 3.0, rt.R, 200, 16)
    tb_in = OB.ttime(Pb, tab64, 16)
    assert bool((tb_k <= tb_in + 1e-6).all()) and bool(
        (tb_t <= tb_in + 1e-6).all())
    sub_err = float((tb_k - tb_t).abs().max())
    sub_spread = float((tb_n - tb_t).abs().max())
    assert sub_err <= 2.0 * sub_spread, (sub_err, sub_spread)
    sub_ms = _cuda_ms(lambda: OB.bend(Pb, tab64, 3.0, rt.R, 200, 16), 2)
    sub_plan = OB.bend_plan(*Pb.shape, 16, 8, torch.cuda.get_device_properties(
        0).multi_processor_count)
    print(f"phase 3i kernels: paths (walk, COO rows, dense rows) on the "
          f"180x63 sweep prev ({gr.nnods} nodes, solve {t_solve:.2f} s, "
          f"150 receivers, max_len {max_len}) and on 16x6 with its halo, "
          f"float64 and float32: nodes and ids bit-equal to "
          f"paths_reference, vals and dense rows within {errs['float64']:.2e}"
          f" (float64) / {errs['float32']:.2e} (float32) relative; a "
          f"launch {ms:.4f} ms (float64, dense), plain {plain:.2f} ms, "
          f"bound {bound:.5f} ms ({by}). bend against bend_reference: "
          + "; ".join(lock) + f" (float32 gate: the kernel's most "
          f"{most[0]:.3g} s and {most[1]:.3g} km within twice the twin's "
          f"{most[2]:.3g} s and {most[3]:.3g} km); 120 steps in one "
          f"launch equal to 4 "
          f"launches of 35; the 180x63 --refine fan (150 x 128 x 2, quad "
          f"8, 800 steps): float64 max |t - twin| {fan_err:.3e} s (gate "
          f"2 x the JAX package's float64 spread {JAX_REFINE_SPREAD64:.3e} "
          f"s), every time at or below its input's; a launch {bms:.3f} ms "
          f"float32 (float64 {bms64:.3f} ms), plain {bplain:.1f} ms, bound "
          f"{bbound:.4f} ms ({bby}: {ops32 / 1e9:.2f} G operations), float32 "
          f"max |t - twin| {e32_fan:.3e} s; a table-shaped sub-batch "
          f"(1024 x 384 x 2, quad 16, float64, plan {sub_plan.threads} "
          f"threads x {sub_plan.lanes} lanes): 10 steps {sub_lock[0]:.2e} s "
          f"{sub_lock[1]:.2e} km from the twin, 200 steps max |t - twin| "
          f"{sub_err:.3e} s (the twin's own spread under a 1e-9 km nudge "
          f"{sub_spread:.3e} s), every time at or below its input's, a "
          f"launch {sub_ms:.3f} ms", flush=True)


def phase_paths(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch import example_tomography, main_annulus
    from raytracer_tpu_torch.solvers import refine as RF
    from raytracer_tpu_torch.solvers import sensitivity as S

    # main_annulus --refine at 180x63 (float32): the JAX package's refined
    # times at the same receivers within twice its own spread, and at or
    # below the SPM times of the same run
    prefix = os.path.join(tmp, "refine")
    _reset_counts()
    t0 = time.perf_counter()
    main_annulus.main(["--ntheta", "180", "--nr", "63", "--refine",
                       "--q", "600", "--freq", "1", "--out-prefix", prefix])
    t_cli = time.perf_counter() - t0
    counts = _counts()
    assert counts["bend"] == 1 and counts["rsweep"] > 0, counts
    rec["bend"]["launches"] = counts["bend"]
    ref = np.genfromtxt(f"{prefix}_travel_times_refined.csv", delimiter=",",
                        skip_header=1)
    spm = np.genfromtxt(f"{prefix}_travel_times.csv", delimiter=",",
                        skip_header=1)
    assert ref.shape == (150, 2) and np.isfinite(ref).all(), ref.shape
    np.testing.assert_array_equal(ref[:, 0], main_annulus.receiver_degrees())
    jerr = float(np.abs(ref[:, 1] - np.asarray(JAX_REFINE)).max())
    assert jerr <= 2.0 * JAX_REFINE_SPREAD, (jerr, JAX_REFINE_SPREAD)
    # at or below SPM up to float32's rounding of the two times, two ulps
    # (the receiver at 2 deg is one edge from the source, inside the
    # constant-velocity upper crust: its chord's continuous time is its
    # edge weight, L/v both, rounded apart; the CPU route lands 1.03 ulp
    # above the CSV's printed SPM time there)
    above = ref[:, 1] - spm[:, -1]
    ulp = np.spacing(np.abs(spm[:, -1]).astype(np.float32)).astype(float)
    assert np.all(above <= 2 * ulp), float((above - 2 * ulp).max())
    # the --refine fan's time split on the same grid (the sweep solver of
    # phase 3i): the solve with its prev, the host backtrace, the bend
    # (resampling and one launch), and the card's busy share of the bend
    solver, D, src, recs, max_len = rec["paths_180"]
    prof = rt.velocity_profile("ak135")
    t_solve = _median_ms(lambda: solver.solve(src))
    t0 = time.perf_counter()
    fan = [rt.recontruct_path(D.prev, src, r) for r in recs]
    t_back = 1e3 * (time.perf_counter() - t0)
    pts = [np.stack([solver.gr.x[p], solver.gr.z[p]], axis=1) for p in fan]

    events = []
    real_bend = RF.bend

    def evented_bend(P, *a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_bend(P, *a, **k)
        e1.record()
        events.append((e0, e1))
        return out

    RF.bend = evented_bend
    try:
        t_bend = _median_ms(lambda: RF.refine_paths_batch(
            pts, prof.r, prof.Vp, dtype="float32"))
    finally:
        RF.bend = real_bend
    torch.cuda.synchronize()
    # the card's busy time in the bend: from its first device operation
    # (the copy of the stack) to the end of its launch, CUDA events
    busy = statistics.median(a.elapsed_time(b) for a, b in events)
    # AnnulusSolver.sensitivity_matrix at 180x63, 150 receivers, equal to
    # the CPU route
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G = solver.sensitivity_matrix(D, src, recs)
    torch.cuda.synchronize()
    t_sens = 1e3 * (time.perf_counter() - t0)
    counts = _counts()
    assert counts["paths"] == 1 and sum(counts.values()) == 1, counts
    rec["paths"]["launches"] = counts["paths"]
    Gc = S.sensitivity_matrix(solver.gr, solver.U, D.prev, src, recs,
                              max_len, solver.halo, device="cpu")
    serr = float((G.cpu() - Gc).abs().max()) / float(Gc.abs().max())
    assert G.shape == (150, solver.gr.nnods) and serr <= 1e-12, serr
    t_sens2 = _median_ms(lambda: solver.sensitivity_matrix(D, src, recs))
    # refined_travel_time_table: 8 sources x 150 receivers at its defaults
    # (m 384, quad 16, 1600 steps, multistart), float64, the bend's share
    # by CUDA-synchronized host time around each call
    srcs = [rt.closest_point(solver.gr, np.deg2rad(d), rt.R, system="polar")
            for d in np.linspace(0.0, 315.0, 8)]
    bend_s, bend_calls = [], []
    real_bend = RF.bend

    def timed_bend(P, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_bend(P, *a, **k)
        torch.cuda.synchronize()
        bend_s.append(time.perf_counter() - t)
        bend_calls.append(tuple(P.shape))
        return out

    _reset_counts()
    RF.bend = timed_bend
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab = solver.refined_travel_time_table(srcs, recs,
                                               profile=(prof.r, prof.Vp))
        torch.cuda.synchronize()
        t_tab = time.perf_counter() - t0
    finally:
        RF.bend = real_bend
    counts = _counts()
    assert counts["bend"] == len(bend_calls) >= 2, (counts, bend_calls)
    assert tab.shape == (8, 150) and np.isfinite(tab).all()
    spm8 = solver.travel_time_table(srcs, recs)
    assert np.median(spm8 - tab) > 0.5, np.median(spm8 - tab)
    # the port's example_tomography at its defaults
    _reset_counts()
    t0 = time.perf_counter()
    out = example_tomography.main([])
    torch.cuda.synchronize()
    t_tomo = time.perf_counter() - t0
    tcounts = _counts()
    assert tcounts["paths"] == 12, tcounts
    red = 1 - out["misfit1"] / out["misfit0"]
    red_j = 1 - JAX_TOMO["misfit1"] / JAX_TOMO["misfit0"]
    assert abs(red - red_j) <= 0.02, (red, red_j)
    assert abs(out["corr"] - JAX_TOMO["corr"]) <= 0.02, out["corr"]
    rec["refine_split"] = (t_solve, t_back, t_bend, busy)
    print(f"phase 20 paths: main_annulus --refine at 180x63 {t_cli:.2f} s "
          f"(1 bend launch), its refined CSV within {jerr:.3e} s of the JAX "
          f"package's (gate 2 x its float32 spread {JAX_REFINE_SPREAD:.3e} "
          f"s) and {float(-above.max()):.3g} to {float(-above.min()):.4f} "
          f"s below the SPM CSV; the fan's split: solve with prev "
          f"{t_solve:.2f} ms, host backtrace {t_back:.2f} ms, bend "
          f"(resample + launch, float32) {t_bend:.2f} ms of which the card "
          f"is busy {busy:.3f} ms (idle {100 * (1 - busy / t_bend):.1f} "
          f"%); AnnulusSolver.sensitivity_matrix 180x63 x "
          f"150 receivers {t_sens:.2f} ms first, {t_sens2:.2f} ms steady "
          f"(median of 3, 1 paths launch), within {serr:.2e} relative of "
          f"the CPU route; refined_travel_time_table 8 x 150 (m 384, quad "
          f"16, 1600 steps, multistart) {t_tab:.2f} s, bend "
          f"{sum(bend_s):.2f} s of it in {len(bend_calls)} launches "
          f"{bend_calls}; example_tomography defaults {t_tomo:.2f} s "
          f"({tcounts['paths']} paths launches): misfit "
          f"{out['misfit0']:.2f} -> {out['misfit1']:.2f} s ({100 * red:.1f} "
          f"% reduction; JAX {100 * red_j:.1f} %), correlation "
          f"{out['corr']:.3f} (JAX {JAX_TOMO['corr']:.3f})", flush=True)


# ----------------------------------------------------------------------
# location and amplitudes: the gridsearch kernel
# ----------------------------------------------------------------------

# The JAX package on the CPU (tools/jax_locate_reference.py).  JAX_LOCATE:
# benchmarks/chip_locate.py's catalogue, nothing cut (init_annulus(180,
# 63), AK135 Vp, a float32 solver, 12 surface stations every 30 degrees,
# 64 on-grid events from default_rng(0) with 0.2 s of pick noise,
# locate_many(sigma=0.2), the search in float64): node hits and the mean
# distance of the picked nodes and of the refined positions to the true
# nodes (km).  JAX_AMPLITUDE: the root main_annulus.py --nr 63 --q 600
# --freq 1 --refine (float32), its amplitude CSV's row (deg, tstar_s,
# spreading_km, rel_amp, pcp_p_ratio, valid) at 30, 60, 90 and 150
# degrees.  JAX_EXAMPLE_LOCATION: the root example_location.run() at its
# defaults (float64).
JAX_LOCATE = {'hits': 58, 'node_err': 0.07479838709679477,
              'refined_err': 1.442721665652589}
JAX_AMPLITUDE = {
    30.0: [30.0, 0.6161679209534401, 18491.250463438562,
           7.804566357527372e-06, 0.06363872632550541, 1.0],
    60.0: [60.0, 1.012766652007171, 19850.571255278985,
           2.0913759944854574e-06, 0.15020596580793302, 1.0],
    90.0: [90.0, 1.3045057883039175, 50593.962746581936,
           3.2814398837240935e-07, 0.05773092948857021, 1.0],
    150.0: [150.0, 1.7456867535194582, float("nan"), float("nan"),
            float("nan"), 0.0],
}
JAX_EXAMPLE_LOCATION = {'node_err': 60.76793047280398,
                        'refined_err': 31.72570747485092}
LOCATE_STATION_DEGS = tuple(range(0, 360, 30))
# the tie rule's tolerances (ops/gridsearch_check.py): float64 holds m
# within 1e-12 of itself (direct) or of its terms (expanded) and t0
# within 1e-12 of its terms; float32 holds the direct m within 1e-4 of
# itself, the expanded m and both t0 within a few ulps of their terms
# (4 (K + 2) eps), and t0 within the solver's tol, 1e-3 s, besides
SEARCH_RTOL = {"float64": 1e-12, "float32": 1e-4}
SEARCH_T0_ATOL = {"float64": 0.0, "float32": 1e-3}


def _search_rows(T, T_obs, w2, mode):
    """The twin's rows of one search with the tie rule's tolerances in
    T's dtype."""
    from raytracer_tpu_torch.ops import gridsearch_check as GC

    dt = str(T.dtype).split(".")[-1]
    terms = (SEARCH_RTOL[dt] if dt == "float64"
             else GC.ulp_rtol(T.dtype, T.shape[0]))
    return GC.misfit_rows(T, T_obs, w2, mode, SEARCH_RTOL[dt], terms,
                          SEARCH_T0_ATOL[dt])


def _search_bound_ms(K, n, E, itemsize):
    """(bound ms, bound_by) of one grid search, for either formula: the
    fields and picks read once and (j, t0, m) written, against the
    expanded formula's operations (the fewest that give (j, t0, m); a
    fused multiply-add counts two).  Of them the (E, K) @ (K, n) product,
    E n 2K, runs at the tensor cores' rate in float64 (67 TFLOP/s); the
    per-column demeaning, n (6K + 2), and the combine, E n 3, at 34
    TFLOP/s; in float32 all at 67 TFLOP/s (the tensor cores would round
    to TF32)."""
    nbytes = (K * n + E * K + K) * itemsize + E * (8 + 2 * itemsize)
    prod, rest = 2 * E * n * K, 3 * E * n + n * (6 * K + 2)
    if itemsize == 8:
        t_o = prod / H100_F64_TC_OPS_PER_S + rest / H100_F64_OPS_PER_S
    else:
        t_o = (prod + rest) / H100_F32_OPS_PER_S
    t_b = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _search_check(T, T_obs, w2, mode, what, odd_first=None):
    """The kernel and the twin against the twin's rows on the card under
    the tie rule; returns the kernel's search_agreement summary."""
    import torch

    from raytracer_tpu_torch.ops import gridsearch as GS
    from raytracer_tpu_torch.ops import gridsearch_check as GC

    j, t0, m = GS.grid_search(T, T_obs, w2, mode)
    torch.cuda.synchronize()
    rows = _search_rows(T, T_obs, w2, mode)
    try:
        out = GC.search_agreement(rows, j, t0, m)
        if mode == "expanded":
            tw = GS.grid_search_catalogue_reference(T, T_obs, w2)
        else:
            tw = [torch.stack(v) for v in zip(*[
                GS.grid_search_reference(T, row, w2) for row in T_obs])]
        GC.search_agreement(rows, *tw)
    except AssertionError as e:
        raise AssertionError((what, *e.args)) from None
    if odd_first is not None:
        # exact duplicates: the first index, as the twin's argmin
        got = j[:len(odd_first)].tolist()
        assert got == list(odd_first), (what, got, odd_first)
    return out, (j, t0, m)


def phase_gridsearch_kernel(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops import gridsearch as GS

    torch.backends.cuda.matmul.allow_tf32 = False   # the twin's float32
    solver, _, _, _, _ = rec["paths_180"]
    gr = solver.gr
    stations = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                for d in LOCATE_STATION_DEGS]
    # the location path's fields (12 station solves, the first call:
    # phase 21 times the warm one)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = rt.station_fields(solver, stations)
    t_cold = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    ev = rng.integers(0, gr.nnods, size=64)
    T_obs = fields[:, ev].T + rng.normal(0.0, 0.2, (64, len(stations)))
    rec["locate_inputs"] = (stations, fields, ev, T_obs, t_cold)
    K, n, E = fields.shape[0], fields.shape[1], 64
    lines, rows_out, errs = [], {}, []
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype).split(".")[-1]
        T = torch.as_tensor(fields, dtype=dtype, device="cuda")
        O = torch.as_tensor(T_obs, dtype=dtype, device="cuda")
        w2 = torch.full((K,), 25.0, dtype=dtype, device="cuda")
        for mode in GS.MODES:
            out, _ = _search_check(T, O, w2, mode, f"180x63 {dt} {mode}")
            ms = _cuda_ms(lambda: GS.grid_search(T, O, w2, mode), 20)
            if mode == "expanded":
                plain = _cuda_ms(
                    lambda: GS.grid_search_catalogue_reference(T, O, w2), 3)
            else:
                plain = _cuda_ms(lambda: [GS.grid_search_reference(T, r, w2)
                                          for r in O], 1)
            bound, by = _search_bound_ms(K, n, E, T.element_size())
            rows_out[(dt, mode)] = dict(ms=ms, plain_ms=plain,
                                        bound_ms=bound, bound_by=by)
            errs.append(max(out["m_abs"], out["t0_err"]))
            # the one event of `locate`
            one, _ = _search_check(T, O[:1], w2, mode,
                                   f"180x63 {dt} {mode} E=1")
            errs.append(max(one["m_abs"], one["t0_err"]))
            ms1 = _cuda_ms(lambda: GS.grid_search(T, O[:1], w2, mode), 20)
            lines.append(f"{dt} {mode}: {out['same_node']} same node, "
                         f"{out['tied']} tied, m within {out['m_abs']:.1e} "
                         f"s^2 ({out['m_of_tol']:.1e} of its tolerance), t0 "
                         f"within {out['t0_err']:.1e} s; "
                         f"{ms:.4f} ms, plain {plain:.2f} ms, bound "
                         f"{bound:.5f} ms ({by}); one event {ms1:.4f} ms")
    # the odd case: K 7, 37 events over 3,617 columns, with non-finite
    # columns and exact duplicates (the first index wins); K 100, past
    # the kernel's register tile; an all-inf row
    odd = []
    for K2, n2, E2 in ((7, 3617, 37), (100, 20000, 9)):
        T2 = rng.uniform(10.0, 1200.0, (K2, n2))
        T2[:, rng.integers(0, n2, 40)] = np.inf
        T2[2, 11] = np.inf
        src = rng.integers(0, n2 // 2, 3)
        T2[:, src + n2 // 2] = T2[:, src]            # later duplicates
        T2[:, src] = np.where(np.isfinite(T2[:, src]), T2[:, src], 500.0)
        T2[:, src + n2 // 2] = T2[:, src]
        ob = T2[:, rng.integers(0, n2, E2)].T + 3.0
        ob[np.isinf(ob)] = 700.0
        ob[:3] = T2[:, src].T + 3.0
        ob[3:] += rng.normal(0.0, 0.2, ob[3:].shape)
        wk = rng.uniform(0.5, 4.0, K2)
        for dtype in (torch.float64, torch.float32):
            args = [torch.as_tensor(a, dtype=dtype, device="cuda")
                    for a in (T2, ob, wk)]
            for mode in GS.MODES:
                out, _ = _search_check(*args, mode,
                                       f"K={K2} n={n2} {dtype} {mode}",
                                       odd_first=src.tolist())
                odd.append(out["tied"])
                errs.append(max(out["m_abs"], out["t0_err"]))
    for mode in GS.MODES:
        j, _, m = GS.grid_search(
            torch.full((3, 300), float("inf"), device="cuda"),
            torch.ones((2, 3), device="cuda"), torch.ones(3, device="cuda"),
            mode)
        assert j.tolist() == [0, 0] and bool(torch.isinf(m).all()), j
    # the main path's call (float64 expanded) on the card alone, by
    # kernel: the two passes against the wrapper's torch ops
    T = torch.as_tensor(fields, device="cuda")
    O = torch.as_tensor(T_obs, device="cuda")
    w2 = torch.full((K,), 25.0, dtype=torch.float64, device="cuda")
    split = _kernel_split_ms(lambda: GS.grid_search(T, O, w2, "expanded"),
                             10)
    on_card = sum(v for k, v in split.items()
                  if k in KERNEL_NAMES["gridsearch"])
    # the main path's row (float64 expanded), with the largest m or t0
    # error of every case above, both formulas and dtypes
    rec["gridsearch"] = rows_out[("float64", "expanded")]
    rec["gridsearch"]["max_abs_err"] = max(errs)
    rec["gridsearch"]["on_card_ms"] = on_card
    lines.append(f"the float64 expanded call on the card {on_card:.4f} ms "
                 "in its two passes ("
                 + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
                 + " ms)")
    print(f"phase 3j kernels: gridsearch against its twin on the card at "
          f"the location path's shape (K {K}, n {n}, E {E}; station fields "
          f"{t_cold:.2f} s cold) under the tie rule: " + "; ".join(lines)
          + f"; the odd cases (K 7 n 3617 E 37 with non-finite and "
          f"duplicated columns, K 100 n 20000 E 9; both modes and dtypes, "
          f"exact duplicates at the first index; {sum(odd)} tied picks) "
          f"and an all-inf row (node 0) hold; the largest m or t0 error "
          f"over every case {max(errs):.2e}", flush=True)


def _rel_close(a, b, rtol):
    """a and b within rtol relative, or both NaN."""
    import math

    return abs(a - b) <= rtol * max(abs(a), abs(b)) or (
        math.isnan(a) and math.isnan(b))


def phase_locate(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch import example_location
    from raytracer_tpu_torch.ops import gridsearch as GS
    from raytracer_tpu_torch.ops import gridsearch_check as GC

    solver, _, _, _, _ = rec["paths_180"]
    gr = solver.gr
    stations, fields, ev, T_obs, t_cold = rec["locate_inputs"]
    K = len(stations)
    sigma = [0.2] * K
    prof = rt.velocity_profile("ak135")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = rt.station_fields(solver, stations)
    t_warm = time.perf_counter() - t0
    assert np.array_equal(warm, fields)
    # the catalogue: one gridsearch launch, then the host Gauss-Newton
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    locs = rt.locate_many(solver, stations, T_obs, sigma=sigma,
                          fields=fields)
    t_many = time.perf_counter() - t0
    counts = _counts()
    assert counts["gridsearch"] == 1 and sum(counts.values()) == 1, counts
    rec["gridsearch"]["launches"] = counts["gridsearch"]
    w2 = torch.full((K,), 25.0, dtype=torch.float64, device="cuda")
    T = torch.as_tensor(fields, device="cuda")
    O = torch.as_tensor(T_obs, device="cuda")
    t_search = _cuda_ms(lambda: GS.grid_search(T, O, w2, "expanded"), 20)
    # the CPU route on the same fields: the same searches under the tie
    # rule, and where the picks agree the same positions and origin times
    cpu = rt.AnnulusSolver(gr, solver.A, solver.halo, solver.U,
                           circulant=solver.circulant, device="cpu")
    locs_cpu = rt.locate_many(cpu, stations, T_obs, sigma=sigma,
                              fields=fields)
    rows = _search_rows(torch.as_tensor(fields), torch.as_tensor(T_obs),
                        w2.cpu(), "expanded")
    j, t0j, mj = GS.grid_search(T, O, w2, "expanded")
    assert j.tolist() == [l.node for l in locs]
    agree = GC.search_agreement(rows, j, t0j, mj)
    same = [a.node == b.node for a, b in zip(locs, locs_cpu)]
    assert sum(same) >= agree["same_node"], (sum(same), agree)
    dpos = max(float(np.hypot(a.x - b.x, a.z - b.z))
               for a, b, s in zip(locs, locs_cpu, same) if s)
    dt0 = max(abs(a.t0 - b.t0) for a, b, s in zip(locs, locs_cpu, same) if s)
    assert dpos <= 1e-6 and dt0 <= 1e-9, (dpos, dt0)
    x, z = np.asarray(gr.x), np.asarray(gr.z)
    hits = sum(int(l.node) == int(e) for l, e in zip(locs, ev))
    node_err = float(np.mean([np.hypot(x[l.node] - x[e], z[l.node] - z[e])
                              for l, e in zip(locs, ev)]))
    ref_err = float(np.mean([np.hypot(l.x - x[e], l.z - z[e])
                             for l, e in zip(locs, ev)]))
    assert abs(hits - JAX_LOCATE["hits"]) <= 2, (hits, node_err, ref_err)
    for k, v in (("node_err", node_err), ("refined_err", ref_err)):
        assert abs(v - JAX_LOCATE[k]) <= 0.1 * JAX_LOCATE[k] + 1.0, (k, v)
    # bend=True on the first 8 events: 12 prev trees shared, a bend each
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bent = rt.locate_many(solver, stations, T_obs[:8], sigma=sigma,
                          fields=fields, bend=True, profile=(prof.r, prof.Vp))
    torch.cuda.synchronize()
    t_bend = time.perf_counter() - t0
    bcounts = _counts()
    assert bcounts["gridsearch"] == 1 and bcounts["bend"] == 8, bcounts
    assert all(np.isfinite([l.x, l.z, l.t0, l.rms]).all() for l in bent)
    # one P+S event (the S fields are inf in the liquid core: the finite
    # mask), exact picks at an on-grid node
    Us = rt.interpolate_velocity(gr.r, rt.LinearInterpolation(prof.r,
                                                              prof.Vs))
    t0 = time.perf_counter()
    solver_s = rt.AnnulusSolver(gr, solver.A, solver.halo, Us)
    f_s = rt.station_fields(solver_s, stations)
    t_s = time.perf_counter() - t0
    assert not np.isfinite(f_s).all()
    e0 = int(ev[0])
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lps = rt.locate_phases([solver, solver_s], [stations, stations],
                           [fields[:, e0] + 3.0, f_s[:, e0] + 3.0],
                           fields=[fields, f_s], refine=False)
    t_ps = time.perf_counter() - t0
    assert _counts()["gridsearch"] == 1
    assert np.hypot(x[lps.node] - x[e0], z[lps.node] - z[e0]) < 1.0
    assert abs(lps.t0 - 3.0) < 1e-6, lps.t0
    # locate_many3d on a 64x64x32 wedge: 8 stations, 16 on-grid events
    g3 = rt.grid3d((0.0, 0.0, rt.R - 1500.0),
                   (np.deg2rad(40.0), np.deg2rad(40.0), rt.R), (64, 64, 32))
    U3 = rt.interpolate_velocity(g3.r, rt.LinearInterpolation(prof.r,
                                                              prof.Vp))
    n0, n1, n2 = g3.nnods
    rng = np.random.default_rng(21)
    top = n0 * n1 * (n2 - 1)
    st3 = (top + rng.integers(0, n0 * n1, 8)).tolist()
    ev3 = rng.integers(0, g3.nnods_total, 16)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f3 = rt.station_fields3d(g3, U3, st3)
    t_f3 = time.perf_counter() - t0
    l3 = rt.locate_many3d(g3, U3, st3, f3[:, ev3].T + 4.0, fields=f3,
                          refine=False)
    t_l3 = time.perf_counter() - t0 - t_f3
    c3 = _counts()
    assert c3["gridsearch"] == 1, c3
    p3 = np.stack([np.asarray(g3.x), np.asarray(g3.y), np.asarray(g3.z)],
                  axis=1)
    d3 = max(float(np.linalg.norm(p3[l.node] - p3[e]))
             for l, e in zip(l3, ev3))
    t03 = max(abs(l.t0 - 4.0) for l in l3)
    assert d3 <= 1e-6 and t03 <= 1e-9, (d3, t03)
    # example_location at its defaults on the card
    _reset_counts()
    t0 = time.perf_counter()
    ex = example_location.run(verbose=False)
    t_ex = time.perf_counter() - t0
    assert _counts()["gridsearch"] == 1
    assert ex["refined_err"] < ex["node_err"], ex
    for k in ("node_err", "refined_err"):
        assert abs(ex[k] - JAX_EXAMPLE_LOCATION[k]) <= \
            0.1 * JAX_EXAMPLE_LOCATION[k], (k, ex)
    # main_annulus --refine --q 600 --freq 1 at 180x63 (phase 20's run):
    # the host columns within 1e-9 relative of the JAX CLI's, t* along
    # the bent polylines within 5e-3.  A receiver whose predecessor walk
    # on the sweep field meets a twin 2-cycle (ROADMAP C.9: 3 of the 150;
    # the JAX CLI's CPU route, circulant, has none at these degrees) is
    # bent from the walk's junk polyline: its t* is printed, not gated
    amp = np.genfromtxt(os.path.join(tmp, "refine_amplitude.csv"),
                        delimiter=",", skip_header=2)
    arch = np.load(os.path.join(tmp, "refine.npz"))
    n_nodes = arch["x"].shape[0]
    worst, cycled = {}, []
    for deg, want in JAX_AMPLITUDE.items():
        i = int(np.argmin(np.abs(amp[:, 0] - deg)))
        row = amp[i]
        walk_ok = arch[f"path_{i}"].size <= n_nodes
        if not walk_ok:
            cycled.append(f"{deg:g} deg: t* {row[1]:.6f} s (JAX "
                          f"{want[1]:.6f})")
        for col, rtol in ((2, 1e-9), (4, 1e-9), (5, 1e-9), (1, 5e-3)):
            if col == 1 and not walk_ok:
                continue
            assert _rel_close(row[col], want[col], rtol), (deg, col, row)
            if np.isfinite(want[col]) and want[col]:
                worst[col] = max(worst.get(col, 0.0),
                                 abs(row[col] / want[col] - 1.0))
    assert len(cycled) <= 1, cycled
    print(f"phase 21 location at 180x63 ({gr.nnods} nodes, {K} stations, "
          f"64 events): station_fields cold {t_cold:.3f} s, warm "
          f"{t_warm:.3f} s; one gridsearch launch {t_search:.4f} ms; "
          f"locate_many (Gauss-Newton) {t_many:.3f} s; hits {hits} (JAX "
          f"{JAX_LOCATE['hits']}), mean node error {node_err:.3f} km "
          f"(JAX {JAX_LOCATE['node_err']:.3f}), refined {ref_err:.3f} km "
          f"(JAX {JAX_LOCATE['refined_err']:.3f}); the CPU route "
          f"{agree['same_node']} same picks and {agree['tied']} tied, "
          f"positions within {dpos:.1e} km and t0 within {dt0:.1e} s where "
          f"the picks agree; bend=True on 8 events {t_bend:.3f} s (8 bend "
          f"launches); P+S locate_phases {t_ps:.3f} s (the Vs solver and "
          f"its fields {t_s:.2f} s); locate_many3d 64x64x32 (8 stations, "
          f"16 events): fields {t_f3:.3f} s, locate {t_l3:.3f} s, on-grid "
          f"within {d3:.1e} km and t0 {t03:.1e} s; example_location "
          f"defaults {t_ex:.2f} s: node {ex['node_err']:.2f} km -> refined "
          f"{ex['refined_err']:.2f} km (JAX "
          f"{JAX_EXAMPLE_LOCATION['node_err']:.2f} -> "
          f"{JAX_EXAMPLE_LOCATION['refined_err']:.2f}); main_annulus "
          f"--refine --q 600 at 30/60/90/150 deg: spreading, pcp_p_ratio, "
          f"valid within {max(worst.get(2, 0), worst.get(4, 0)):.1e} and "
          f"tstar_s within {worst.get(1, 0):.1e} of the JAX CLI's"
          + (f" (a cycled walk, C.9: {'; '.join(cycled)})" if cycled
             else ""), flush=True)
    rec["locate_split"] = dict(t_cold=t_cold, t_warm=t_warm,
                               t_search=t_search, t_many=t_many,
                               t_bend=t_bend, t_ps=t_ps, t_f3=t_f3,
                               t_l3=t_l3, t_ex=t_ex)



# ----------------------------------------------------------------------
# multi-device: the xla sweep engine's tsweep kernel, the sharded paths
# ----------------------------------------------------------------------

# The JAX package on the CPU (tools/jax_shard_reference.py), float32, on
# init_annulus_circulant(180, 63, 20) from the surface source at theta 0:
# the theta-sharded solve on 1 and 2 devices (rounds, sha256 of the
# (1, n) float32 field, first 16 hex digits) and the xla engine's six
# modes (rounds, t(60), t(150)); r and kernel-r also on
# init_annulus_circulant(48, 12, 150).
JAX_SHARD = {'theta_d1': (23, '2ec9c9fc1a63dc10'),
             'theta_d2': (24, '41e8ec33e836b85f'),
             'theta': (23, 610.7423095703125, 1050.99462890625),
             'r': (17, 610.7423095703125, 1050.99462890625),
             'both': (3, 610.7423095703125, 1050.99462890625),
             'kernel': (3, 610.7423095703125, 1050.99462890625),
             'kernel-r': (19, 610.7464599609375, 1051.00390625),
             'hclosure': (3, 610.7423095703125, 1050.994384765625),
             'r@48x12': (6, 618.54736328125, 1065.2320556640625),
             'kernel-r@48x12': (4, 618.6096801757812, 1065.814453125)}


def _tsweep_work(tbl, st, S, nt, reverse, itemsize, carry):
    """(bytes, ops) of one sweep with col_relax: the field read and
    written once, the finite weights the pass reads and the carry
    columns; an add and a min per finite candidate (a finite weight of a
    tap row, once a column a source), as the other kernels' rows count."""
    import torch

    from raytracer_tpu_torch.ops.sweep_theta import _tap_groups

    g1_w, _, g2_w, _, w0, _ = _tap_groups(tbl, st, reverse)
    tabs = (g1_w, g2_w, w0, tbl.cfp, tbl.cbp)
    finite = sum(int(torch.isfinite(a).sum()) for a in tabs)
    nbytes = itemsize * (2 * S * nt * st.ML + finite
                         + (2 * S * st.ML if carry else 0))
    return nbytes, 2 * S * nt * finite


def _tsweep_route(tbl, st, reverse, col_relax, v):
    """The lanes a thread of the plan tsweep launches (0 on the global
    route)."""
    from raytracer_tpu_torch.ops import sweep_theta as sw

    _, d1, _, d2, _, d0 = sw._tap_groups(tbl, st, reverse)
    return sw.tsweep_plan(st.ML, v.element_size(), d1, d2, d0,
                          st.chain_spans, col_relax).lpt


def _wide_tsweep_tables(tbl, st, reps, nt):
    """The sweep tables `tbl`, `st` with every weight row's lanes repeated
    `reps` times (a column of ML * reps lanes) and `nt` columns: a column
    over what tsweep's shared route holds, for its global route."""
    tw = tbl._replace(wg=tuple(a.repeat(1, reps) for a in tbl.wg),
                      cfp=tbl.cfp.repeat(1, reps),
                      cbp=tbl.cbp.repeat(1, reps))
    return tw, st._replace(ML=st.ML * reps, nt=nt)


def phase_tsweep_kernel(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops import sweep_theta as sw
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    rng = np.random.default_rng(18)
    every = [(r, c, w) for r in (False, True) for c in (True, False)
             for w in (False, True)]
    # each direction with col_relax and carry_init each on and off
    # (a plain sweep at 180x63 takes ~1 s of small launches)
    cover = [(False, True, False), (False, False, True), (True, True, True),
             (True, False, False)]
    n_cases, max_err, rows, routes, wide = 0, 0.0, [], set(), []
    # every direction, col_relax and carry case at 48x12 (S=2) in both
    # dtypes, the covering four at 180x63 (S=1); S=8 at 180x63 in float32
    # with the theta-sharded solve's calls (col_relax, carry)
    # the routes tsweep_plan picks by shape: 90x80 (1,664 lanes: two lanes
    # a thread); forced at 180x63 S=2 float32 after the loop: two and four
    # lanes a thread
    for (nt, nr, sp), dtype, S, cases in (
            ((48, 12, 150.0), np.float32, 2, every),
            ((48, 12, 150.0), np.float64, 2, every),
            ((180, 63, 20.0), np.float32, 1, cover),
            ((180, 63, 20.0), np.float64, 1, cover),
            ((180, 63, 20.0), np.float32, 8,
             [(False, True, True), (True, True, True)]),
            ((90, 80, 20.0), np.float32, 2, cover[:2]),
            ((90, 80, 20.0), np.float64, 1, cover[2:])):
        gr, cg, _ = rt.init_annulus_circulant(nt, nr, sp, dtype=dtype)
        ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
        t, st = sw.pack_sweep_tables(ws, cg, dtype)
        tbl = sw.tables_to_device(t, "cuda")
        if (nt, dtype) == (180, np.float32):
            _tsweep_tables_180 = (tbl, st)
        if nt == 180 and S == 1:
            wide.append(_wide_tsweep_tables(tbl, st, 14 if dtype == np.float32
                                            else 7, 12) + (dtype, 2))
        v = rng.uniform(0.0, 1500.0, (S, st.nt, st.ML)).astype(dtype)
        v[rng.random(v.shape) < 0.4] = np.inf
        v = torch.from_numpy(v).cuda()
        carry = tuple(torch.from_numpy(rng.uniform(
            0.0, 1500.0, (S, st.ML)).astype(dtype)).cuda() for _ in range(2))
        for reverse, col_relax, with_carry in cases:
            ci = carry if with_carry else None
            got = sw.tsweep(v, tbl, st, reverse, col_relax, ci)
            want = sw._sweep(v, tbl, st, reverse, col_relax, ci)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            max_err = max(max_err, err)
            n_cases += 1
            plan = _tsweep_route(tbl, st, reverse, col_relax, v)
            routes.add(plan)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"tsweep != _sweep at {nt}x{nr} {np.dtype(dtype).name} "
                    f"S={S} reverse={reverse} col_relax={col_relax} "
                    f"carry={with_carry} ({plan} lanes a thread): "
                    f"max abs err {err}")
        if (nt, S) == (180, 1):
            ms = _cuda_ms(lambda: sw.tsweep(v, tbl, st, False), 20)
            plain = _cuda_ms(lambda: sw._sweep(v, tbl, st, False), 1)
            nbytes, ops = _tsweep_work(tbl, st, 1, st.nt, False,
                                       v.element_size(), False)
            bound, by = _bound_ms(nbytes, ops, (
                H100_F32_OPS_PER_S if dtype == np.float32
                else H100_F64_OPS_PER_S))
            rows.append(dict(dtype=np.dtype(dtype).name, ms=ms,
                             plain_ms=plain, bound_ms=bound, bound_by=by,
                             nbytes=nbytes, ops=ops))
    # the forced routes at 180x63 S=2 float32, forward, col_relax, carry
    tbl, st = _tsweep_tables_180
    v = torch.from_numpy(rng.uniform(0.0, 1500.0, (2, st.nt, st.ML)).astype(
        np.float32)).cuda()
    carry = tuple(torch.from_numpy(rng.uniform(0.0, 1500.0, (2, st.ML)).astype(
        np.float32)).cuda() for _ in range(2))
    want = sw._sweep(v, tbl, st, False, True, carry)
    keep = sw.TSWEEP_THREADS
    try:
        for threads in (448, 224):
            sw.TSWEEP_THREADS = threads
            got = sw.tsweep(v, tbl, st, False, True, carry)
            torch.cuda.synchronize()
            plan = _tsweep_route(tbl, st, False, True, v)
            routes.add(plan)
            n_cases += 1
            if not torch.equal(got, want):
                raise AssertionError(f"tsweep != _sweep at 180x63 S=2 with "
                                     f"{plan} lanes a thread")
    finally:
        sw.TSWEEP_THREADS = keep
    # the global route (ROADMAP C.15): forced (no shared memory) on every
    # 48x12 case in both dtypes; taken by a column over what the shared
    # route holds: the 180x63 rows' lanes repeated 14 times in float32
    # (12,544 lanes) and 7 times in float64 (6,272), 12 columns, S=2,
    # every case, timed
    for dtype in (np.float32, np.float64):
        gr, cg, _ = rt.init_annulus_circulant(48, 12, 150.0, dtype=dtype)
        ws = pack_twrapped_stencil(cg, dtype=dtype, band_closure=0)
        t, st = sw.pack_sweep_tables(ws, cg, dtype)
        wide.append((sw.tables_to_device(t, "cuda"), st, dtype, 2))
    keep, glob = sw.BLOCK_SMEM, []
    for k, (tbl, st, dtype, S) in enumerate(wide):
        forced = k >= 2
        v = rng.uniform(0.0, 1500.0, (S, st.nt, st.ML)).astype(dtype)
        v[rng.random(v.shape) < 0.4] = np.inf
        v = torch.from_numpy(v).cuda()
        carry = tuple(torch.from_numpy(rng.uniform(
            0.0, 1500.0, (S, st.ML)).astype(dtype)).cuda() for _ in range(2))
        try:
            if forced:
                sw.BLOCK_SMEM = 0
            for reverse, col_relax, with_carry in every:
                ci = carry if with_carry else None
                got = sw.tsweep(v, tbl, st, reverse, col_relax, ci)
                want = sw._sweep(v, tbl, st, reverse, col_relax, ci)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                max_err = max(max_err, err)
                n_cases += 1
                plan = _tsweep_route(tbl, st, reverse, col_relax, v)
                routes.add(plan)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"tsweep != _sweep on the global route ({st.ML} "
                        f"lanes, {np.dtype(dtype).name}, reverse={reverse}, "
                        f"col_relax={col_relax}, carry={with_carry}): max "
                        f"abs err {err}")
            if not forced:
                ms = _cuda_ms(lambda: sw.tsweep(v[:1], tbl, st, False), 3)
                glob.append(f"{st.ML} lanes x {st.nt} columns "
                            f"{np.dtype(dtype).name} {ms:.3f} ms a sweep")
        finally:
            sw.BLOCK_SMEM = keep
    assert routes == {0, 1, 2, 4}, routes
    rec["tsweep"] = dict(ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
                         bound_ms=rows[0]["bound_ms"],
                         bound_by=rows[0]["bound_by"], max_abs_err=max_err)
    print(f"phase 3k kernels: tsweep bit-equal to _sweep in {n_cases} sweeps "
          f"(48x12 S=2 float32 and float64: forward and backward, "
          f"col_relax on and off, with and without carry_init; 180x63 S=1 "
          f"float32 and float64: four covering each of those; 180x63 S=8 "
          f"float32 both directions; 90x80 (1,664 lanes) S=2 float32 and "
          f"S=1 float64; 180x63 S=2 float32 on forced routes; the global "
          f"route, 0 below, forced on every 48x12 case and taken by "
          f"{'; '.join(glob)}, S=2, every case) with {sorted(routes)} lanes "
          f"a thread; "
          f"one forward sweep with col_relax at 180x63 S=1: " + "; ".join(
              f"{r['dtype']} kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}, {r['nbytes'] / 1e6:.2f} MB, "
              f"{r['ops'] / 1e6:.1f} M ops)" for r in rows), flush=True)


def _at(d, gr, deg):
    import numpy as np

    import raytracer_tpu_torch as rt

    return float(d[rt.closest_point(gr, np.deg2rad(deg), rt.R,
                                    system="polar")])


# the modes whose radial sweeps (the plain `_sweep_r`, ~54 k launches a
# sweep at 180x63) phase 22 runs at the JAX tests' 48x12 instead
XLA_SMALL_MODES = ("r", "kernel-r")


def phase_xla_engine(rec: dict):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops.sweep_theta import (SWEEP_MODES,
                                                     solve_circulant_sweep)
    from raytracer_tpu_torch.ops.wrapped_t import pack_twrapped_stencil

    cfg = rt.SolverConfig(dtype="float32")
    grids = {}
    for key, (gr, cg) in (("180x63", rec["sweep_180"][:2]),
                          ("48x12", rt.init_annulus_circulant(
                              48, 12, 150.0)[:2])):
        src = rt.closest_point(gr, 0.0, rt.R, system="polar")
        ws = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0)
        d_p, _ = solve_circulant_sweep(cg, src, cfg, engine="pallas",
                                       _packed=ws)
        grids[key] = (gr, cg, src, ws, d_p)
    parts = []
    for mode in SWEEP_MODES:
        small = mode in XLA_SMALL_MODES
        key = "48x12" if small else "180x63"
        gr, cg, src, ws, d_p = grids[key]
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, rounds = solve_circulant_sweep(cg, src, cfg, mode=mode,
                                          _packed=ws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        n_cols = sum(s in ("fwd", "bwd") for s in SWEEP_MODES[mode])
        assert counts["tsweep"] == n_cols * rounds, (mode, rounds, counts)
        assert counts["rsweep"] == 0, counts
        assert np.isfinite(d).all()
        t60, t150 = _at(d[0], gr, 60.0), _at(d[0], gr, 150.0)
        if not small:
            assert abs(t60 - T60_REF) <= T_ATOL, (mode, t60)
            assert abs(t150 - T150_REF) <= T_ATOL, (mode, t150)
        err = float(np.abs(d - d_p).max())
        # kernel-r is seam-blind by design: no theta sweep repairs the
        # seam, so it stops short of the fixpoint (the JAX package's
        # tests leave it out of theirs, tests/test_sweep_theta.py:39);
        # its distance from the pallas field is printed
        assert mode == "kernel-r" or err <= ENGINE_ATOL, (mode, err)
        r_j, t60_j, t150_j = JAX_SHARD[f"{mode}@48x12" if small else mode]
        assert rounds == r_j, (mode, rounds, r_j)
        assert abs(t60 - t60_j) <= CPU_ATOL and abs(t150 - t150_j) <= CPU_ATOL
        if mode == "theta":
            rec["tsweep"]["launches"] = counts["tsweep"]
            rec["xla_theta_ms"] = 1e3 * secs
        parts.append(f"{mode} at {key} {rounds} rounds (JAX {r_j}), tsweep "
                     f"{counts['tsweep']}, t(60)={t60:.4f} t(150)={t150:.4f}, "
                     f"max |xla - pallas| = {err:.3g} s, {secs:.2f} s")
    print("phase 22 xla engine (surface source, float32; r and kernel-r at "
          "48x12, the others at 180x63): " + "; ".join(parts), flush=True)


def _timed(fn):
    """(result, seconds) of fn() between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _digest32(vals) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(
        vals, dtype=np.float32).tobytes()).hexdigest()[:16]


def _halo_ms(mesh, ML, n=50) -> float:
    """Milliseconds of one round's collectives on `mesh`'s theta ring:
    the +-2-column exchange, the fan's minimum and the vote, at one
    source."""
    import torch

    from raytracer_tpu_torch.parallel import mesh as pm

    a = torch.zeros((1, 2, ML), device=mesh.device)
    c = torch.zeros((1,), device=mesh.device)
    flag = torch.zeros((), dtype=torch.bool, device=mesh.device)

    def one():
        pm.ring_exchange(a, a, mesh, pm.THETA_AXIS)
        pm.all_min(c, mesh, pm.THETA_AXIS)
        pm.any_of(flag, mesh, pm.THETA_AXIS)

    one()
    _, secs = _timed(lambda: [one() for _ in range(n)])
    return 1e3 * secs / n


def phase_sharded_one_rank(rec: dict, tmp: str):
    import numpy as np
    import torch
    import torch.distributed as dist

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch import parallel as par
    from raytracer_tpu_torch.ops.circulant import solve_circulant
    from raytracer_tpu_torch.ops.sweep_theta import solve_circulant_sweep
    from raytracer_tpu_torch.ops.stream_t import solve_circulant_stream
    from raytracer_tpu_torch.ops.wrapped_t import solve_circulant_twrapped
    from raytracer_tpu_torch.parallel import shard3d, theta_shard
    from raytracer_tpu_torch.solvers.bfm import solve_state

    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "nccl_one_rank"), rank=0, world_size=1)
    try:
        mesh = par.make_mesh()
        assert mesh.device.type == "cuda" and dist.get_backend() == "nccl"
        gr, cg, U, src, _, receivers, _ = rec["sweep_180"]
        recs = np.asarray(receivers[:TABLE_RECEIVERS])
        srcs = [rt.closest_point(gr, np.deg2rad(d), rt.R, system="polar")
                for d in np.linspace(0.0, 315.0, TABLE_SOURCES)]
        cfg = rt.SolverConfig(dtype="float32")
        ggr, _, _, _, _, G, _, _ = rec["graph_180"]
        parts, checked = [], {}

        def table(name, kernel, fn, ref):
            """`kernel` "none": the plain circulant oracle, no kernel."""
            _reset_counts()
            got, secs = _timed(fn)
            n = _counts().get(kernel, 0)
            assert n > 0 or kernel == "none", (name, kernel)
            want = ref()
            assert got.shape == want.shape and np.array_equal(got, want), (
                name, float(np.abs(got - want).max()))
            checked[name] = got
            parts.append(f"{name} {got.shape[0]}x{got.shape[1]} bit-equal, "
                         f"{kernel} {n}, {1e3 * secs:.1f} ms")

        # the ELL graph's grid (init_annulus) numbers its nodes otherwise
        g_srcs = [rt.closest_point(ggr, np.deg2rad(d), rt.R, system="polar")
                  for d in np.linspace(0.0, 315.0, TABLE_SOURCES)]
        g_recs = np.asarray(_fan(ggr)[1][:TABLE_RECEIVERS])
        table("ell", "bfm_step",
              lambda: par.travel_time_table(G, g_srcs, g_recs, cfg, mesh),
              lambda: solve_state(G, g_srcs, cfg).dist[
                  :, torch.as_tensor(g_recs).cuda()].cpu().numpy())
        bc = cfg.band_closure
        table("twrapped", "titer",
              lambda: par.travel_time_table_twrapped(cg, srcs, recs, cfg,
                                                     mesh),
              lambda: solve_circulant_twrapped(cg, srcs, cfg,
                                               band_closure=bc, batch=8,
                                               receivers=recs)[0])
        table("stream", "band",
              lambda: par.travel_time_table_stream(cg, srcs, recs, cfg, mesh),
              lambda: solve_circulant_stream(cg, srcs, cfg, band_closure=bc,
                                             warm_levels=0, batch=8,
                                             receivers=recs)[0])
        table("sweep", "rsweep",
              lambda: par.travel_time_table_sweep(cg, srcs, recs, cfg, mesh),
              lambda: solve_circulant_sweep(cg, srcs, cfg, batch=8,
                                            receivers=recs,
                                            engine="pallas")[0])
        table("circulant", "none",
              lambda: par.travel_time_table_circulant(cg, srcs, recs, cfg,
                                                      mesh),
              lambda: np.stack([solve_circulant(cg, s, cfg)[0][recs]
                                for s in srcs]).astype(np.float64))
        g3, U3, packed, _, _ = rec["wedge"]
        s3 = np.linspace(0, g3.nnods_total - 1, 64).astype(np.int64)
        r3 = np.linspace(0, g3.nnods_total - 1, 1024).astype(np.int64)
        table("3d", "sweep3d",
              lambda: par.travel_time_table_3d(packed, s3, r3, cfg, mesh,
                                               engine="pallas"),
              lambda: rt.solve3d(g3, U3, s3, cfg, receivers=r3,
                                 engine="pallas", source_batch=1,
                                 _packed=packed)[0])
        # the theta-sharded solve on one rank: the JAX package's D = 1
        # rounds and bits
        tmesh = par.make_theta_mesh()
        _reset_counts()
        (v1, r1), t_theta1 = _timed(lambda: theta_shard.
                                    solve_sweep_theta_sharded(cg, [src], cfg,
                                                              tmesh))
        n_ts = _counts()["tsweep"]
        assert n_ts == 2 * r1, (n_ts, r1)
        r_j, dig_j = JAX_SHARD["theta_d1"]
        assert r1 == r_j and _digest32(v1) == dig_j, (r1, r_j, _digest32(v1))
        assert abs(_at(v1[0], gr, 60.0) - T60_REF) <= T_ATOL
        assert abs(_at(v1[0], gr, 150.0) - T150_REF) <= T_ATOL
        src2 = rt.closest_point(gr, np.deg2rad(113.0), 4000.0,
                                system="polar")
        v2, _ = theta_shard.solve_sweep_theta_sharded(cg, [src2], cfg, tmesh)
        rec["theta_one_rank"] = (v1, r1, v2, t_theta1)
        # the slab solve at 128x128x64 on one rank: the single-device
        # sweep solve's fixpoint
        wsrc = int(rec["grid3d_single"][0])
        _reset_counts()
        (d_sl, it_sl), t_slab1 = _timed(lambda: shard3d.solve3d_sharded(
            g3, U3, [wsrc], cfg, par.make_shard3d_mesh()))
        n_pl = _counts()["plane3d"]
        assert n_pl == 6 * it_sl, (n_pl, it_sl)
        d_sw, _ = rt.solve3d(g3, U3, [wsrc], cfg, engine="sweep",
                             _packed=packed)
        err_sl = float(np.abs(d_sl - d_sw).max())
        assert err_sl <= ENGINE_ATOL, err_sl
        rec["slab_one_rank"] = (d_sl, d_sw, t_slab1)
        # the bend of the --refine fan
        solver, D, psrc, precs, _ = rec["paths_180"]
        pts = [np.stack([solver.gr.x[p], solver.gr.z[p]], axis=1)
               for p in (rt.recontruct_path(D.prev, psrc, r) for r in precs)]
        prof = rt.velocity_profile("ak135")
        _reset_counts()
        (Pb, tb), t_bend1 = _timed(lambda: par.refine_paths_sharded(
            pts, prof.r, prof.Vp, mesh))
        n_b = _counts()["bend"]
        assert n_b >= 1, n_b
        Pr, tr = rt.refine_paths_batch(pts, prof.r, prof.Vp)
        assert np.array_equal(Pb, Pr) and np.array_equal(tb, tr)
        rec["bend_one_rank"] = (pts, Pb, tb, t_bend1)
        rec["tables_one_rank"] = (srcs, recs, checked)
        ms_round = 1e3 * t_theta1 / r1
    finally:
        dist.destroy_process_group()
    print(f"phase 23 one-rank NCCL group on cuda:0: tables 8 x 150 at 180x63 "
          f"(3-D 64 x 1024 at {WEDGE_DIMS}): " + "; ".join(parts)
          + f"; theta-sharded 180x63 D=1: {r1} rounds (JAX {r_j}), bits equal "
          f"to the JAX package's, tsweep {n_ts}, {1e3 * t_theta1:.1f} ms "
          f"({ms_round:.2f} ms a round); slab solve {WEDGE_DIMS} on one rank: "
          f"{it_sl} rounds, plane3d {n_pl}, max |slab - sweep| = "
          f"{err_sl:.3g} s, {1e3 * t_slab1:.1f} ms; sharded bend of the "
          f"{len(pts)}-path fan: bend {n_b}, equal to refine_paths_batch, "
          f"{1e3 * t_bend1:.1f} ms", flush=True)


def _gloo_probe(log_dir: str):
    """Which gloo collectives take CUDA tensors on this card: each op on
    a cuda:0 tensor in turn, its outcome appended to this rank's file in
    `log_dir` before the next one starts (an op that aborts the process
    leaves the file ending before it).  The point-to-point pair goes
    last."""
    import datetime

    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    x = torch.ones(4, device="cuda")
    wait = datetime.timedelta(seconds=20)

    def p2p():
        peer = 1 - rank
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, peer),
                dist.P2POp(dist.irecv, torch.empty_like(x), peer)]):
            w.wait(timeout=wait)

    ops = (("all_reduce", lambda: dist.all_reduce(x, async_op=True)),
           ("broadcast", lambda: dist.broadcast(x, 0, async_op=True)),
           ("barrier", lambda: dist.barrier(async_op=True)),
           ("all_gather", lambda: dist.all_gather(
               [torch.empty_like(x) for _ in range(2)], x, async_op=True)),
           ("isend/irecv", p2p))
    with open(os.path.join(log_dir, f"probe{rank}.txt"), "w") as f:
        for name, fn in ops:
            f.write(f"{name}: ")
            f.flush()
            os.fsync(f.fileno())
            try:
                work = fn()
                if work is not None:
                    work.wait(timeout=wait)
                torch.cuda.synchronize()
                f.write("ok\n")
            except RuntimeError as e:
                f.write(str(e).splitlines()[0][:100] + "\n")
            f.flush()
            os.fsync(f.fileno())


def _gloo_cuda_ops(tmp: str) -> str:
    """phase 24's probe in a group of its own: the outcome of each op,
    and where the group aborted if one of them ended the process."""
    from raytracer_tpu_torch.parallel import launch

    log_dir = os.path.join(tmp, "gloo_probe")
    os.makedirs(log_dir, exist_ok=True)
    ended = "completed"
    try:
        launch.run_group(_gloo_probe, 2, log_dir, backend="gloo",
                         device="cuda", timeout=120)
    except RuntimeError as e:
        # the probe measures the library, it checks nothing of the port:
        # a group the library ends is its result
        ended = "aborted: " + str(e).splitlines()[0]
    with open(os.path.join(log_dir, "probe0.txt")) as f:
        lines = [ln.strip() for ln in f.read().split("\n") if ln.strip()]
    return "; ".join(lines) + f" (the group {ended})"


def _two_rank_job(job):
    """One rank of phase 24's two-rank gloo group on one card."""
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch import parallel as par
    from raytracer_tpu_torch.parallel import shard3d, theta_shard
    from raytracer_tpu_torch.solvers.solve3d import prepare3d

    cfg = rt.SolverConfig(dtype="float32")
    out = {}

    def run(name, kernel, fn):
        _reset_counts()
        res, secs = _timed(fn)
        out[name] = (res, secs, _counts()[kernel] if kernel else None)

    cg, src, src2 = job["theta"]
    tmesh = par.make_theta_mesh()
    run("theta", "tsweep", lambda: theta_shard.solve_sweep_theta_sharded(
        cg, [src], cfg, tmesh))
    out["halo_ms"] = _halo_ms(tmesh, job["ML"])
    gmesh = par.mesh.make_grid_mesh(2, 1)
    run("grid2x1", "tsweep", lambda: theta_shard.solve_sweep_mesh_sharded(
        cg, [src, src2], cfg, gmesh))
    g3, U3, wsrc = job["slab"]
    run("slab", "plane3d", lambda: shard3d.solve3d_sharded(
        g3, U3, [wsrc], cfg, par.make_shard3d_mesh(), shard_axis=1))
    srcs, recs = job["tables"]
    smesh = par.make_mesh()
    run("sweep", "rsweep", lambda: par.travel_time_table_sweep(
        cg, srcs, recs, cfg, smesh))
    run("twrapped", "titer", lambda: par.travel_time_table_twrapped(
        cg, srcs, recs, cfg, smesh))
    run("stream", "band", lambda: par.travel_time_table_stream(
        cg, srcs, recs, cfg, smesh))
    run("circulant", None, lambda: par.travel_time_table_circulant(
        cg, srcs, recs, cfg, smesh))
    egr, eA, ehalo, eU, esrcs, erecs = job["ell"]
    G = rt.prepare(eA, ehalo, egr, eU)
    run("ell", "bfm_step", lambda: par.travel_time_table(G, esrcs, erecs,
                                                          cfg, smesh))
    s3, r3 = job["3d"]
    packed = prepare3d(g3, U3, cfg)
    run("3d", "sweep3d", lambda: par.travel_time_table_3d(
        packed, s3, r3, cfg, smesh, engine="pallas"))
    pts, prof_r, prof_v = job["bend"]
    run("bend", "bend", lambda: par.refine_paths_sharded(pts, prof_r, prof_v,
                                                         smesh))
    return out


def phase_sharded_two_ranks(rec: dict, tmp: str):
    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch.ops.sweep_theta import solve_circulant_sweep
    from raytracer_tpu_torch.parallel import launch

    gr, cg, U, src, _, _, _ = rec["sweep_180"]
    src2 = rt.closest_point(gr, np.deg2rad(113.0), 4000.0, system="polar")
    v1, r1, v2, t_theta1 = rec["theta_one_rank"]
    g3, U3, _, _, _ = rec["wedge"]
    d_sl1, d_sw, t_slab1 = rec["slab_one_rank"]
    srcs, recs, one_rank = rec["tables_one_rank"]
    pts, Pb, tb, t_bend1 = rec["bend_one_rank"]
    prof = rt.velocity_profile("ak135")
    from raytracer_tpu_torch.ops.stream_t import solve_circulant_stream
    from raytracer_tpu_torch.ops.wrapped_t import (pack_twrapped_stencil,
                                                   solve_circulant_twrapped)
    from raytracer_tpu_torch.solvers.bfm import solve_state
    ML = pack_twrapped_stencil(cg, dtype=np.float32, band_closure=0).ML
    # the ELL table on the 48x12 graph (each rank prepares its own copy;
    # at 180x63 that takes ~6 s a rank)
    egr, eA, ehalo = rt.init_annulus(48, 12, spacing=150.0)
    eU = _ak135_vp(egr)
    esrcs = [rt.closest_point(egr, np.deg2rad(d), rt.R, system="polar")
             for d in np.linspace(0.0, 315.0, TABLE_SOURCES)]
    erecs = np.asarray(_fan(egr)[1][:TABLE_RECEIVERS])
    s3 = np.linspace(0, g3.nnods_total - 1, 64).astype(np.int64)
    r3 = np.linspace(0, g3.nnods_total - 1, 1024).astype(np.int64)
    job = dict(theta=(cg, src, src2), ML=ML,
               slab=(g3, U3, int(rec["grid3d_single"][0])),
               tables=(srcs, recs), ell=(egr, eA, ehalo, eU, esrcs, erecs),
               bend=(pts, prof.r, prof.Vp))
    job["3d"] = (s3, r3)
    t0 = time.perf_counter()
    res = launch.run_group(_two_rank_job, 2, job, backend="gloo",
                           device="cuda", timeout=300)
    t_group = time.perf_counter() - t0
    tables = ("sweep", "twrapped", "stream", "circulant", "ell", "3d")
    for name in ("theta", "grid2x1", "slab", "bend") + tables:
        a, b = res[0][name][0], res[1][name][0]
        if name in tables:
            a, b = [a], [b]
        for x, y in zip(a, b):      # every rank returns the whole result
            assert np.array_equal(np.asarray(x), np.asarray(y)), name
        assert name == "circulant" or (res[0][name][2] > 0
                                       and res[1][name][2] > 0), (
            name, res[0][name][2], res[1][name][2])
    (v_d2, r_d2), t_theta2, n_ts = res[0]["theta"]
    r_j, dig_j = JAX_SHARD["theta_d2"]
    assert r_d2 == r_j, (r_d2, r_j)
    assert _digest32(v_d2) == dig_j, (_digest32(v_d2), dig_j)
    assert n_ts == 2 * r_d2, (n_ts, r_d2)
    for deg, ref in ((60.0, T60_REF), (150.0, T150_REF)):
        assert abs(_at(v_d2[0], gr, deg) - ref) <= T_ATOL
    err_d2 = float(np.abs(v_d2 - v1).max())
    assert err_d2 <= ENGINE_ATOL, err_d2
    # 2 source rows x 1 theta column: each row the one-rank D = 1 solve
    (v_g, r_g), _, _ = res[0]["grid2x1"]
    assert np.array_equal(v_g[0], v1[0]) and np.array_equal(v_g[1], v2[0])
    (d_sl2, it_sl2), t_slab2, n_pl = res[0]["slab"]
    err_sl = float(np.abs(d_sl2 - d_sw).max())
    assert err_sl <= ENGINE_ATOL, err_sl
    # each rank solves its 4 sources as one batch, whose rounds run until
    # all 4 converge: the batched engines' reference is the single-device
    # table in blocks of 4; the circulant and 3-D tables solve a source
    # at a time, so phase 23's one-rank tables are theirs
    cfg = rt.SolverConfig(dtype="float32")
    bc = cfg.band_closure
    G = rt.prepare(eA, ehalo, egr, eU)
    blocks = {
        "sweep": lambda b: solve_circulant_sweep(
            cg, b, cfg, batch=4, receivers=recs, engine="pallas")[0],
        "twrapped": lambda b: solve_circulant_twrapped(
            cg, b, cfg, band_closure=bc, batch=4, receivers=recs)[0],
        "stream": lambda b: solve_circulant_stream(
            cg, b, cfg, band_closure=bc, warm_levels=0, batch=4,
            receivers=recs)[0],
    }
    t_tab2 = {}
    for name in tables:
        got, t_tab2[name], _ = res[0][name]
        if name in blocks:
            want = np.concatenate([blocks[name](srcs[i:i + 4])
                                   for i in (0, 4)])
        elif name == "ell":
            want = np.concatenate([solve_state(G, esrcs[i:i + 4], cfg).dist[
                :, torch.as_tensor(erecs).cuda()].cpu().numpy()
                for i in (0, 4)])
        else:
            want = one_rank[name]
        assert got.shape == want.shape and np.array_equal(got, want), (
            name, float(np.abs(got - want).max()))
    (P2, t2), t_bend2, n_b = res[0]["bend"]
    assert np.array_equal(P2, Pb) and np.array_equal(t2, tb)
    halo_ms = statistics.mean(r["halo_ms"] for r in res)
    ms_round = 1e3 * t_theta2 / r_d2
    probe = _gloo_cuda_ops(tmp)
    rec["shard_timing"] = dict(theta1=t_theta1, r1=r1, theta2=t_theta2,
                               r2=r_d2, halo_ms=halo_ms, slab1=t_slab1,
                               slab2=t_slab2)
    print(f"phase 24 two ranks sharing cuda:0 over gloo (host-staged "
          f"exchanges; group {t_group:.1f} s with spawning): theta-sharded "
          f"180x63 D=2: {r_d2} rounds (JAX {r_j}), bits equal to the JAX "
          f"package's, tsweep {n_ts} a rank, max |D=2 - D=1| = {err_d2:.3g} "
          f"s, solve {1e3 * t_theta2:.1f} ms ({ms_round:.2f} ms a round; "
          f"one rank D=1 {1e3 * t_theta1:.1f} ms, "
          f"{1e3 * t_theta1 / r1:.2f} ms a round); one round's exchange, "
          f"fan minimum and vote {halo_ms:.3f} ms = "
          f"{100 * halo_ms / ms_round:.1f} % of a round; 2x1 mesh {r_g} "
          f"rounds, each row equal to its one-rank solve; slab solve "
          f"{WEDGE_DIMS} 2 slabs along phi: {it_sl2} rounds, plane3d {n_pl} "
          f"a rank, max |slab - sweep| = {err_sl:.3g} s, {1e3 * t_slab2:.1f} "
          f"ms (one rank {1e3 * t_slab1:.1f} ms); the tables over 2 ranks "
          f"(8 x 150 at 180x63, ell on the 48x12 graph, 3-D 64 x 1024), "
          f"sweep, twrapped, stream and ell equal to single-device blocks "
          f"of 4, circulant and 3-D to phase 23's one-rank tables: "
          + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in t_tab2.items())
          + f"; bend of "
          f"{len(pts)} paths equal to one rank's, bend {n_b} a rank, "
          f"{1e3 * t_bend2:.1f} ms (one rank {1e3 * t_bend1:.1f} ms); gloo "
          f"with CUDA tensors: {probe}", flush=True)


# The reference-faithful mesh (init_annulus(..., faithful=True): the
# reference mesher's duplicated coincident secondary nodes), the JAX
# package's figures on the CPU (tools/jax_faithful_reference.py).
# 180x50, spacing 50: the counts, digests and 4-decimal Dijkstra receiver
# times of benchmarks/faithful_digests.json (the script reads no
# benchmark file; the tool recomputes them equal)
FAITHFUL_180x50 = {
    "nodes": 71101, "edges": 6793560, "halo_rows": 13320,
    "r_sorted_sha256_16": "28aaef367218fed5",
    "degree_hist_sha256_16": "e82d19e1e8c88b9a"}
FAITHFUL_180x50_TT = [
    38.3411, 70.3745, 97.6563, 124.9299, 152.2117, 179.4853,
    206.3409, 232.7643, 258.495, 281.2013, 302.4328, 322.8377,
    341.0037, 358.9211, 376.5146, 394.1044, 411.447, 428.6785,
    445.6456, 462.4838, 478.9455, 494.9714, 510.7908, 526.2668,
    541.6221, 556.7068, 571.4659, 585.9044, 600.0951, 614.0208,
    627.4771, 640.6652, 653.5287, 666.2369, 678.562, 690.7185,
    702.6234, 714.1403, 725.4397, 736.2979, 746.764, 757.0309,
    767.0172, 776.6304, 785.9769, 795.1913, 804.3444, 813.4047,
    822.3994, 831.3513, 840.306, 849.2579, 858.2125, 867.1644,
    876.119, 885.0709, 894.0255, 902.9774, 911.9321, 920.884,
    929.8386, 938.7905, 947.7451, 956.697, 965.6516, 974.6035,
    983.5581, 992.51, 1001.4647, 1010.4166, 1019.3712, 1028.3231,
    1037.2777, 1046.2296, 1055.1842, 1055.1842, 1046.2296, 1037.2777,
    1028.3231, 1019.3712, 1010.4166, 1001.4647, 992.51, 983.5581,
    974.6035, 965.6516, 956.697, 947.7451, 938.7905, 929.8386,
    920.884, 911.9321, 902.9774, 894.0255, 885.0709, 876.119,
    867.1644, 858.2125, 849.2579, 840.306, 831.3513, 822.3994,
    813.4047, 804.3444, 795.1913, 785.9769, 776.6304, 767.0172,
    757.0309, 746.764, 736.2979, 725.4397, 714.1403, 702.6234,
    690.7185, 678.562, 666.2369, 653.5287, 640.6652, 627.4771,
    614.0208, 600.0951, 585.9044, 571.4659, 556.7068, 541.6221,
    526.2668, 510.7908, 494.9714, 478.9455, 462.4838, 445.6456,
    428.6785, 411.447, 394.1044, 376.5146, 358.9211, 341.0037,
    322.8377, 302.4328, 281.2013, 258.495, 232.7643, 206.3409,
    179.4853, 152.2117, 124.9299, 97.6563, 70.3745, 38.3411,
]
FAITHFUL_TT_ATOL = 5.1e-5     # the digests' 4 decimals, plus rounding
# 180x63, spacing 20: nodes, slots a column; scipy Dijkstra's t(60) and
# t(150) on the JAX package's weight_matrix with its default float32
# weights and with float64 ones; the float64 and float32 sweep on the
# JAX package's accelerator engine (pallas, interpret mode): rounds,
# t(60), t(150), and the receiver walks (of 150) that reach the source
# without a cycle (ROADMAP C.9)
FAITHFUL_180x63 = {"nodes": 205021, "M": 1139,
                   "dijkstra_f32w": (610.7424560934305, 1050.9944240003824),
                   "dijkstra": (610.7424599684256, 1050.9944170319238),
                   "float64": (16, 610.7424599684254, 1050.9944170319254,
                               147),
                   "float32": (4, 610.7423095703125, 1050.994384765625,
                               134)}
FAITHFUL_F64_ATOL = 1e-5
# main_annulus --model iasp91 --wave Vs --dtype float64 --nr 63 (the
# deduplicated 180x63 mesh): scipy Dijkstra's t(60) and t(150) on float64
# and on the JAX package's default float32 weights
CLI_IASP91_VS = {"dijkstra": (1108.1257431839629, 1943.3726225701846),
                 "dijkstra_f32w": (1108.1257466971874, 1943.3726243674755)}


def _mesh_digests(gr, A, halo) -> dict:
    """The counts and digests of benchmarks/faithful_digests.json."""
    import hashlib

    import numpy as np

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    return {"nodes": gr.nnods, "edges": A.nnz, "halo_rows": len(halo),
            "r_sorted_sha256_16": digest(np.sort(np.round(gr.r, 6))),
            "degree_hist_sha256_16": digest(np.bincount(np.diff(A.indptr)))}


def _faithful_180x50() -> str:
    """The frozen cross-check of the faithful mesh: its counts and
    digests exactly, and the float64 auto field's 150 receiver times on
    the card within FAITHFUL_TT_ATOL of the digests' Dijkstra times."""
    import numpy as np

    import raytracer_tpu_torch as rt

    t0 = time.perf_counter()
    gr, A, halo = rt.init_annulus(180, 50, spacing=50.0, faithful=True)
    t_build = time.perf_counter() - t0
    dig = _mesh_digests(gr, A, halo)
    assert dig == FAITHFUL_180x50, dig
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    _, receivers = _fan(gr)
    solver = rt.AnnulusSolver(gr, A, halo, _ak135_vp(gr),
                              rt.SolverConfig(dtype="float64"),
                              method="auto")
    d = solver.solve(source, want_prev=False).dist
    assert solver.method == "sweep", solver.method
    err = float(np.abs(d[receivers] - np.asarray(FAITHFUL_180x50_TT)).max())
    assert err <= FAITHFUL_TT_ATOL, err
    return (f"faithful 180x50 spacing 50: {dig['nodes']} nodes, "
            f"{dig['edges']} directed edges, {dig['halo_rows']} halo rows, "
            f"digests {dig['r_sorted_sha256_16']} / "
            f"{dig['degree_hist_sha256_16']} (the frozen ones; built in "
            f"{t_build:.2f} s), float64 auto -> {solver.method} in "
            f"{solver.last_iterations} rounds, the 150 receiver times within "
            f"{err:.3g} s of the digests' Dijkstra times")


def _faithful_cli(tmp: str) -> tuple:
    """main_annulus --model iasp91 --wave Vs --dtype float64 --nr 63
    --cache-dir: cold (builds and writes the cache), then warm (reads it,
    with --plot where matplotlib imports).  Returns (line, rsweep
    launches of both runs)."""
    import importlib.util

    import numpy as np

    from raytracer_tpu_torch import main_annulus

    cache = os.path.join(tmp, "cache25")
    args = ["--ntheta", "180", "--nr", "63", "--dtype", "float64", "--model",
            "iasp91", "--wave", "Vs", "--cache-dir", cache]
    _reset_counts()
    cold = main_annulus.main([*args, "--out-prefix",
                              os.path.join(tmp, "iv_cold")])
    launches = _counts()["rsweep"]
    files = sorted(os.listdir(cache))
    assert len(files) == 2 and files[0].startswith("annulus_v1_180x63") \
        and files[1].startswith("circ_v1_180x"), files
    stamps = {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in files}
    warm_args = [*args, "--out-prefix", os.path.join(tmp, "iv_warm")]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if not has_mpl:
        try:
            main_annulus.main([*warm_args, "--plot"])
        except ImportError as e:
            assert "matplotlib" in str(e), e
        else:
            raise AssertionError("--plot ran without matplotlib")
    _reset_counts()
    warm = main_annulus.main(warm_args + ["--plot"] * has_mpl)
    launches += _counts()["rsweep"]
    assert {f: os.stat(os.path.join(cache, f)).st_mtime_ns
            for f in os.listdir(cache)} == stamps, "the warm run rewrote"
    if has_mpl:
        size = os.path.getsize(os.path.join(tmp, "iv_warm_ray_paths.png"))
        assert size > 0
        plot = f"matplotlib imports: --plot wrote {size} bytes of PNG"
    else:
        plot = "matplotlib absent: --plot refused by name"

    def build_s(timer):
        return timer.totals["init_annulus"] + timer.totals["solver pack"]

    assert build_s(warm) < build_s(cold), (build_s(warm), build_s(cold))
    tab = {}
    for name in ("cold", "warm"):
        tab[name] = np.loadtxt(os.path.join(tmp, f"iv_{name}_travel_times.csv"),
                               delimiter=",", skiprows=1)
    assert np.array_equal(tab["cold"], tab["warm"])
    tt = tab["warm"]
    t60 = float(tt[np.argmin(np.abs(tt[:, 0] - 60.0)), 1])
    t150 = float(tt[np.argmin(np.abs(tt[:, 0] - 150.0)), 1])
    for pair in CLI_IASP91_VS.values():
        assert abs(t60 - pair[0]) <= FAITHFUL_F64_ATOL and \
            abs(t150 - pair[1]) <= FAITHFUL_F64_ATOL, (t60, t150, pair)
    assert launches > 0
    return (f"main_annulus --model iasp91 --wave Vs --dtype float64 --nr 63 "
            f"--cache-dir: t(60)={t60!r} s, t(150)={t150!r} s (Dijkstra "
            f"{t60 - CLI_IASP91_VS['dijkstra'][0]:+.3g} / "
            f"{t150 - CLI_IASP91_VS['dijkstra'][1]:+.3g} s, on float32 "
            f"weights {t60 - CLI_IASP91_VS['dijkstra_f32w'][0]:+.3g} / "
            f"{t150 - CLI_IASP91_VS['dijkstra_f32w'][1]:+.3g} s), rsweep "
            f"launches {launches}; grid + stencil build cold "
            f"{build_s(cold):.2f} s (init_annulus "
            f"{cold.totals['init_annulus']:.2f}, solver pack "
            f"{cold.totals['solver pack']:.2f}), warm from the cache "
            f"{build_s(warm):.2f} s, the cache files untouched; steady solve "
            f"cold/warm {1e3 * cold.totals['solve (steady)']:.1f}/"
            f"{1e3 * warm.totals['solve (steady)']:.1f} ms; {plot}"), launches


def phase_faithful(rec: dict, tmp: str):
    """Phase 25: the reference-faithful mesh through the main path, the
    CLI's --model/--wave/--cache-dir/--plot, the trace and
    iteration_stats."""
    import json

    import numpy as np
    import torch

    import raytracer_tpu_torch as rt
    from raytracer_tpu_torch import native
    from raytracer_tpu_torch.ops.sweep_theta import (_kernel_tables,
                                                     device_tables, rsweep)
    from raytracer_tpu_torch.utils.profiling import iteration_stats, trace

    line50 = _faithful_180x50()

    # the faithful 180x63 mesh, its adjacency on the native builder
    calls = native.node_adjacency_native_flat.calls
    t0 = time.perf_counter()
    gr, A, halo = rt.init_annulus(180, 63, spacing=20.0, faithful=True)
    t_build = time.perf_counter() - t0
    assert native.available() and \
        native.node_adjacency_native_flat.calls == calls + 1, \
        "the host did not take the native adjacency builder"
    assert gr.nnods == FAITHFUL_180x63["nodes"], gr.nnods
    U = _ak135_vp(gr)
    source = rt.closest_point(gr, 0.0, rt.R, system="polar")
    degs, receivers = _fan(gr)

    # float32 auto: the main path's kernel at M = 1,139
    t0 = time.perf_counter()
    solver = rt.AnnulusSolver(gr, A, halo, U, method="auto")
    t_pack = time.perf_counter() - t0
    M = solver.circulant.cmap.M
    assert solver.method == "sweep" and M == FAITHFUL_180x63["M"], \
        (solver.method, M)
    _reset_counts()
    t0 = time.perf_counter()
    D = solver.solve(source)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = _counts()
    rounds = solver.last_iterations
    assert counts["rsweep"] == 2 * rounds, (counts, rounds)
    paths = [rt.recontruct_path(D.prev, source, r) for r in receivers]
    tt = rt.travel_times(D, gr, receivers, isave=True,
                         flname=os.path.join(tmp, "faithful_tt.csv"))
    t60 = float(tt[np.argmin(np.abs(degs - 60.0))])
    t150 = float(tt[np.argmin(np.abs(degs - 150.0))])
    assert np.isfinite(D.dist).all() and D.dist.shape == (gr.nnods,)
    assert abs(t60 - T60_REF) <= CPU_ATOL and abs(t150 - T150_REF) \
        <= CPU_ATOL, (t60, t150)
    for r, p in zip(receivers, paths):
        assert p[0] == r and p[-1] == source, (r, p[:3])
    reach32 = len(_reaching(D.prev, source, receivers))
    jax32 = FAITHFUL_180x63["float32"]
    assert reach32 == jax32[3], (reach32, jax32)
    steady_ms = _steady_ms(solver, source, 5)
    split = _kernel_split_ms(lambda: solver.solve(source, want_prev=False),
                             2)
    busy = sum(split.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prev = solver.recover_prev(D.dist)
    torch.cuda.synchronize()
    t_prev = time.perf_counter() - t0

    # rsweep on the faithful tables: the route, bit-equal, its time
    _, static, wdn, wup, rst = device_tables(
        solver._sweep_stencil, solver.circulant, np.float32, "cuda")
    routes = ["shared" if _kernel_tables(w, rst, up)[0].shared else "global"
              for w, up in ((wdn, False), (wup, True))]
    rng = np.random.default_rng(25)
    err = _rsweep_check(rng, [(rst, 1, False), (rst, 1, True)], static.nt,
                        wdn, wup)
    ms, bound = [], []
    for w, up in ((wdn, False), (wup, True)):
        buf = _rsweep_buffer(rng, rst, static.nt, 1, up)
        ms.append(_cuda_ms(lambda: rsweep(buf, w, rst, up), 10))
        nbytes, ops, _ = _rsweep_work(w, rst, static.nt, 1, up)
        bound.append(_bound_ms(nbytes, ops)[0])

    # the trace of one main-path solve names the rsweep kernel
    with trace(os.path.join(tmp, "trace25")) as prof:
        solver.solve(source, want_prev=False)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels_seen = sorted({e["name"] for e in events
                           if e.get("cat") == "kernel"})
    assert any("rsweep" in k for k in kernels_seen), kernels_seen[:10]

    # float64 auto: the Dijkstra times; the JAX package's rounds and walks
    s64 = rt.AnnulusSolver(gr, A, halo, U, rt.SolverConfig(dtype="float64"),
                           method="auto")
    _reset_counts()
    t0 = time.perf_counter()
    D64 = s64.solve(source)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    launches64 = _counts()["rsweep"]
    assert s64.method == "sweep" and D64.dist.dtype == np.float64
    tt64 = {deg: float(D64.dist[r]) for deg, r in zip(degs, receivers)
            if deg in (60.0, 150.0)}
    jax64 = FAITHFUL_180x63["float64"]
    for pair in (FAITHFUL_180x63["dijkstra_f32w"],
                 FAITHFUL_180x63["dijkstra"], jax64[1:3]):
        assert abs(tt64[60.0] - pair[0]) <= FAITHFUL_F64_ATOL and \
            abs(tt64[150.0] - pair[1]) <= FAITHFUL_F64_ATOL, (tt64, pair)
    assert s64.last_iterations == jax64[0], (s64.last_iterations, jax64)
    reach64 = len(_reaching(D64.prev, source, receivers))
    assert reach64 == jax64[3], (reach64, jax64)

    # twrapped on the same mesh (the titer kernel)
    tw = rt.AnnulusSolver(gr, A, halo, U, method="twrapped")
    _reset_counts()
    Dt = tw.solve(source, want_prev=False)
    torch.cuda.synchronize()
    titer = _counts()["titer"]
    assert tw.method == "twrapped" and titer > 0, (tw.method, titer)
    err_tw = float(np.abs(Dt.dist - D.dist).max())
    assert err_tw <= ENGINE_ATOL, err_tw

    cli, cli_launches = _faithful_cli(tmp)

    # iteration_stats on the card equal to the CPU route's, as many as
    # the circulant solve's iterations
    g48, cg48, U48 = rt.init_annulus_circulant(48, 12, 150.0)
    s48 = rt.closest_point(g48, 0.0, rt.R, system="polar")
    stats = iteration_stats(cg48, s48)
    assert stats == iteration_stats(cg48, s48, device="cpu")
    circ = rt.AnnulusSolver(g48, None, None, U48, method="circulant",
                            circulant=cg48)
    circ.solve(s48, want_prev=False)
    assert len(stats) == circ.last_iterations, (len(stats),
                                                circ.last_iterations)

    rec["rsweep"]["launches"] += counts["rsweep"] + launches64 + cli_launches
    rec["titer"]["launches"] += titer
    rec["faithful_ms"] = steady_ms
    print(f"phase 25 faithful mesh: {line50}; faithful 180x63 spacing 20: "
          f"{gr.nnods} nodes, {A.nnz} directed edges, {len(halo)} halo rows "
          f"(host build {t_build:.2f} s on the native adjacency builder, "
          f"circulant layout + pack {t_pack:.2f} s), M = {M} slots a "
          f"column; float32 auto -> {solver.method} on {solver.device}: "
          f"{rounds} rounds, rsweep launches {counts['rsweep']}, "
          f"t(60)={t60:.4f} s, t(150)={t150:.4f} s, {reach32} of 150 walks "
          f"reach the source (the JAX package's {jax32[3]}); first "
          f"solve+prev {t_first:.3f} s, steady solve median of 5 "
          f"{steady_ms:.2f} ms, device {busy:.3f} ms of it (idle "
          f"{100 * (1 - busy / steady_ms):.1f} %), prev recovery "
          f"{1e3 * t_prev:.2f} ms; rsweep at these tables (MT={rst.MT}, "
          f"NTL={rst.NTL}) routes down/up {routes[0]}/{routes[1]}, bit-equal "
          f"to its plain version (max err {err}), {ms[0]:.4f}/{ms[1]:.4f} "
          f"ms a launch (bound {bound[0]:.5f}/{bound[1]:.5f} ms); the trace "
          f"names {[k for k in kernels_seen if 'rsweep' in k][0]!r} "
          f"({len(kernels_seen)} kernels); float64 auto -> {s64.method} in "
          f"{s64.last_iterations} rounds (the JAX package's {jax64[0]}), "
          f"{t64:.3f} s with prev, t(60)={tt64[60.0]!r} s, "
          f"t(150)={tt64[150.0]!r} s: Dijkstra "
          f"{tt64[60.0] - FAITHFUL_180x63['dijkstra'][0]:+.3g} / "
          f"{tt64[150.0] - FAITHFUL_180x63['dijkstra'][1]:+.3g} s (on float32 "
          f"weights {tt64[60.0] - FAITHFUL_180x63['dijkstra_f32w'][0]:+.3g} / "
          f"{tt64[150.0] - FAITHFUL_180x63['dijkstra_f32w'][1]:+.3g} s), the "
          f"deduplicated mesh's JAX_F64_180 {tt64[60.0] - JAX_F64_180[1]:+.3g}"
          f" / {tt64[150.0] - JAX_F64_180[2]:+.3g} s, {reach64} walks reach "
          f"the source (the JAX package's {jax64[3]}); twrapped: "
          f"{tw.last_iterations} iterations, titer launches {titer}, max "
          f"|twrapped - sweep| {err_tw:.3g} s; {cli}; iteration_stats at "
          f"48x12 on the card equal to the CPU route's, {len(stats)} "
          f"iterations (the circulant solve's)", flush=True)


def main():
    faulthandler.dump_traceback_later(900, exit=True)
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    phase_environment()
    import torch

    rec: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for phase in (phase_build, lambda: phase_kernels(rec),
                      lambda: phase_jacobi_kernels(rec),
                      lambda: phase_wrapped_diag_kernels(rec),
                      lambda: phase_sweep3d_kernel(rec),
                      lambda: phase_plane3d_kernel(rec),
                      lambda: phase_lane_gather_kernels(rec),
                      lambda: phase_graph_kernels(rec),
                      lambda: phase_staged_kernels(rec),
                      lambda: phase_banded_kernels(rec),
                      lambda: phase_paths_kernels(rec),
                      lambda: phase_gridsearch_kernel(rec),
                      lambda: phase_tsweep_kernel(rec),
                      lambda: phase_main_path(rec, tmp),
                      lambda: phase_cli(tmp), lambda: phase_twrapped(rec),
                      lambda: phase_stream(rec), lambda: phase_tables(rec),
                      lambda: phase_wrapped(rec, tmp),
                      lambda: phase_diag(rec),
                      lambda: phase_grid3d(rec), phase_example3d,
                      lambda: phase_contrib(rec),
                      lambda: phase_sweep3d_engine(rec),
                      lambda: phase_graph_bfm(rec),
                      lambda: phase_graph_banded(rec),
                      lambda: phase_graph_cli(tmp),
                      lambda: phase_staged(rec),
                      lambda: phase_staged_cli(tmp),
                      lambda: phase_paths(rec, tmp),
                      lambda: phase_locate(rec, tmp),
                      lambda: phase_xla_engine(rec),
                      lambda: phase_sharded_one_rank(rec, tmp),
                      lambda: phase_sharded_two_ranks(rec, tmp),
                      lambda: phase_faithful(rec, tmp)):
            t0 = time.perf_counter()
            phase()
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    sources = {
        "rsweep": ("raytracer_tpu_torch/csrc/rsweep.cu",
                   "raytracer_tpu/ops/sweep_theta.py:551",
                   "auto 180x63 -> sweep; faithful 180x63 auto; "
                   "main_annulus --model iasp91 --wave Vs"),
        "titer": ("raytracer_tpu_torch/csrc/titer.cu",
                  "raytracer_tpu/ops/wrapped_t.py:254",
                  "twrapped 180x63; twrapped on the faithful 180x63"),
        "band": ("raytracer_tpu_torch/csrc/band.cu",
                 "raytracer_tpu/ops/stream_t.py:253",
                 "stream 1080x300"),
        "witer": ("raytracer_tpu_torch/csrc/witer.cu",
                  "raytracer_tpu/ops/diag_wrapped.py:272",
                  "auto 183x63 -> wrapped"),
        "diag": ("raytracer_tpu_torch/csrc/diag.cu",
                 "raytracer_tpu/ops/diag_circulant.py:230",
                 "auto 127x63 -> diag"),
        "ring_scan": ("raytracer_tpu_torch/csrc/diag_scans.cuh",
                      "raytracer_tpu/ops/diag_circulant.py:284",
                      "auto 127x63 -> diag"),
        "chain_scan": ("raytracer_tpu_torch/csrc/diag_scans.cuh",
                       "raytracer_tpu/ops/diag_circulant.py:316",
                       "auto 127x63 -> diag"),
        "sweep3d": ("raytracer_tpu_torch/csrc/sweep3d.cu",
                    "raytracer_tpu/ops/sweep3d.py:90",
                    "solve3d auto 128x128x64 -> pallas"),
        "relax": ("raytracer_tpu_torch/csrc/relax.cu",
                  "raytracer_tpu/contrib/pallas_circulant.py:171",
                  "pallas 180x63"),
        "fused": ("raytracer_tpu_torch/csrc/fused.cu",
                  "raytracer_tpu/contrib/fused_circulant.py:67",
                  "fused 180x63"),
        # the port's own kernel: the JAX package runs this pass as XLA
        "plane3d": ("raytracer_tpu_torch/csrc/plane3d.cu",
                    "raytracer_tpu/solvers/solve3d.py:158",
                    "solve3d sweep 128x128x64"),
        # the generic graphs' own kernels: the JAX package runs these
        # steps as XLA
        "bfm_step": ("raytracer_tpu_torch/csrc/ell_bfm.cu",
                     "raytracer_tpu/ops/relax.py:75",
                     "bfm 180x63"),
        "banded_sweep": ("raytracer_tpu_torch/csrc/banded.cu",
                         "raytracer_tpu/ops/banded.py:197",
                         "auto Delaunay -> banded"),
        "banded_gs": ("raytracer_tpu_torch/csrc/banded.cu",
                      "raytracer_tpu/ops/banded.py:262",
                      "solve_banded_gs Delaunay"),
        # the paths slice's own kernels: the JAX package runs the walk
        # (backtrace_paths' lax.scan, path.py:82, with _coo_jit's pair
        # terms) and the Adam bend as XLA
        "paths": ("raytracer_tpu_torch/csrc/paths.cu",
                  "raytracer_tpu/solvers/sensitivity.py:134",
                  "AnnulusSolver.sensitivity_matrix 180x63"),
        "bend": ("raytracer_tpu_torch/csrc/bend.cu",
                 "raytracer_tpu/solvers/refine.py:104",
                 "main_annulus --refine 180x63"),
        # the location slice's own kernel: the JAX package runs the
        # catalogue search as XLA
        "gridsearch": ("raytracer_tpu_torch/csrc/gridsearch.cu",
                       "raytracer_tpu/solvers/locate.py:66",
                       "locate_many 180x63, 64 events"),
        # the multi-device slice's own kernel: the JAX package runs the
        # theta-column sweep of its xla engine as XLA (a lax.scan)
        "tsweep": ("raytracer_tpu_torch/csrc/tsweep.cu",
                   "raytracer_tpu/ops/sweep_theta.py:304",
                   "solve_circulant_sweep xla theta 180x63"),
    }
    kernels_line = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "path": path,
        "launches": rec[name]["launches"],
        "bit_equal": rec[name]["max_abs_err"] == 0.0,
        "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"],
        "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"],
        "bound_by": rec[name]["bound_by"],
        "library_ms": None,
    } for name, (src, replaces, path) in sources.items()]}
    for k in kernels_line["kernels"]:
        assert k["launches"] > 0, k
    faulthandler.cancel_dump_traceback_later()
    print(f"total wall {time.perf_counter() - t_start:.1f} s "
          f"(twrapped steady solve {rec['twrapped_ms']:.2f} ms, stream "
          f"steady solve {rec['stream_ms']:.1f} ms, wrapped 183x63 "
          f"{rec['wrapped_ms']:.2f} ms = {rec['wrapped_launches']} x "
          f"{rec['witer']['ms']:.4f} ms of witer + the rest, diag 127x63 "
          f"{rec['diag_ms']:.2f} ms = {rec['diag_launches']} x "
          f"({rec['diag']['ms']:.4f} ms of diag + "
          f"{rec['ring_scan']['ms']:.4f} of ring_scan + "
          f"{rec['chain_scan']['ms']:.4f} of chain_scan) + the rest, 3-D "
          f"128x128x64 {rec['grid3d_ms']:.2f} ms = {rec['grid3d_launches']} "
          f"x {rec['sweep3d']['ms']:.4f} ms of sweep3d + the rest, pallas "
          f"180x63 {rec['pallas_ms']:.1f} ms = {rec['relax']['launches']} x "
          f"{rec['relax']['ms']:.4f} ms of relax + the rest, fused 180x63 "
          f"{rec['fused_ms']:.2f} ms = 1 launch of {rec['fused_iters']} "
          f"iterations, 3-D sweep engine 128x128x64 "
          f"{rec['sweep3d_engine_ms']:.2f} ms = "
          f"{rec['sweep3d_engine_launches']} x {rec['plane3d']['ms']:.4f} ms "
          f"of plane3d + the rest, bfm 180x63 {rec['bfm_ms']:.2f} ms = "
          f"{rec['bfm_step']['launches']} x {rec['bfm_step']['ms']:.4f} ms "
          f"of bfm_step, banded Delaunay {rec['banded_ms']:.2f} ms = "
          f"{rec['banded_sweep']['launches']} x "
          f"{rec['banded_sweep']['ms']:.4f} ms of banded_sweep + the rest)",
          flush=True)
    print(json.dumps(kernels_line))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
