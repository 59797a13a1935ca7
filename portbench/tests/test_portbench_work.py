"""The least-work formula on graphs counted by hand."""
import pytest

from portbench import work


def test_least_work_by_hand():
    # 10 nodes, 20 directed edges, 2 sources, 10 answers each:
    # bytes (10 velocities + 20 outputs) x 4, operations 2 x 20 x 2
    w = work.least_work(10, 20, 2, 20, "float32")
    assert w.bytes == 120.0 and w.flops == 80.0
    assert w.seconds == pytest.approx(max(120 / 3.35e12, 80 / 67e12))
    assert w.bound_by == "bytes"
    w64 = work.least_work(10, 2_000_000, 1, 10, "float64")
    assert w64.flops == 4e6 and w64.bytes == 160.0
    assert w64.seconds == pytest.approx(4e6 / 34e12)
    assert w64.bound_by == "operations"


def test_annulus_edges_are_the_graph_and_its_twin_links():
    # the reference counts every directed edge of the upstream graph once
    # and each halo twin link once; on a 16 x 4 annulus, by the mesher's
    # own counts
    from portbench.reference import annulus

    cfg = {"ntheta": 16, "nr": 4, "spacing_km": 400.0, "R_km": 6371.0,
           "r_inner_km": 0.1, "twin_offset_km": 0.05,
           "discontinuity_depths_km": [20.0, 35.0, 210.0, 410.0, 660.0,
                                       2740.0, 2891.5],
           "velocity": {"model": "ak135", "wave": "Vp",
                        "discontinuity_buffer_km": 1.0}}
    ref = annulus.Reference(cfg, "cpu")
    n, e = ref.problem_size()
    assert n == len(ref.mesh.x)
    assert e == ref.mesh.A.nnz + len(ref.mesh.halo)
    assert len(ref.mesh.halo) > 0
