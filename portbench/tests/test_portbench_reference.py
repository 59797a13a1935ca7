"""The plain reference: exact on a graph checked by hand, equal to a
brute-force Dijkstra on tiny grids, and its frozen mesh equal to the
upstream construction the program also builds."""
import heapq
import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import annulus, check, sssp

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name, **over):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def csr(n, edges):
    """CSR of in-edges (row = destination) from (src, dst, w)."""
    edges = sorted(edges, key=lambda e: (e[1], e[0]))
    indptr = np.zeros(n + 1, np.int64)
    for _, d, _ in edges:
        indptr[d + 1] += 1
    return (np.cumsum(indptr), np.array([s for s, _, _ in edges]),
            np.array([w for _, _, w in edges], np.float64))


def dijkstra(n, edges, src):
    adj = [[] for _ in range(n)]
    for s, d, w in edges:
        adj[s].append((d, w))
    dist = [np.inf] * n
    dist[src] = 0.0
    heap = [(0.0, src)]
    while heap:
        t, u = heapq.heappop(heap)
        if t > dist[u]:
            continue
        for v, w in adj[u]:
            if t + w < dist[v]:
                dist[v] = t + w
                heapq.heappush(heap, (t + w, v))
    return np.array(dist)


def test_hand_checked_graph():
    # 0 -> 1 (1), 1 -> 2 (2), 0 -> 2 (5), 2 -> 3 (1), 3 -> 0 (0.5), and
    # 4 reached only through a zero-cost twin link from 3
    edges = [(0, 1, 1.0), (1, 2, 2.0), (0, 2, 5.0), (2, 3, 1.0),
             (3, 0, 0.5), (3, 4, 0.0)]
    g = sssp.ell_graph(*csr(5, edges), torch.float64, "cpu")
    d, passes = sssp.ell_solve(g, [0, 2])
    assert d[0].tolist() == [0.0, 1.0, 3.0, 4.0, 4.0]
    assert d[1].tolist() == [1.5, 2.5, 0.0, 1.0, 1.0]
    assert passes <= 5


def test_bfloat16_rounds_far_off():
    edges = [(i, i + 1, 3.3) for i in range(400)]
    g64 = sssp.ell_graph(*csr(401, edges), torch.float64, "cpu")
    g16 = sssp.ell_graph(*csr(401, edges), torch.bfloat16, "cpu")
    d64, _ = sssp.ell_solve(g64, [0])
    d16, _ = sssp.ell_solve(g16, [0])
    assert (d16.double() - d64).abs().max() > 10.0


def test_annulus_against_brute_force():
    ref = annulus.Reference(config("ak135_annulus_180x63", ntheta=16, nr=4,
                                   spacing_km=400.0), "cpu")
    n = ref.n
    dst, src = ref._key // n, ref._key % n
    edges = list(zip(src.tolist(), dst.tolist(), ref._w.tolist()))
    assert ref.problem_size() == (n, len(edges))
    sources = [0, n // 2, n - 1]
    d, _ = ref.solve(sources)
    for q, s in enumerate(sources):
        assert np.allclose(d[q].numpy(), dijkstra(n, edges, s), rtol=0,
                           atol=1e-9)


@pytest.mark.parametrize("nt,nr,sp", [(16, 4, 400.0), (36, 12, 150.0)])
def test_frozen_mesh_is_the_upstream_construction(nt, nr, sp):
    from raytracer_tpu_torch.models.annulus import init_annulus

    ref = annulus.Reference(config("ak135_annulus_180x63", ntheta=nt, nr=nr,
                                   spacing_km=sp), "cpu")
    gr, A, halo = init_annulus(nt, nr, spacing=sp)
    m = ref.mesh
    assert np.array_equal(m.x, gr.x) and np.array_equal(m.z, gr.z)
    assert np.array_equal(m.twin_class, gr.twin_class)
    assert np.array_equal(m.A.indptr, A.indptr)
    assert np.array_equal(m.A.indices, A.indices)
    assert np.array_equal(m.halo, halo)


def test_program_nodes_match_one_to_one():
    from raytracer_tpu_torch.models.fast_annulus import init_annulus_circulant

    cfg = config("ak135_annulus_180x63", ntheta=16, nr=4, spacing_km=400.0)
    ref = annulus.Reference(cfg, "cpu")
    gr, _, _ = init_annulus_circulant(16, 4, spacing=400.0)
    m, worst = check.node_map(ref, np.stack([gr.x, gr.z], 1), gr.twin_class)
    assert worst < 1e-6
    assert sorted(m.tolist()) == list(range(ref.n))
    # a node moved off its place does not match
    x = gr.x.copy()
    x[5] += 0.01
    _, worst = check.node_map(ref, np.stack([x, gr.z], 1), gr.twin_class)
    assert not np.isfinite(worst)
