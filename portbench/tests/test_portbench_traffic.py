"""The generator: the same seed gives the same requests, another seed
others; the window's first block is drawn before the window opens;
depths stay in the mix's range, one in each slice of a block."""
import json
import os

import numpy as np
import pytest

from portbench import traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


class Recording:
    """A stand-in for the program's adapter: it keeps the positions it is
    asked for and numbers them."""

    def __init__(self):
        self.asked = []

    def event_nodes(self, depth_km, theta_deg):
        self.asked.append((np.asarray(depth_km), np.asarray(theta_deg)))
        return np.arange(len(depth_km)) + 1000 * len(self.asked)

    def surface_nodes(self):
        return np.arange(5000)


CFG = "ak135_annulus_180x63"
# one event a request, stratified over blocks of 16 requests
SINGLE = {"events_per_request": 1, "event_depth_km": [0.0, 700.0],
          "stratify": 16, "stations": {"kind": "surface", "count": 3}}
MIXES = {"annulus_table": lambda: load("traffic", "annulus_table"),
         "single": lambda: dict(SINGLE)}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_same_seed_same_requests(mix):
    m, c = MIXES[mix](), load("configs", CFG)
    seed = 2**31 + 987654321

    def draw(seed):
        sysm = Recording()
        tr = traffic.Traffic(m, c, sysm, seed)
        gen = tr.window()
        reqs = [next(gen) for _ in range(2 * traffic.BLOCK + 1)]
        return sysm.asked, tr.stations, reqs

    a, b, other = draw(seed), draw(seed), draw(seed + 1)
    assert len(a[0]) == 3
    for (da, ta), (db, tb) in zip(a[0], b[0]):
        assert np.array_equal(da, db) and np.array_equal(ta, tb)
    assert not np.array_equal(a[0][0][0], other[0][0][0])
    assert np.array_equal(a[1], b[1])
    assert not np.array_equal(a[1], other[1])
    for ra, rb in zip(a[2], b[2]):
        assert np.array_equal(ra.sources, rb.sources)
        assert np.array_equal(ra.receivers, rb.receivers)


def test_the_first_block_is_drawn_before_the_window_opens():
    sysm = Recording()
    tr = traffic.Traffic(load("traffic", "annulus_table"),
                         load("configs", CFG), sysm, 5)
    gen = tr.window()
    assert len(sysm.asked) == 1
    E = load("traffic", "annulus_table")["events_per_request"]
    assert len(sysm.asked[0][0]) == traffic.BLOCK * E
    for _ in range(traffic.BLOCK):
        next(gen)
    assert len(sysm.asked) == 1
    next(gen)
    assert len(sysm.asked) == 2


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_depths_and_angles_in_range_and_stratified(mix):
    m, c = MIXES[mix](), load("configs", CFG)
    sysm = Recording()
    tr = traffic.Traffic(m, c, sysm, 12345)
    B = m["stratify"]
    n = 4 * B
    tr.events(np.random.default_rng(3), n)
    depth, theta = sysm.asked[-1]
    lo, hi = m["event_depth_km"]
    assert depth.min() >= lo and depth.max() <= hi
    assert (lo, hi) == (0.0, 700.0)
    slices = np.floor((depth - lo) / (hi - lo) * B).astype(int)
    for blk in slices.reshape(-1, B):
        assert sorted(blk) == list(range(B))
    t0, t1 = c["event_region"]["theta_deg"]
    assert theta.min() >= t0 and theta.max() <= t1


def test_surface_stations_are_distinct_surface_nodes():
    m = load("traffic", "annulus_table")
    tr = traffic.Traffic(m, load("configs", CFG), Recording(), 77)
    assert len(np.unique(tr.stations)) == m["stations"]["count"]
    assert tr.stations.max() < 5000


def test_real_adapter_maps_events_to_nearest_nodes(one_thread):
    from portbench.systems.annulus import System

    cfg = load("configs", CFG)
    cfg.update(ntheta=16, nr=4, spacing_km=400.0)
    s = System(cfg, load("traffic", "annulus_table"), "cpu", None)
    depth = np.array([0.0, 700.0, 0.0])
    theta = np.array([0.0, 90.0, 200.0])
    ids = s.event_nodes(theta_deg=theta, depth_km=depth)
    th = np.deg2rad(theta)
    want = np.stack([(6371.0 - depth) * np.sin(th),
                     (6371.0 - depth) * np.cos(th)], 1)
    xz = np.stack([s.x, s.z], 1)
    d = np.linalg.norm(xz[ids] - want, axis=1)
    dall = np.linalg.norm(xz[None, :, :] - want[:, None, :], axis=2)
    assert np.allclose(d, dall.min(axis=1))
    r = np.hypot(s.x[ids], s.z[ids])
    assert abs(r[0] - 6371.0) < 1e-6 and abs(r[2] - 6371.0) < 1e-6
    assert set(s.surface_nodes().tolist()) >= {int(ids[0]), int(ids[2])}
