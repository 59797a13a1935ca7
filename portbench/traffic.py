"""The one generator of requests, driven by a traffic mix's data file
(`traffic/<mix>.json`) and the configuration's event region.

A mix names (a request is an events x stations table of first
arrivals):
- `events_per_request`, and `event_depth_km` [lo, hi]: event depths are
  drawn stratified over blocks of `stratify` events (one in each equal
  slice of the range, in a random order), so that every seed offers the
  same spread of depths; event angles are uniform over the
  configuration's `event_region`; an event is the node nearest its
  position;
- `stations`: {"kind": "surface", "count": n}: n distinct surface nodes
  drawn once for the run.

The window's requests are drawn in blocks of `BLOCK`; the first block is
drawn when `window()` is called, so a run calls it in its set-up.

Each seed gives its own independent streams for the stations, the
window's requests, the warm-up and the sample that is checked.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple

import numpy as np

STATIONS, EVENTS, WARMUP, CHECK = 1, 2, 3, 4
BLOCK = 16


class Request(NamedTuple):
    sources: np.ndarray
    receivers: np.ndarray


def stream(seed: int, which: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), which])


class Traffic:
    def __init__(self, mix: dict, cfg: dict, system, seed: int):
        self.mix, self.cfg, self.system = mix, cfg, system
        self.seed = int(seed)
        spec = mix["stations"]
        if spec["kind"] == "surface":
            surf = system.surface_nodes()
            self.stations = np.sort(stream(seed, STATIONS).choice(
                surf, size=spec["count"], replace=False))
        else:
            raise ValueError(f"unknown stations kind {spec['kind']!r}")

    def events(self, rng: np.random.Generator, count: int) -> np.ndarray:
        """`count` event nodes, depths stratified in blocks."""
        lo, hi = self.mix["event_depth_km"]
        B = int(self.mix.get("stratify", 1))
        nb = -(-count // B)
        slot = np.concatenate([rng.permutation(B) for _ in range(nb)])
        depth = lo + (hi - lo) * (slot[:count] + rng.random(count)) / B
        reg = self.cfg["event_region"]
        ang = {k: rng.uniform(*reg[k], size=count)
               for k in ("theta_deg", "phi_deg") if k in reg}
        return self.system.event_nodes(depth_km=depth, **ang)

    def requests(self, rng: np.random.Generator, count: int) -> List[Request]:
        E = int(self.mix["events_per_request"])
        ev = self.events(rng, count * E).reshape(count, E)
        return [Request(srcs, self.stations) for srcs in ev]

    def window(self) -> Iterator[Request]:
        """The window's requests without end, in blocks of `BLOCK`; the
        first block is drawn before this returns."""
        rng = stream(self.seed, EVENTS)
        first = self.requests(rng, BLOCK)

        def more():
            yield from first
            while True:
                yield from self.requests(rng, BLOCK)

        return more()
