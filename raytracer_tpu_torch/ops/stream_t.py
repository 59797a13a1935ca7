"""Chain-scan span helper shared with the streamed path (host)."""
from __future__ import annotations


def _pow_spans(cover: int):
    """Power-of-two spans (1, 2, 4, ...) whose doubling scan covers every
    offset in [0, cover): after applying span s to a field covering runs
    of length < s, coverage extends to < 2s."""
    spans, s, total = [], 1, 1
    while total < cover:
        spans.append(s)
        total += s
        s *= 2
    return tuple(spans) if spans else (1,)
