"""Ray-path reconstruction by predecessor backtrace (host NumPy)."""
from __future__ import annotations

import numpy as np


def recontruct_path(prev, source: int, receiver: int) -> np.ndarray:
    """Walk prev from receiver until the source; returns node ids.

    The name keeps the reference API's spelling.  Guards against cycles
    from unreachable receivers: an unreachable receiver (its predecessor
    is itself) yields the length-1 path [receiver].
    """
    prev = np.asarray(prev)
    if int(prev[receiver]) == int(receiver) and int(receiver) != int(source):
        return np.asarray([int(receiver)], dtype=np.int64)
    path = [int(receiver)]
    ipath = int(prev[receiver])
    while ipath != source and ipath != path[-1] and len(path) <= len(prev):
        path.append(ipath)
        ipath = int(prev[ipath])
    path.append(int(source))
    return np.asarray(path, dtype=np.int64)
