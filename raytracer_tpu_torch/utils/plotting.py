"""Ray-path plotting, a copy of `raytracer_tpu/utils/plotting.py`
(matplotlib in place of the reference's GLMakie figure,
src/plots/plots.jl:1-46): Earth disc, core circles, velocity-layer
circles, red ray paths, source/receiver markers.  matplotlib is imported
inside `plot_paths`, so the package imports without it;
`require_matplotlib` refuses by name where it is absent."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import R
from ..models.annulus import circle

_LAYER_DEPTHS = (20.0, 35.0, 210.0, 410.0, 660.0, 2740.0, 2891.5, 5100.0)


def layers2plot(npoints: int = 180):
    """Circles of the plotted velocity layers (src/ShortestPath.jl:68-72)."""
    return [circle(npoints, R - d, pop_end=False) for d in _LAYER_DEPTHS]


def require_matplotlib() -> None:
    """Raise an ImportError that names matplotlib where it cannot be
    imported (nothing is installed in its place)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "plotting needs matplotlib, which cannot be imported here "
            f"({e}); run without --plot or on a machine that has "
            "matplotlib") from e


def plot_paths(gr, paths: Sequence[np.ndarray], source: int, receivers: Sequence[int], fname: str = None):
    """Render the annulus with ray paths; returns the matplotlib figure."""
    require_matplotlib()
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    xs, zs = circle(360, R, pop_end=False)
    ax.add_patch(plt.Circle((0, 0), R, color="lightgreen", zorder=0))
    ax.add_patch(plt.Circle((0, 0), 3479.5, color="orange", zorder=1))
    ax.add_patch(plt.Circle((0, 0), 1270.0, color="yellow", zorder=2))
    ax.plot(xs, zs, color="black", lw=2, zorder=3)
    for lx, lz in layers2plot():
        ax.plot(lx, lz, color="black", lw=0.5, zorder=3)

    x, z = np.asarray(gr.x), np.asarray(gr.z)
    for p in paths:
        ax.plot(x[p], z[p], color="red", lw=1, zorder=4)
    rec = np.asarray(receivers)
    ax.scatter(x[rec], z[rec], s=20, color="black", zorder=5, label="receiver")
    ax.scatter([x[source]], [z[source]], s=60, color="black", marker="^", zorder=6, label="source")

    ax.set_aspect("equal")
    ax.axis("off")
    if fname:
        fig.savefig(fname, dpi=150, bbox_inches="tight")
    return fig
