"""build_s: seconds of the program's host builders in set-up (the
velocities, the grid, the stencil, the solver object), a span around
the configuration's `systems/<geometry>.System`."""


def read(run):
    return run.setup.get("build_s")
