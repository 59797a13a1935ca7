"""solve_roofline.table: the least time of the traced table requests'
solves (`portbench/work.py`, counted from the problem) over the
device's busy time inside their solve spans, in %."""
from portbench.metrics._common import solve_roofline_pct


def read(run):
    return solve_roofline_pct(run)
