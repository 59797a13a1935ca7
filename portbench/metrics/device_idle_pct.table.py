"""device_idle_pct.table: the share of the traced table requests' extent in
which no operation ran on the device (torch.profiler's timeline)."""
from portbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
