"""round_idle_ms.table: the device's idle time inside the sweep rounds of
a traced table request: the idle gaps of the profiler's device timeline
whose midpoint falls, on the shared clock, while the host is inside a
`sweep.round` span (or one of its children), in ms."""
from portbench.metrics._program import per_table_idle_ms


def read(run):
    return per_table_idle_ms(run, "sweep.round")
