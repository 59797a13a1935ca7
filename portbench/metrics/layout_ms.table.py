"""layout_ms.table: the device milliseconds of the copies into and out of
the rsweep kernel's layout (`sweep.layout` spans) in a traced table
request, each span from its entry to its exit CUDA event in stream order
(idle inside the span included)."""
from portbench.metrics._program import per_table_device_ms


def read(run):
    return per_table_device_ms(run, "sweep.layout")
