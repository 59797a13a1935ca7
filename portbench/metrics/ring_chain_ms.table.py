"""ring_chain_ms.table: the device milliseconds of the ring and chain
scans (`sweep.ring_chain` spans) in a traced table request, each span
from its entry to its exit CUDA event in stream order (idle inside the
span included)."""
from portbench.metrics._program import per_table_device_ms


def read(run):
    return per_table_device_ms(run, "sweep.ring_chain")
