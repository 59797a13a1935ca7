"""host_syncs.table: the calls that block the host until the card drains
its stream (`.item()`, `.cpu()`, tensors built on the card from host
data), counted by the program where they happen (`host_syncs` under each
traced table request's `table` span), a table request."""
from portbench.metrics._program import per_table_count


def read(run):
    return per_table_count(run, "host_syncs")
