"""solver_iters.table: the rounds (the directional sweep) or iterations
a table request's solves take, from `AnnulusSolver.last_iterations`,
averaged over the run's window."""
from portbench.metrics._common import mean


def read(run):
    return mean(run.rec.counters.get("solver_iters", []))
