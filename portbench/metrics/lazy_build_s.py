"""lazy_build_s: seconds of the program's builders that run in the first
request rather than in its build (`build_s`): the outermost
`build.stencil`, `build.sweep_tables` and `build.kernel` set-up spans."""
from portbench.metrics._program import lazy_build_s


def read(run):
    return lazy_build_s()
