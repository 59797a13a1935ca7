"""CPU tests of the benchmark itself (the harness, its traffic, its
reference and its least-work formula).  Run from the repo root:

    python -m pytest portbench/tests -q

Tests that need the card carry the `card` marker; a fixture skips them
where torch sees no CUDA device, so they run only on the card:
`python -m pytest portbench/tests -q -m card`.
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A benchmark root with the tiny cells (see tiny.py)."""
    from portbench.tests.tiny import make_root

    return make_root(str(tmp_path_factory.mktemp("bench")),
                     {"traced_requests": 2, "trace_skip": 1})


@pytest.fixture(scope="session")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
