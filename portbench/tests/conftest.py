"""Tests of the benchmark harness.  Run from the repo root:

    python -m pytest portbench/tests -q

They run the cells cut to a tiny size on the CPU, where the program runs its
kernels' plain versions.  The tests marked ``card`` run the cells at their
own size through the command and skip without an NVIDIA card:

    python -m pytest portbench/tests -q -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided here, when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run only on the card")
    return torch.device("cuda")
