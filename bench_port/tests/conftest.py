"""Tests of the benchmark harness, on the CPU at small sizes.

Run from the root of the repository:

    python -m pytest bench_port/tests -q

A test that needs a CUDA card is marked ``card`` and asks for the ``card``
fixture, which skips it where there is none; on a machine with a card the
same command runs it.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs the benchmark on the card")
    return torch.device("cuda", 0)
