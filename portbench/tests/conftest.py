"""CPU tests of the benchmark (``python -m pytest portbench/tests -q``).

Tests marked ``card`` run a cell on a CUDA device and skip elsewhere; the
decision is made inside the ``card`` fixture, never at import."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips elsewhere)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
