"""Tests of the benchmark itself, run on the CPU with
``python -m pytest regbench/tests``; the tests marked ``chip`` run a cell on
a CUDA card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    """The CUDA device, decided when the test runs; a skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")
    return torch.device("cuda", 0)
