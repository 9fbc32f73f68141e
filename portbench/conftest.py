"""The benchmark's own pytest settings: the ``card`` marker for tests that
need a CUDA device, which decide inside the ``card`` fixture and skip
without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (the NVIDIA H100 the benchmark runs on)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python3 -m pytest portbench/tests -m card`")
    return torch.device("cuda", 0)
