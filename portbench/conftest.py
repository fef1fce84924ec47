"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``).  Tests marked ``card`` need a CUDA card; each decides
inside its ``card`` fixture whether one is there and skips without it."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
