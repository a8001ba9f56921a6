"""Tests of the benchmark harness.  Those that need a CUDA card carry the
``cuda`` marker and skip without one; the card is looked for inside the
test, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
