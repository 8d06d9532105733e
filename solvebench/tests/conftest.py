"""The benchmark's own tests (``python -m pytest solvebench/tests``).
Tests that need a card are marked ``cuda``; the card is decided inside
the ``card`` fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    return torch.device("cuda", 0)
