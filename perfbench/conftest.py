"""Test settings of the benchmark's own tests: the ``card`` marker, for
tests that run only where a CUDA card is (they skip elsewhere, decided in
the ``card`` fixture when a test runs)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return "cuda"
