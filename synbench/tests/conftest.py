"""The benchmark's tests.  Tests that need a CUDA card carry the ``card``
marker, registered here, and skip without one: whether a card is there is
decided inside the ``card`` fixture, never when a module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
