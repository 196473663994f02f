import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips inside the test without "
        "one)")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided inside the test, never at
    import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
