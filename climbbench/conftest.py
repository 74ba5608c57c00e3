"""pytest settings of the benchmark's own tests (``climbbench/tests``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one "
        "(on the card: python -m pytest climbbench/tests -m card)")


@pytest.fixture
def card():
    """The first CUDA card; skips the test without one. Decided when the
    test runs, never at import or collection."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
