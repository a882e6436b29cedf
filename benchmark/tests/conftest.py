"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the repository root.

Tests marked ``card`` need a CUDA card; they decide inside the ``card``
fixture, never at import, and skip here with the reason.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with python -m pytest benchmark/tests -m card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(4, old))
    yield
    torch.set_num_threads(old)
