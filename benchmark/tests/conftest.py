"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the repository's root. Tests marked `cuda` need the card and skip without
one (decided inside the `card` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
