import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the chip)")
    return torch.device("cuda", 0)
