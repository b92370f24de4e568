import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one (decided inside the test)")


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine: the test runs on the card only")
