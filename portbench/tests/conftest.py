"""CPU tests of the benchmark: ``python -m pytest portbench/tests -q``.

Tests that need a CUDA card carry the ``card`` marker and skip here; they
decide inside a fixture, never at import time.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")


@pytest.fixture(autouse=True)
def _cpu_program():
    import torch

    from ppca_rs_tpu_torch.config import config

    before, threads = config.device, torch.get_num_threads()
    config.device = torch.device("cpu")
    torch.set_num_threads(2)
    yield
    config.device = before
    torch.set_num_threads(threads)
