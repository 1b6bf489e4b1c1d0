"""Tests of the benchmark harness.  Run them from the root of the repo:

    python3 -m pytest mapbench/tests -q

Tests marked ``cuda`` need a GPU and skip without one."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where none is present")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
