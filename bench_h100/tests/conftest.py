"""Tests of the benchmark's harness. They import nothing of JAX: run them as
``python -m pytest -q bench_h100/tests`` from the root of the repository.
Tests that need a CUDA card take the ``cuda`` fixture, which skips without
one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
