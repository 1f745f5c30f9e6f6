"""Fixtures of the benchmark's CPU tests."""

from __future__ import annotations

import pytest
import torch

from h100_bench.core import manifest


@pytest.fixture
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(4, old))
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA GPU where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")


@pytest.fixture(scope="session")
def man():
    return manifest()

