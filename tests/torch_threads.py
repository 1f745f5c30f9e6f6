"""Autouse fixture for the PyTorch-port tests: one intra-op thread per test
process. The suite runs in several worker processes at once, and torch's
default of one thread per core in each of them oversubscribes the CPU
(measured: a 3 s test took 20 s under six workers)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
