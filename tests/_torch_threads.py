"""One PyTorch intra-op thread for the port's CPU tests.

The suite runs under pytest-xdist with several workers on one machine.
PyTorch's default intra-op pool (a thread per core) in every worker would
oversubscribe the cores the JAX tests in the other workers run on, so each
``tests/test_torch_*.py`` module imports this autouse fixture.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
