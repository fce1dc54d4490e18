"""One torch intra-op thread for the port's CPU tests.

The suite runs several pytest-xdist worker processes on the same cores;
torch's own thread pool in each of them oversubscribes the cores and its
threads spin-wait.  Measured on an 8-core host with six workers, the
port's test files took 154 s with the default pool and 21 s with one
thread.  Import the fixture into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
