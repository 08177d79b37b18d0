"""A fixture for the port's CPU tests: one torch intra-op thread.

The suite runs in several pytest workers on a machine with few cores;
each worker's torch would start a thread per core, and the oversubscribed
pools make the port's many small tensor operations several times slower.
Import ``one_torch_thread`` into a test module to use it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
