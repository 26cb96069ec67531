"""One intra-op thread for the port's CPU tests.

The test suite runs in several worker processes at once.  torch's default
of one intra-op thread per core then puts several times more busy threads
than cores on the machine, and the small tensors of these tests gain
nothing from threads: a test module that imports `one_torch_thread` runs
with one thread and restores the previous count after its last test.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
