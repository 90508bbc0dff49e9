"""One PyTorch intra-op thread for the port's tests on the CPU.

The tier-1 command runs the tests in six xdist workers on one machine.
PyTorch's CPU ops start a team of threads, one per core, in every
worker, and the teams' waits starve each other and the JAX tests: on an
8-core x86-64 CPU the whole suite took more than twice as long with
PyTorch's default thread count as with one thread per worker, with the
same tests passing.  A test module that imports :func:`one_torch_thread` runs with
one thread; the count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
