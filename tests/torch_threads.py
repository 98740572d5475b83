"""One torch intra-op thread for a port test module.

The port's CPU tests run tiny shapes, where torch's intra-op thread pool
buys little and, with several test workers on one machine, its idle
threads spin on cores the other workers need.  A port test file opts in by
importing the fixture into its namespace::

    from torch_threads import one_torch_thread  # noqa: F401

It sets the count to 1 for the module and restores the previous count
after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
