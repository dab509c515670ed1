"""One torch intra-op thread for the tests of a module that imports
:func:`one_torch_thread` (``from torch_one_thread import one_torch_thread``).

The suite runs several pytest workers on a few cores. There torch's own
intra-op pool only spins on cores the other workers need: the port's CPU
tests run small tensors, and one thread runs them as fast while taking a
fraction of the CPU time (``tests/test_torch_paged.py`` alone on an 8-core
host: 143 CPU seconds with the default pool, 75 with one thread, in less
wall time).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
