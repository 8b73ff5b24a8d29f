"""One torch intra-op thread for the port's CPU test modules.

The tier-1 run puts six pytest-xdist workers on one host. Each worker's
torch would start one intra-op thread per core, and the workers' threads
then contend for the cores: run three at once on an 8-core host, the
port's three heaviest test files took 139-185 s each with torch's default
threads and 45-62 s with one (26-35 s each alone). Their tiny models gain
nothing from intra-op threads. A test module imports ``one_torch_thread``
(an autouse fixture), which sets one thread for the module and restores
the count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
