"""One intra-op thread for the port's in-process torch tests.

The multi-rank jobs' workers already run torch on one thread
(``torch_gloo._clean_env`` exports ``OMP_NUM_THREADS=1``). A test module
that computes with torch in the pytest process itself takes the same
rule through ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``:
beside the suite's other workers an intra-op pool of one thread per core
oversubscribes the cores, and its threads wait on each other. With six
busy processes on an 8-core host, the synthetic benchmark test's
ResNet-50 steps took 72.9 s on 8 threads and 6.7 s on one."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
