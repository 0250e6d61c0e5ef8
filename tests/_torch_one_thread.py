"""An autouse fixture for the PyTorch port's CPU tests: each test runs at
one intra-op thread. The fast tier runs in several worker processes at once
(``-n 6``), and at torch's default of a thread a core each of the tests'
many small operations waits at a barrier for threads that the busy cores do
not schedule; the tiny shapes gain nothing from more threads."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
