"""Two torch threads a test, and ``OMP_NUM_THREADS=2`` for the
subprocesses it starts, restored after it.

The suite runs several xdist workers, and each torch process takes a
thread a core by default: the workers' thread pools oversubscribe the
host, and the smoke models' small operations then wait on each other's
threads, many times slower than alone.  The smoke models gain nothing
from more than two threads.  A test module applies it by importing
``few_threads`` (an autouse fixture)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    yield
    torch.set_num_threads(n)
