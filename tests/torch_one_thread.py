"""A module-scoped fixture that runs a test module's torch work on one
intra-op thread: the tiny CPU models launch thousands of small operations,
and with several test workers on the same cores each multi-threaded
parallel region waits for its threads to be scheduled (measured ~40x slower
than one thread under that load)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
