"""A module-scoped fixture that runs a test file's torch ops on one CPU
thread (the previous count restored after it).  The suite runs its files
in several worker processes at once; at the small sizes of the port's
training and encoder-decoder tests extra intra-op threads buy little and
take cores from the other workers.  Import it into a test module to use
it: ``from tests._torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
