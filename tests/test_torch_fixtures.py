"""Fixtures shared by the port's test files (``tests/test_torch_*.py``);
each imports what it uses, so pytest applies it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in parallel workers on a few cores: torch's
    intra-op threads would spin against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
