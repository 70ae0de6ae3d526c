"""The port's test files share one fixture: torch on one thread.

Import it into a test module with
``from torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one thread, so that beside other test
    processes no op waits for a time slice on every core (spinning
    threads of 8-way parallel regions also slow the JAX side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
