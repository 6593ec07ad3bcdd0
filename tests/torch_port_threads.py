"""A fixed intra-op thread count for the port's CPU tests.

Under xdist every worker's torch would start a pool of one thread a core:
six workers on eight cores oversubscribe them, and the port's heavy files
ran two to four times slower.  A test module imports the autouse fixture
(`from tests.torch_port_threads import two_threads`), or wraps a block in
`pinned(n)`.  The CPU's threaded convolution backward is not repeatable
from run to run at two threads either: a test that needs a trajectory to
repeat bit for bit runs it in `pinned(1)`."""

from __future__ import annotations

import contextlib

import pytest
import torch

THREADS = 2


@contextlib.contextmanager
def pinned(n: int = THREADS):
    """torch's intra-op threads at `n` within the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """THREADS intra-op threads for the whole module."""
    with pinned(THREADS):
        yield
