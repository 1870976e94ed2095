"""The port's test files run torch on one intra-op thread.

The suite runs in several xdist worker processes that share the cores;
at torch's default thread count (one per core) each worker's ops
contend with every other worker's, and a file's small CPU passes take
minutes instead of seconds. Every ``tests/test_torch_*.py`` imports
the fixture by name, which registers it for that module::

    from torch_threads import one_torch_thread  # noqa: F401

``test_torch_pipeline.py::test_every_port_test_file_pins_one_thread``
fails when a file does not.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
