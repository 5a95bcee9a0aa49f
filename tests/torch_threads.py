"""One intra-op thread per pytest-xdist worker for the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module first.  Under xdist
(``PYTEST_XDIST_WORKER`` set) each worker runs PyTorch with one thread:
the port's plain versions run many small ops, each an OpenMP region, and
several workers with a thread per core each contend for the same cores
(six 8-thread copies of one test ran for minutes where six 1-thread copies
took 0.7 s each).  A run in one process keeps PyTorch's default.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
