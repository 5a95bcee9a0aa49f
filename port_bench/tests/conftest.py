"""The benchmark's own tests: run with ``python -m pytest port_bench/tests``.

The repository root goes on ``sys.path`` so that ``port_bench`` and the
program import as in a run.  Under pytest-xdist each worker takes one torch
thread, as the repository's own tests do.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
