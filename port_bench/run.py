"""Benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks`` (each number compared with its limit,
which the last lines of standard error repeat).  See ``README.md``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
