"""Run one function of a tool file in several checkouts in turns, one
process each, on one card, so that two versions of the port compare inside
one call:

    from pathtracer_tpu_torch.tools.in_turns import card, run_in_turns
    run_in_turns([("parent", DIR), ("change", "."), ...], __file__, "measure",
                 [card()], shown=("[split]",))

Each process runs with its checkout as the working directory and first on
``sys.path``, so that ``pathtracer_tpu_torch`` and ``chip_smoke`` are the
checkout's own (it builds its kernels from its own sources), while the
function comes from the tool file given: that file imports only the
standard library at its top, since a checkout may predate it.
"""

from __future__ import annotations

import os
import subprocess
import sys

CHILD = ("import os, runpy, sys; sys.path.insert(0, os.getcwd()); "
         "runpy.run_path(sys.argv[1])[sys.argv[2]](*sys.argv[3:])")


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def run_in_turns(checkouts, tool: str, func: str, args=(), shown=(), timeout: int = 1800) -> int:
    """Run ``func(*args)`` of the file ``tool`` in each ``(name, dir)`` of
    ``checkouts``, in the order given, one process each.  Prints each
    process's exit code, its standard-output lines that start with one of
    ``shown`` and, when it fails, the end of its errors.  Returns the first
    non-zero exit code, else 0."""
    rc = 0
    for name, path in checkouts:
        run = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tool), func, *args],
                             cwd=os.path.abspath(path), capture_output=True, text=True,
                             timeout=timeout)
        print(f"== {name} ({path}): exit {run.returncode}", flush=True)
        for line in run.stdout.splitlines():
            if line.startswith(tuple(shown)):
                print(line, flush=True)
        if run.returncode:
            rc = rc or run.returncode
            print(run.stderr[-3000:], flush=True)
    return rc
