"""Tiny versions of the cells for the CPU tests: the same entries, configs
and limits at a few hundred pixels, and a window of a fraction of a second."""

import copy

from port_bench.harness import core

TINY = {"render": dict(width=24, height=16), "grad": dict(width=20, height=14)}


def tiny_cell(name: str) -> tuple:
    wl, cfg = core.load_cell(name)
    wl = copy.deepcopy(wl)
    wl["traffic"].update(TINY[wl["entry"]])
    wl["trace_units"] = 2
    if "pixels" in wl["check"]:
        wl["check"]["pixels"] = 64
    return wl, cfg


def run_tiny(name: str, seed: int, program=None, trace: bool = False) -> dict:
    wl, cfg = tiny_cell(name)
    return core.run_cell(wl, cfg, seed, 0.2, trace, device="cpu", program=program)
