"""Seconds from the start of the cell to its first measured unit: the kernels'
build or load, the scene's parse, the target, and the warm-up at the cell's shapes."""


def value(run) -> float:
    return run.setup_s
