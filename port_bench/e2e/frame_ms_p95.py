"""The 95th percentile over every preview frame of the window of the time from the
frame's first launch to its 8-bit image in host memory, in ms (nearest rank)."""

from port_bench.harness.core import nearest_rank


def value(run) -> float:
    return nearest_rank(run.latencies_s, 0.95) * 1e3
