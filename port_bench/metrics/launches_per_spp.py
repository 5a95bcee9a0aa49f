"""Kernel launches per sample per pixel in the traced stretch."""

from port_bench.harness.readers import launches_per_spp


def value(t):
    return launches_per_spp(t)
