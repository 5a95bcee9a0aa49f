"""Device ms per sample per pixel of every kernel that is not hand-written: the
camera rays, the RNG, the accumulation, the tone map and the autograd glue."""

from port_bench.harness.readers import other_device_ms_per_spp


def value(t):
    return other_device_ms_per_spp(t)
