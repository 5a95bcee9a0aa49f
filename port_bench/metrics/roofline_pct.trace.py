"""Kernel 1's share of its roofline: the least time the traced stretch's paths
need (``yardstick/roofline.trace_bound_s``) over the forward trace kernel's
device time, in %.  A lower bound where the scene has media."""

from port_bench.harness.readers import TRACE_PATTERN, roofline_pct
from port_bench.yardstick.roofline import trace_bound_s


def value(t):
    c = t.context
    bound = trace_bound_s(c["rays"], c["pixels"], c["spp"], c["geom_types"], c["n_materials"],
                          c["nee"], c["vol"])
    return roofline_pct(t, TRACE_PATTERN, bound)
