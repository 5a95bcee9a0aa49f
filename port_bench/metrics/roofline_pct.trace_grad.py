"""Kernels 4 and 5's share of their roofline: the least time of the traced
stretch's forward with residuals and reverse loop
(``yardstick/roofline.trace_grad_bound_s``) over the device time of kernels
4 and 5, their row sums and lane order, in %.  A lower bound where the scene
has media."""

from port_bench.harness.readers import TRACE_GRAD_PATTERN, roofline_pct
from port_bench.yardstick.roofline import trace_grad_bound_s


def value(t):
    c = t.context
    bound = trace_grad_bound_s(c["rays"], c["pixels"], c["spp"], c["depth"], c["geom_types"],
                               c["n_materials"], c["nee"], c["vol"])
    return roofline_pct(t, TRACE_GRAD_PATTERN, bound)
