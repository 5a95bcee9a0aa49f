"""Kernel 1's share of its roofline on a scene with triangle meshes: the
least time the traced stretch's paths need
(``yardstick/roofline_mesh.trace_mesh_bound_s``) over the forward trace
kernel's device time, in %.  A lower bound.  None where the entry names no
meshes or the stretch ran no trace kernel."""

from port_bench.harness.readers import TRACE_PATTERN, roofline_pct
from port_bench.yardstick.roofline_mesh import trace_mesh_bound_s


def value(t):
    c = t.context
    if not c.get("mesh_tris"):
        return None
    bound = trace_mesh_bound_s(c["rays"], c["pixels"], c["spp"], c["geom_types"],
                               c["n_materials"], c["nee"], c["mesh_tris"])
    return roofline_pct(t, TRACE_PATTERN, bound)
