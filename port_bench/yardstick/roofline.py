"""The roofline yardstick: peaks of the card and the work of the trace kernels.

Frozen here so that no change to the program or to its smoke script moves
the measure.  The peaks are NVIDIA's data sheet for the H100 SXM (dense, at
its 700 W limit); the per-lane operation counts were counted by hand from
the trace kernels' source (one multiply, add, compare, select, min/max,
sqrt, rsqrt, divide, sin or cos each) and are the same numbers for every
implementation: they count what a bounce needs, not what a kernel issues.

The least time of a kernel is the larger of its counted operations over
the peak rate and its counted bytes over the memory bandwidth.  Lane-bounces
come from the entry's exact ray count, halved under next-event estimation
(one shadow ray per live bounce).  Shadow-ray sweeps and, with media, the
in-medium scatter and its light connection depend on the data and are left
out, so these are lower bounds of the least time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores, a fused multiply-add counted as two
FP64_OPS_PER_S = 34e12

OPS_TO_OBJECT = 33  # one geom's object-space ray
OPS_SPHERE = 37 + 2
OPS_CUBE = 46 + 2
OPS_SHADE = 270  # a non-emissive hit: frame, BSDF sample, light sample, NEE geometry
OPS_VOL = 25  # free path, the segment's attenuation, the medium switch
# the reverse kernel beyond the replayed intersection: the adjoint of the
# shading (tangent frame, NEE connection, normal, hit point, object ray,
# table accumulation), in double
OPS_BWD_ADJOINT = 550
OPS_BWD_VOL = 40  # the media blocks' adjoint, in double

SPHERE = 0
FWD_BYTES_PER_LANE = 12 + 12 + 4 + 12  # origin, direction, sample in; radiance out
N_RESID = 13  # forward residual planes per bounce, vacuum
N_RESID_VOL = 17  # with media


def sweep_ops(geom_types) -> int:
    """Operations of one nearest-hit sweep over the scene's geoms."""
    return sum(OPS_TO_OBJECT + (OPS_SPHERE if t == SPHERE else OPS_CUBE) for t in geom_types)


def table_bytes(n_geoms: int, n_materials: int) -> int:
    """The packed geom (14), material (28) and light (19) tables and two scalars."""
    return 4 * (14 * n_geoms + 28 * n_materials + 19 * n_geoms + 2)


def lane_bounces(rays: int, nee: bool) -> int:
    return rays // 2 if nee else rays


def trace_bound_s(rays: int, lanes: int, launches: int, geom_types, n_materials: int,
                  nee: bool, vol: bool) -> float:
    """Least seconds of the forward trace kernel over ``launches`` launches
    of ``lanes`` paths each that traced ``rays`` rays in all."""
    lb = lane_bounces(rays, nee)
    ops = lb * (sweep_ops(geom_types) + OPS_SHADE + (OPS_VOL if vol else 0))
    nbytes = launches * (lanes * FWD_BYTES_PER_LANE + table_bytes(len(geom_types), n_materials))
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def trace_grad_bound_s(rays: int, lanes: int, launches: int, depth: int, geom_types,
                       n_materials: int, nee: bool, vol: bool) -> float:
    """Least seconds of the differentiable trace: the forward with its
    residuals (kernel 4) and the reverse loop (kernel 5, its adjoint in
    double), over ``launches`` iterations of ``lanes`` paths that traced
    ``rays`` rays in the forward."""
    lb = lane_bounces(rays, nee)
    g, tb = len(geom_types), table_bytes(len(geom_types), n_materials)
    planes = N_RESID_VOL if vol else N_RESID
    f_ops = lb * (sweep_ops(geom_types) + OPS_SHADE + (OPS_VOL if vol else 0))
    f_bytes = launches * (lanes * FWD_BYTES_PER_LANE + depth * planes * lanes * 4 + tb)
    f_s = max(f_ops / FP32_OPS_PER_S, f_bytes / HBM_BYTES_PER_S)
    # the replayed intersection and the float recompute at the fp32 rate,
    # the adjoint at the fp64 rate
    b_ops = lb * (OPS_TO_OBJECT + min(OPS_SPHERE, OPS_CUBE) + OPS_SHADE)
    b_ops64 = lb * (OPS_BWD_ADJOINT + (OPS_BWD_VOL if vol else 0))
    # the alive plane of every bounce, the other planes of the live ones, the
    # sample and the radiance cotangent in; the ray cotangents, the tables
    # and their cotangent row out
    b_bytes = (launches * (depth * lanes * 4 + lanes * (4 + 12 + 12 + 12) + 2 * tb)
               + lb * (planes - 1) * 4)
    b_s = max(b_ops / FP32_OPS_PER_S + b_ops64 / FP64_OPS_PER_S, b_bytes / HBM_BYTES_PER_S)
    return f_s + b_s
