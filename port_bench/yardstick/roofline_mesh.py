"""The roofline yardstick of the forward trace kernel on scenes with
triangle meshes (kernel 1's mesh instance, ``trace_kernel``).

Frozen here, beside ``roofline.py``, whose peaks, shading count and lane
bytes it uses.  The count is the work a lane-bounce needs whatever sweeps
the triangles, so that no culling structure (chunk boxes, a BVH) makes it
stale: per lane-bounce the analytic geoms' sweep; per mesh the ray in its
object space and its reciprocal direction; one Moeller-Trumbore test, the
winner's, which any structure runs at least on a ray that meets a triangle;
the winner's shading normal (its clipped barycentric blend of the corner
normals, through the inverse transpose, made unit length); and the shading
of ``roofline.OPS_SHADE``.  Bytes per launch: the lanes' rays in and
radiance out, the geom, material and light tables, and each mesh's
triangle table: its corners and face normal (12 floats a triangle) and, where
it has them, its corner normals (9).

A lower bound of the least time, as ``roofline.trace_bound_s`` is: every
triangle test but one a lane-bounce, the sweep's culling tests and the shadow
rays' triangle tests are left out, and they are most of the kernel's work.
Like the analytic count it charges every lane-bounce the test and the shading
of a hit, also where the ray misses or ends on a light: on a scene whose
meshes cover much of the frame, as the configurations that use this count
do, the left-out triangle tests outweigh that many times over.
"""

from __future__ import annotations

from port_bench.yardstick.roofline import (
    FP32_OPS_PER_S,
    FWD_BYTES_PER_LANE,
    HBM_BYTES_PER_S,
    OPS_CUBE,
    OPS_SHADE,
    OPS_SPHERE,
    OPS_TO_OBJECT,
    SPHERE,
    lane_bounces,
    table_bytes,
)

MESH = 2
OPS_MT = 66  # one ray-triangle Moeller-Trumbore test and the running-best update
OPS_MESH_RAY = OPS_TO_OBJECT + 18  # a mesh's object-space ray and its reciprocal direction
# the winner's normal: clip u, v (4); w0 = clip(1 - u - v) (4); the blend of
# three corner normals (15); the inverse transpose (15); unit length (10)
OPS_MESH_NORMAL = 48
TRI_FLOATS = 12  # a triangle's corner v0, edges e1, e2 and face normal
NORM_FLOATS = 9  # its three corner normals, where the mesh has them


def analytic_sweep_ops(geom_types) -> int:
    """Operations of one nearest-hit sweep over the analytic geoms (a mesh
    geom's slot tests nothing)."""
    return sum(OPS_TO_OBJECT + (OPS_SPHERE if t == SPHERE else OPS_CUBE)
               for t in geom_types if t != MESH)


def mesh_bytes(mesh_tris) -> int:
    """The triangle tables of ``mesh_tris``, ``[(triangles, has normals)]``."""
    return sum(4 * n * (TRI_FLOATS + (NORM_FLOATS if normals else 0)) for n, normals in mesh_tris)


def trace_mesh_bound_s(rays: int, lanes: int, launches: int, geom_types, n_materials: int,
                       nee: bool, mesh_tris) -> float:
    """Least seconds of the forward trace kernel over ``launches`` launches
    of ``lanes`` paths each that traced ``rays`` rays in all, on a scene
    whose geoms are ``geom_types`` (meshes typed :data:`MESH`) and whose
    meshes are ``mesh_tris``, ``[(triangles, has normals)]``."""
    lb = lane_bounces(rays, nee)
    per = (analytic_sweep_ops(geom_types) + len(mesh_tris) * OPS_MESH_RAY
           + (OPS_MT + OPS_MESH_NORMAL if mesh_tris else 0) + OPS_SHADE)
    nbytes = launches * (lanes * FWD_BYTES_PER_LANE + table_bytes(len(geom_types), n_materials)
                         + mesh_bytes(mesh_tris))
    return max(lb * per / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
