"""Nearest hit, winner search and shadow-ray occlusion of analytic scenes:
the CUDA kernels and their dispatch.

Port of ``pathtracer_tpu/ops/intersect_pallas.py:174-343``
(``winner_t_gid_planes``, ``nearest_hit_planes``, ``occlusion_t_planes``,
and for scenes of spheres and cubes ``intersect_scene_pallas`` /
``occlusion_scene_pallas``).  The kernels are ``csrc/intersect.cu`` (one
thread per lane, the geom table in shared memory); their plain versions are
``ops/intersect.nearest_hit_plain``, ``winner_t_gid_plain`` and
``occlusion_t_plain``.  :func:`nearest_hit`, :func:`winner_t_gid` and
:func:`occlusion_t` dispatch on the rays' device: a CUDA tensor launches
the kernel or raises, a CPU tensor takes the plain version.  With meshes,
:func:`nearest_hit` and :func:`occlusion_t` are the split route's
``intersect_scene_pallas`` / ``occlusion_scene_pallas``
(``intersect_pallas.py:283-333``): kernel 6 with the mesh winner of
``ops/mesh.mesh_only_hit`` merged in where it is nearer (with the authored
UV of a mesh with ``vt``), and kernel 8 with
``ops/mesh.mesh_only_occlusion``'s minimum (kernels 9 and 10 inside).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.intersect import (
    BIG,
    GEOM_COLS,
    Hit,
    nearest_hit_plain,
    occlusion_t_plain,
    winner_t_gid_plain,
)
from pathtracer_tpu_torch.ops.mesh import mesh_only_hit, mesh_only_occlusion
from pathtracer_tpu_torch.ops.trace import MAX_GEOMS, check_tensor
from pathtracer_tpu_torch.scene.structs import Rays

nearest_launches = 0  # launches of csrc/intersect.cu:nearest_kernel in this process
occlusion_launches = 0  # launches of csrc/intersect.cu:occlusion_kernel
winner_launches = 0  # launches of csrc/intersect.cu:winner_kernel

P, I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("intersect")
    if lib.nearest_launch.argtypes is None:  # ctypes would cut pointers to 32 bits
        lib.nearest_launch.restype = ctypes.c_int
        # gtab, G, n, origin, direction, t, gid, mid, p, p_obj, normal, stream
        lib.nearest_launch.argtypes = [P, I, I, P, P, P, P, P, P, P, P, P]
        lib.occlusion_launch.restype = ctypes.c_int
        # gtab, G, n, origin, direction, t, stream
        lib.occlusion_launch.argtypes = [P, I, I, P, P, P, P]
        lib.winner_launch.restype = ctypes.c_int
        # gtab, G, n, origin, direction, t, gid, stream
        lib.winner_launch.argtypes = [P, I, I, P, P, P, P, P]
    return lib


def _check(rays: Rays, gtab: torch.Tensor):
    """The launchers' input checks; returns ``(n, G, device)``."""
    device = rays.origin.device
    if device.type != "cuda":
        raise ValueError(f"intersection kernels need CUDA tensors, got {device}")
    n, g = rays.origin.shape[0], gtab.shape[0]
    if 3 * n >= 2**31:  # the kernels index the [N, 3] planes with 32-bit ints
        raise ValueError(f"intersection kernels take fewer than {2**31 // 3} rays, got {n}")
    if not 1 <= g <= MAX_GEOMS:
        raise ValueError(f"intersection kernels take 1..{MAX_GEOMS} geoms, got {g}")
    check_tensor(gtab, "geom table", torch.float32, (g, GEOM_COLS), device)
    check_tensor(rays.origin, "origin", torch.float32, (n, 3), device)
    check_tensor(rays.direction, "direction", torch.float32, (n, 3), device)
    return n, g, device


def nearest_hit_cuda(rays: Rays, gtab: torch.Tensor) -> Hit:
    """Launch kernel 6: the nearest hit of every ray with its full record."""
    global nearest_launches
    n, g, device = _check(rays, gtab)
    f32, i32 = dict(dtype=torch.float32, device=device), dict(dtype=torch.int32, device=device)
    t, gid, mid = torch.empty(n, **f32), torch.empty(n, **i32), torch.empty(n, **i32)
    p, p_obj, normal = (torch.empty((n, 3), **f32) for _ in range(3))
    err = _lib().nearest_launch(
        gtab.data_ptr(), g, n, rays.origin.data_ptr(), rays.direction.data_ptr(),
        t.data_ptr(), gid.data_ptr(), mid.data_ptr(), p.data_ptr(), p_obj.data_ptr(),
        normal.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nearest-hit kernel launch failed: CUDA error {err}")
    nearest_launches += 1
    return Hit(t=t, hit=t < BIG, geom_id=gid, material_id=mid, position=p,
               position_obj=p_obj, normal=normal)


def winner_t_gid_cuda(rays: Rays, gtab: torch.Tensor):
    """Launch kernel 7: each ray's winner ``(t [N] float32, gid [N]
    int32)``, with ``BIG`` and geom 0 on a miss."""
    global winner_launches
    n, g, device = _check(rays, gtab)
    t = torch.empty(n, dtype=torch.float32, device=device)
    gid = torch.empty(n, dtype=torch.int32, device=device)
    err = _lib().winner_launch(
        gtab.data_ptr(), g, n, rays.origin.data_ptr(), rays.direction.data_ptr(),
        t.data_ptr(), gid.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"winner kernel launch failed: CUDA error {err}")
    winner_launches += 1
    return t, gid


def occlusion_t_cuda(rays: Rays, gtab: torch.Tensor) -> torch.Tensor:
    """Launch kernel 8: each shadow ray's nearest ``t`` (``BIG`` = clear)."""
    global occlusion_launches
    n, g, device = _check(rays, gtab)
    t = torch.empty(n, dtype=torch.float32, device=device)
    err = _lib().occlusion_launch(
        gtab.data_ptr(), g, n, rays.origin.data_ptr(), rays.direction.data_ptr(),
        t.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"occlusion kernel launch failed: CUDA error {err}")
    occlusion_launches += 1
    return t


def _route(rays: Rays, kernel, plain):
    device_type = rays.origin.device.type
    if device_type == "cuda":
        return kernel
    if device_type == "cpu":
        return plain
    raise ValueError(f"no intersection for device type {device_type!r}")


def nearest_hit(rays: Rays, gtab: torch.Tensor, meshes=()) -> Hit:
    """Nearest hit over the geom table ``gtab`` (``pack_geom_table``) and
    the mesh instances ``meshes``."""
    hit = _route(rays, nearest_hit_cuda, nearest_hit_plain)(rays, gtab)
    if not meshes:
        return hit
    mt, mpo, mnw, mmid, mgid, muv, muvv = mesh_only_hit(rays, gtab, meshes)
    better = mt < hit.t
    b = better[:, None]
    t = torch.where(better, mt, hit.t)
    t_safe = torch.where(t < BIG, t, 1.0)
    any_uv = any(m.tri_uv is not None for m in meshes)
    return Hit(
        t=t,
        hit=t < BIG,
        geom_id=torch.where(better, mgid, hit.geom_id),
        material_id=torch.where(better, mmid, hit.material_id),
        position=torch.where(b, rays.origin + t_safe[:, None] * rays.direction, hit.position),
        position_obj=torch.where(b, mpo, hit.position_obj),
        normal=torch.where(b, mnw, hit.normal),
        uv=torch.where(b, muv, 0.0) if any_uv else None,
        uv_valid=better & muvv if any_uv else None,
    )


def winner_t_gid(rays: Rays, gtab: torch.Tensor):
    """The nearest hit's ``(t, gid)`` over the geom table ``gtab``, without
    the hit frame (the lean scan's detached winner search)."""
    return _route(rays, winner_t_gid_cuda, winner_t_gid_plain)(rays, gtab)


def occlusion_t(rays: Rays, gtab: torch.Tensor, meshes=()) -> torch.Tensor:
    """Shadow-ray nearest ``t`` over the geom table ``gtab`` and the mesh
    instances ``meshes``."""
    t = _route(rays, occlusion_t_cuda, occlusion_t_plain)(rays, gtab)
    if meshes:
        t = torch.minimum(t, mesh_only_occlusion(rays, gtab, meshes))
    return t
