"""Full-depth path trace: the CUDA kernel and its plain version.

Port of ``pathtracer_tpu/ops/trace_pallas.py:62-297`` (``_trace_kernel``,
``_trace_call``, ``trace_fused``, ``fused_trace_eligible``).  One call
traces a wavefront of primary rays through all ``max_depth`` bounces:
per lane the counter-hash uniforms, :func:`bounce_physics`, alive masking,
russian roulette, the radiance sum, and the measured ray count (alive
lanes per bounce, twice that with NEE for the shadow rays).

* :func:`trace_plain` is the plain PyTorch version: the bounce loop of
  ``trace_pallas.py:110-173`` over ``ops/bounce.py`` and
  :func:`step_update`, which the differentiable trace shares.
* :func:`trace_cuda` launches ``csrc/trace.cu``: persistent threads, each
  running whole paths (all bounces in a loop inside the thread) and
  starting a new path in a lane as soon as its path ends.
* :func:`trace_fused` dispatches on the rays' device: a CUDA tensor
  launches the kernel or raises, a CPU tensor takes the plain version.

Participating media (``volumetric``, ``hg``; ``trace_pallas.py:90-98,
170-173``): both versions carry the medium from bounce to bounce, and the
kernel has an instance for each (``kVol``, ``kHg``), picked from
``cfg.features`` (:func:`media_args`), so vacuum scenes keep the vacuum
code; each instance counts its launches.

The optional surface features (``texture``, ``bump``, ``microfacet``,
``ward``) run in the kernel's ``kSurf`` instance, whose blocks the feature
bits of :func:`surface_bits` switch on; it counts in ``surf_launches``,
whatever its mesh and media case.  Image textures are outside the one-kernel
trace, as in JAX (``trace_pallas.py:196-203``): such scenes run the
per-bounce scan (``render/megakernel.trace_paths``).

A scene whose meshes total at most ``ops/mesh_tables.MESH_INKERNEL_MAX_TRIS``
triangles is in the kernel's scope (``trace_pallas.py:185-202``): both
versions take its in-kernel tables (``mesh=``, the scene's
``mesh_tables``) and sweep the triangles inside the bounce loop.  Larger
meshes run per bounce, on kernel 2's mesh-merge variant, as in JAX
(``render/megakernel.trace_paths`` sends them to the per-bounce scan).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.bounce import (
    LIGHT_COLS,
    MAT_COLS,
    SURFACE_FEATURES,
    bounce_physics,
    check_features,
    pack_tables,
)
from pathtracer_tpu_torch.ops.intersect import GEOM_COLS, T_MIN
from pathtracer_tpu_torch.ops.mesh_tables import mesh_inkernel_eligible
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes, sample_bits

MAX_GEOMS = 128  # table caps of the kernel's shared-memory copy
MAX_MATERIALS = 128

launches = 0  # launches of csrc/trace.cu for analytic vacuum scenes in this process
vol_launches = 0  # launches of its volumetric instance (analytic scenes)
hg_launches = 0  # launches of its volumetric instance with the HG phase
mesh_launches = 0  # launches of its mesh variant (in-kernel triangle tables)
mesh_vol_launches = 0  # launches of its mesh variant's volumetric instances
surf_launches = 0  # launches of its instances with the surface blocks, any mesh or media case



def fused_trace_eligible(scene, cfg) -> bool:
    """Scope of the one-kernel trace: the counter-hash RNG, no image
    textures, and meshes only when the in-kernel sweep takes them."""
    return (cfg.fast_rng and scene.textures is None
            and (not scene.meshes or mesh_inkernel_eligible(scene.meshes)))


def mesh_launch_args(mesh, device) -> tuple:
    """The kernels' six mesh arguments: table pointers, descriptors and the
    mesh count of ``ops/mesh_tables.KernelMeshes`` (0 for None), after
    checking the tables are what the kernels read."""
    if mesh is None:
        return (None, None, None, None, None, 0)
    for t, name in ((mesh.tri, "mesh triangles"), (mesh.aabb, "mesh chunk boxes"),
                    (mesh.norm, "mesh normals"), (mesh.uv, "mesh UVs")):
        check_tensor(t, name, torch.float32, t.shape, device)
    check_tensor(mesh.desc, "mesh descriptors", torch.int32, (len(mesh.descs), 5), device)
    return (mesh.tri.data_ptr(), mesh.aabb.data_ptr(), mesh.norm.data_ptr(),
            mesh.uv.data_ptr(), mesh.desc.data_ptr(), len(mesh.descs))


MESH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int]  # tri, aabb, norm, uv, desc, count
MEDIA_ARGTYPES = [ctypes.c_int] * 3  # volumetric, hg, vol_nee
SURF_ARGTYPE = ctypes.c_int  # the surface feature bits


def surface_bits(features) -> int:
    """The kernels' surface feature bits (``trace_common.cuh`` ``SURF_*``):
    1 texture, 2 bump, 4 microfacet, 8 ward; 0 runs the instance without
    the surface blocks."""
    return sum(1 << i for i, f in enumerate(SURFACE_FEATURES) if f in features)


def media_args(features, vol_nee: bool) -> tuple:
    """The kernels' three media arguments: whether the ``volumetric`` and
    ``hg`` instances run (``hg`` only with ``volumetric``: without it the
    phase g is inert) and whether in-medium scatter samples the light."""
    vol = "volumetric" in features
    return int(vol), int(vol and "hg" in features), int(bool(vol_nee))


def step_update(out, o, d, thr, prev_state, alive, dep: int, *, rr: bool, rr_start: int):
    """The bounce loop's update after :func:`bounce_physics` (port of
    ``pathtracer_tpu/ops/trace_grad.py:79-112``): the radiance increment
    and the next carries.  Russian roulette multiplies by ``1 / p`` with
    ``p`` detached.  A lane that dies keeps its carries as they were at its
    death, the emit state included (a dead lane's state never reaches the
    radiance).  ``trace_plain``, the forward with residuals and the reverse
    loop of ``ops/trace_grad.py`` all run this one function.

    Returns ``(rad_inc, new_alive, thr, o, d, prev_state)``."""
    rad_inc = tuple(torch.where(alive, c, 0.0) for c in out["contrib"])
    new_alive = alive & (~out["terminate"])
    thr2 = tuple(torch.where(new_alive, t * m, t) for t, m in zip(thr, out["thr_mult"]))
    if rr:
        p = torch.clamp(torch.maximum(torch.maximum(thr2[0], thr2[1]), thr2[2]), 0.05, 1.0)
        p = p.detach()
        rr_active = new_alive & (dep >= rr_start)
        survive = out["rru"] < p
        inv_p = 1.0 / p
        thr2 = tuple(torch.where(rr_active, t * inv_p, t) for t in thr2)
        new_alive = new_alive & (survive | (~rr_active))
    next_o = tuple(torch.where(new_alive, n, prev) for n, prev in zip(out["next_o"], o))
    next_d = tuple(torch.where(new_alive, n, prev) for n, prev in zip(out["next_d"], d))
    next_state = torch.where(new_alive, out["wspec"], prev_state)
    return rad_inc, new_alive, thr2, next_o, next_d, next_state


def init_carries(origin, direction):
    """Carries at bounce 0: ``(o, d, thr, prev_state, alive)``."""
    shape = origin.shape[:1]
    f32 = dict(dtype=torch.float32, device=origin.device)
    return (
        tuple(origin.unbind(-1)),
        tuple(direction.unbind(-1)),
        (torch.ones(shape, **f32),) * 3,
        torch.zeros(shape, **f32),
        torch.ones(shape, dtype=torch.bool, device=origin.device),
    )


def trace_plain(
    gtab, mtab, ltab, scal, seed: int, origin, direction, sample_idx,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int,
    features=frozenset(), mesh=None, vol_nee: bool = True,
):
    """Plain version: ``(radiance [N, 3] float32, rays_traced int64 [])``.
    Differentiable in the tables and the rays; ``mesh`` is the scene's
    in-kernel triangle tables or None.  Every path starts in vacuum; with
    ``volumetric`` in ``features`` the medium (sigma_a rgb, sigma_s and,
    with ``hg``, the phase g) is carried from bounce to bounce, as in
    ``trace_pallas.py:93-98,170-173``.

    Each bounce runs on the lanes still alive only, as the kernel's threads
    do: the carries of the lanes that die are dropped (``lanes`` keeps the
    original index of each carried lane), so a lane's values are those of
    the whole-wavefront loop and the work follows the paths' length."""
    o, d, thr, prev_state, alive = init_carries(origin, direction)
    sigma_a = (torch.zeros_like(prev_state),) * 3
    sigma_s = torch.zeros_like(prev_state)
    medium_g = torch.zeros_like(prev_state) if "hg" in features else None
    radiance = torch.zeros((origin.shape[0], 3), dtype=torch.float32, device=origin.device)
    lanes = torch.arange(origin.shape[0], device=origin.device)
    nrays = torch.zeros((), dtype=torch.int64, device=origin.device)
    ray_mult = 2 if nee else 1

    for dep in range(max_depth):
        if lanes.numel() == 0:
            break
        nrays = nrays + lanes.numel() * ray_mult
        u = hash_uniforms_planes(seed, sample_idx[lanes], dep, 11)
        out = bounce_physics(
            o, d, thr, sigma_a, sigma_s, gtab, mtab, ltab, scal,
            u, dep, prev_state, nee=nee, t_min=T_MIN, features=features, mesh=mesh,
            medium_g=medium_g, vol_nee=vol_nee,
        )
        rad_inc, alive, thr, o, d, prev_state = step_update(
            out, o, d, thr, prev_state, alive, dep, rr=rr, rr_start=rr_start
        )
        # each lane once: the same single add per bounce as a full-size sum
        radiance = radiance.index_add(0, lanes, torch.stack(rad_inc, dim=-1))
        keep = alive.nonzero()[:, 0]
        lanes, alive, prev_state = lanes[keep], alive[keep], prev_state[keep]
        o, d, thr, sigma_a = (tuple(c[keep] for c in v) for v in (o, d, thr, out["out_ma"]))
        sigma_s = out["out_ms"][keep]
        medium_g = out["out_mg"][keep] if "out_mg" in out else None
    return radiance, nrays


def _lib():
    lib = _build.load("trace")
    fn = lib.trace_launch
    if fn.argtypes is None:  # without argtypes ctypes would cut pointers to 32 bits
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int,  # geom table, G
            ctypes.c_void_p, ctypes.c_int,  # material table, M
            ctypes.c_void_p, ctypes.c_void_p,  # light table, scalars
            ctypes.c_uint,  # seed
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # origin, dir, sample
            ctypes.c_int,  # n
            ctypes.c_void_p, ctypes.c_void_p,  # radiance, nrays
            ctypes.c_void_p,  # the schedule's lane counter
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # depth, nee, rr, rr_start
            *MEDIA_ARGTYPES, SURF_ARGTYPE,
            *MESH_ARGTYPES,
            ctypes.c_int,  # device
            ctypes.c_int,  # blocks of the persistent grid (0: the resident count)
            ctypes.c_void_p,  # stream
        ]
    return fn


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of that dtype, shape and
    device: what a kernel launcher takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(gtab, mtab, ltab, scal, sample_idx, n: int, device):
    """The checks every trace kernel launcher shares: the packed tables
    within the shared-memory caps, the lane count, and the sample indices
    as the kernels take them (their uint32 bits as int32).  Returns
    ``(G, M, sample bits)``."""
    if device.type != "cuda":
        raise ValueError(f"trace kernels need CUDA tensors, got {device}")
    if 3 * n >= 2**31:  # the kernels index the [N, 3] planes with 32-bit ints
        raise ValueError(f"trace kernels take fewer than {2**31 // 3} rays, got {n}")
    g, m = gtab.shape[0], mtab.shape[0]
    if not 1 <= g <= MAX_GEOMS or not 1 <= m <= MAX_MATERIALS:
        raise ValueError(
            f"trace kernels take 1..{MAX_GEOMS} geoms and 1..{MAX_MATERIALS} "
            f"materials, got {g} and {m}"
        )
    f32 = torch.float32
    check_tensor(gtab, "geom table", f32, (g, GEOM_COLS), device)
    check_tensor(mtab, "material table", f32, (m, MAT_COLS), device)
    check_tensor(ltab, "light table", f32, (g, LIGHT_COLS), device)
    check_tensor(scal, "scalars", f32, (2,), device)
    bits = ((sample_bits(sample_idx) ^ 0x80000000) - 0x80000000).to(torch.int32)
    check_tensor(bits, "sample_idx", torch.int32, (n,), device)
    return g, m, bits


def trace_cuda(
    gtab, mtab, ltab, scal, seed: int, origin, direction, sample_idx,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int, mesh=None,
    features=frozenset(), vol_nee: bool = True, blocks: int = 0,
):
    """Launch the trace kernel: ``(radiance [N, 3], rays_traced int64 [])``
    on the rays' CUDA device, on the current stream.  The tables are those
    of :func:`pack_tables`, which checks the material ids; ``mesh`` the
    scene's in-kernel triangle tables or None; ``features`` picks the
    media instance (:func:`media_args`) and the surface blocks
    (:func:`surface_bits`).  ``blocks`` sizes the persistent grid: 0 takes
    the blocks resident at once, a positive count forces a smaller grid
    (the results are the same)."""
    global launches, mesh_launches, vol_launches, hg_launches, mesh_vol_launches, surf_launches
    check_features(features)
    device = origin.device
    n = origin.shape[0]
    g, m, bits = check_launch(gtab, mtab, ltab, scal, sample_idx, n, device)
    f32 = torch.float32
    check_tensor(origin, "origin", f32, (n, 3), device)
    check_tensor(direction, "direction", f32, (n, 3), device)

    radiance = torch.empty((n, 3), dtype=f32, device=device)
    # the ray count and the persistent schedule's lane counter, zeroed together
    nrays, lane_counter = torch.zeros(2, dtype=torch.int64, device=device)
    media = media_args(features, vol_nee)
    surf = surface_bits(features)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib()(
        gtab.data_ptr(), g, mtab.data_ptr(), m, ltab.data_ptr(), scal.data_ptr(),
        int(seed) & 0xFFFFFFFF,
        origin.data_ptr(), direction.data_ptr(), bits.data_ptr(), n,
        radiance.data_ptr(), nrays.data_ptr(), lane_counter.data_ptr(),
        int(max_depth), int(bool(nee)), int(bool(rr)), int(rr_start),
        *media, surf, *mesh_launch_args(mesh, device), device.index, int(blocks), stream,
    )
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {err}")
    if surf:
        surf_launches += 1
    elif mesh is not None and media[0]:
        mesh_vol_launches += 1
    elif mesh is not None:
        mesh_launches += 1
    elif media[1]:
        hg_launches += 1
    elif media[0]:
        vol_launches += 1
    else:
        launches += 1
    return radiance, nrays


def trace_fused(scene, rays, sample_idx, seed: int, cfg, tables=None):
    """The whole bounce loop for one wavefront: ``(radiance [N, 3],
    rays_traced int64 [])``.  ``tables`` are :func:`pack_tables` of the
    scene (packed here when not given)."""
    check_features(cfg.features)
    if not fused_trace_eligible(scene, cfg):
        raise NotImplementedError(
            "the one-kernel trace takes no image textures, no meshes above 4096 triangles "
            "(their scenes run the per-bounce scan, render/megakernel.trace_paths) and no "
            "fast_rng=False"
        )
    gtab, mtab, ltab, scal = tables if tables is not None else pack_tables(scene)
    kw = dict(
        max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
        rr_start=cfg.rr_start, mesh=scene.mesh_tables, features=frozenset(cfg.features),
        vol_nee=cfg.vol_nee,
    )
    args = (gtab, mtab, ltab, scal, seed, rays.origin, rays.direction, sample_idx)
    device_type = rays.origin.device.type
    if device_type == "cuda":
        return trace_cuda(*args, **kw)
    if device_type == "cpu":
        return trace_plain(*args, **kw)
    raise ValueError(f"no trace for device type {device_type!r}")
