"""Analytic primitive intersection on component tensors.

Port of ``pathtracer_tpu/ops/intersect.py:37-111`` (``BIG``, ``T_MIN``,
``Hit``, ``sphere_t_planes``, ``cube_t_planes``) and
``pathtracer_tpu/ops/intersect_pallas.py:58-80,206-216`` (``_geom_t``,
``_pack_gdata``), with the plain versions of three TPU kernels of
``intersect_pallas.py``: :func:`nearest_hit_plain` (``_nearest_hit_kernel``,
``:92-148``: the nearest hit with its full record),
:func:`winner_t_gid_plain` (``_winner_kernel``, ``:151-170``: the winner's
``t`` and geom id only) and :func:`occlusion_t_plain` (``_occlusion_kernel``,
``:197-203``: a shadow ray's nearest ``t``), and :func:`occlusion_split_t`
(``intersect.py:742-762``: volumetric NEE's shadow ray, split into opaque
and refractive geoms).  The kernels' CUDA versions are
``csrc/intersect.cu`` (``ops/intersect_cuda.py``).  :func:`intersect_scene_lean`
ports ``pathtracer_tpu/ops/intersect.py:777-926``: the differentiable
recompute of the winner only, a mesh winner's triangle (:func:`mt_single`)
gathered from the file-order vertices so that their gradients land there;
:func:`replay_winner` is its search with the forward kernel's winner
replayed.  A geom's row is read as tensors, so ``t`` and the
object-space ray carry gradients to the geom table.  Unit primitives live in object space (sphere r = 0.5,
cube side 1) and are tested through the inverse transform; the
object-space direction stays unnormalized, so ``t`` is the world-space
distance.  A miss is ``BIG``.  The CUDA kernels (``csrc/trace_common.cuh``)
repeat this arithmetic in the same order.

The mesh half ports ``pathtracer_tpu/ops/intersect.py:236-270,307-373,
500-564``: :func:`mt_chunk_t` (Moeller-Trumbore of ``[N]`` rays against a
chunk of triangles, the formula of kernels 9 and 10),
:func:`winner_face_normal`, :func:`mesh_scan_verts` and
:func:`mesh_winner_attrs` (the authored smooth normal and UV at a winning
triangle).  The kernels' dispatch and the split route's
mesh winner are ``ops/mesh.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.ops.bsdf import gather_rows
from pathtracer_tpu_torch.scene.structs import CUBE, SPHERE, Geoms, Rays

BIG = 1e30  # miss sentinel (finite)
T_MIN = 1e-4  # min accepted hit distance

GEOM_COLS = 14  # inverse-transform rows 0..2 (12), type, material id


def safe_recip(x, eps=1e-12):
    return 1.0 / torch.where(
        torch.abs(x) < eps, torch.where(x >= 0, eps, -eps), x
    )


def sphere_t_planes(ox, oy, oz, dx, dy, dz, t_min=T_MIN):
    """Nearest t > t_min on the r = 0.5 object-space sphere, else BIG."""
    a = dx * dx + dy * dy + dz * dz
    b = ox * dx + oy * dy + oz * dz
    c = ox * ox + oy * oy + oz * oz - 0.25
    disc = b * b - a * c
    valid = disc > 0.0
    sq = torch.sqrt(torch.where(valid, disc, 1.0))
    inv_a = safe_recip(a)
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    t = torch.where(t0 > t_min, t0, t1)
    return torch.where(valid & (t > t_min), t, BIG)


def cube_t_planes(ox, oy, oz, dx, dy, dz, t_min=T_MIN):
    """Unit-cube slab test: nearest t > t_min, else BIG."""
    ix, iy, iz = safe_recip(dx), safe_recip(dy), safe_recip(dz)
    tlx, thx = (-0.5 - ox) * ix, (0.5 - ox) * ix
    tly, thy = (-0.5 - oy) * iy, (0.5 - oy) * iy
    tlz, thz = (-0.5 - oz) * iz, (0.5 - oz) * iz
    t_near = torch.maximum(
        torch.maximum(torch.minimum(tlx, thx), torch.minimum(tly, thy)),
        torch.minimum(tlz, thz),
    )
    t_far = torch.minimum(
        torch.minimum(torch.maximum(tlx, thx), torch.maximum(tly, thy)),
        torch.maximum(tlz, thz),
    )
    valid = (t_far >= t_near) & (t_far > t_min)
    t = torch.where(t_near > t_min, t_near, t_far)
    return torch.where(valid & (t > t_min), t, BIG)


def to_object(m, ox, oy, oz, dx, dy, dz):
    oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
    ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
    ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
    odx = m[0] * dx + m[1] * dy + m[2] * dz
    ody = m[4] * dx + m[5] * dy + m[6] * dz
    odz = m[8] * dx + m[9] * dy + m[10] * dz
    return oox, ooy, ooz, odx, ody, odz


def geom_t(grow, ox, oy, oz, dx, dy, dz, t_min, gtype):
    """Distance for one geom from its 14 table values, plus its
    object-space ray ``(oox, ooy, ooz, odx, ody, odz)``.

    ``grow`` is the geom's table row: a ``[14]`` tensor, 14 scalar tensors
    or 14 floats.  As tensors the distance and the object-space ray carry
    gradients to the row.  ``gtype`` is the geom type as a host number
    (a sweep reads the table's types once); the test dispatches on it."""
    m = grow.unbind(-1) if isinstance(grow, torch.Tensor) else grow
    obj = to_object(m, ox, oy, oz, dx, dy, dz)
    if gtype == float(SPHERE):
        t = sphere_t_planes(*obj, t_min)
    elif gtype == float(CUBE):
        t = cube_t_planes(*obj, t_min)
    else:  # mesh slots never hit in the analytic sweep
        t = torch.full_like(ox, BIG)
    return t, obj


def geom_t_lanes(rows, ox, oy, oz, dx, dy, dz, t_min=T_MIN):
    """:func:`geom_t` with a row per lane (14 ``[N]`` tensors, e.g. the
    winner's row gathered per lane): both primitives are tested and the
    lane's type selects, as ``intersect_pallas.py:_geom_t`` does."""
    obj = to_object(rows, ox, oy, oz, dx, dy, dz)
    ts = sphere_t_planes(*obj, t_min)
    tc = cube_t_planes(*obj, t_min)
    t = torch.where(
        rows[12] == float(SPHERE), ts, torch.where(rows[12] == float(CUBE), tc, BIG)
    )
    return t, obj


def pack_geom_table(geoms: Geoms) -> torch.Tensor:
    """``[G, 14]`` float32: inverse-transform rows 0..2, type, material id."""
    inv12 = geoms.inv_transform.reshape(geoms.count, 16)[:, :12]
    return torch.cat(
        [
            inv12,
            geoms.type.to(torch.float32)[:, None],
            geoms.material_id.to(torch.float32)[:, None],
        ],
        dim=-1,
    ).contiguous()


@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray nearest-hit record (``pathtracer_tpu/ops/intersect.py:42``)."""

    t: torch.Tensor  # [N] world-space distance; BIG on a miss
    hit: torch.Tensor  # [N] bool
    geom_id: torch.Tensor  # [N] int32 (0 on a miss)
    material_id: torch.Tensor  # [N] int32 (0 on a miss)
    position: torch.Tensor  # [N, 3] world hit point (o + d on a miss)
    position_obj: torch.Tensor  # [N, 3] hit point in the winner's object space
    normal: torch.Tensor  # [N, 3] world unit normal (zero on a miss)
    # [N, 2] a mesh winner's authored UV and [N] bool where it has one; None
    # when no mesh of the scene has authored UVs
    uv: torch.Tensor | None = None
    uv_valid: torch.Tensor | None = None


def sweep(gtab, o, d, t_min=T_MIN):
    """Nearest hit over every geom row of ``gtab`` for the ray planes ``o``,
    ``d`` (3-tuples of ``[N]``): ``(best_t, gid int64, winner's object-space
    ray as 6 planes)``.  Strict ``t < best`` keeps the first minimum; a miss
    keeps ``BIG``, geom 0 and a zero object ray.  The rows are read as
    tensors, so ``best_t`` and the object ray carry gradients to the table."""
    gtypes = gtab[:, 12].tolist()  # host-side types: the sweep dispatches on them
    best_t = torch.full_like(o[0], BIG)
    gid = torch.zeros(o[0].shape, dtype=torch.int64, device=o[0].device)
    w = [torch.zeros_like(o[0]) for _ in range(6)]
    for g, row in enumerate(gtab.unbind(0)):
        t_g, obj = geom_t(row, *o, *d, t_min, gtypes[g])
        better = t_g < best_t
        best_t = torch.where(better, t_g, best_t)
        gid = torch.where(better, g, gid)
        w = [torch.where(better, ob, prev) for ob, prev in zip(obj, w)]
    return best_t, gid, w


def object_normal(sph, p_obj):
    """Object-space normal at ``p_obj``: radial on spheres (``sph``), the
    argmax-|coord| face on cubes."""
    axx, axy, axz = (torch.abs(c) for c in p_obj)
    fx = (axx >= axy) & (axx >= axz)
    fy = (~fx) & (axy >= axz)
    inv_len = torch.rsqrt(torch.clamp(
        p_obj[0] * p_obj[0] + p_obj[1] * p_obj[1] + p_obj[2] * p_obj[2], min=1e-24))
    return (
        torch.where(sph, p_obj[0] * inv_len, torch.where(fx, torch.sign(p_obj[0]), 0.0)),
        torch.where(sph, p_obj[1] * inv_len, torch.where(fy, torch.sign(p_obj[1]), 0.0)),
        torch.where(
            sph, p_obj[2] * inv_len, torch.where((~fx) & (~fy), torch.sign(p_obj[2]), 0.0)
        ),
    )


def world_normal(m, n_obj):
    """The winner's inverse-transpose applied to ``n_obj`` and normalized
    (``m``: the winner's 14 table values per lane)."""
    n = (
        m[0] * n_obj[0] + m[4] * n_obj[1] + m[8] * n_obj[2],
        m[1] * n_obj[0] + m[5] * n_obj[1] + m[9] * n_obj[2],
        m[2] * n_obj[0] + m[6] * n_obj[1] + m[10] * n_obj[2],
    )
    inv = torch.rsqrt(torch.clamp(n[0] * n[0] + n[1] * n[1] + n[2] * n[2], min=1e-24))
    return (n[0] * inv, n[1] * inv, n[2] * inv)


def nearest_hit_plain(rays: Rays, gtab: torch.Tensor) -> Hit:
    """Plain version of kernel 6 (``csrc/intersect.cu:nearest_kernel``):
    the sweep, then the hit frame from the winner's row, gathered per lane
    (the TPU kernel's second where-pass over the geoms)."""
    o, d = rays.origin.unbind(-1), rays.direction.unbind(-1)
    best_t, gid, w = sweep(gtab, o, d)
    win = gtab[gid].unbind(-1)
    hit = best_t < BIG
    t_safe = torch.where(hit, best_t, 1.0)
    p = tuple(oc + t_safe * dc for oc, dc in zip(o, d))
    p_obj = (w[0] + t_safe * w[3], w[1] + t_safe * w[4], w[2] + t_safe * w[5])
    normal = world_normal(win, object_normal(hit & (win[12] == float(SPHERE)), p_obj))
    return Hit(
        t=best_t,
        hit=hit,
        geom_id=gid.to(torch.int32),
        material_id=torch.where(hit, win[13], 0.0).to(torch.int32),
        position=torch.stack(p, dim=-1),
        position_obj=torch.stack(p_obj, dim=-1),
        normal=torch.stack(normal, dim=-1),
    )


def occlusion_t_plain(rays: Rays, gtab: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8 (``csrc/intersect.cu:occlusion_kernel``):
    each shadow ray's nearest ``t`` over every geom (``BIG`` = clear)."""
    o, d = rays.origin.unbind(-1), rays.direction.unbind(-1)
    gtypes = gtab[:, 12].tolist()
    best_t = torch.full_like(o[0], BIG)
    for g, row in enumerate(gtab.unbind(0)):
        best_t = torch.minimum(best_t, geom_t(row, *o, *d, T_MIN, gtypes[g])[0])
    return best_t


def occlusion_split_t(rays: Rays, gtab: torch.Tensor, mtab: torch.Tensor, meshes=()):
    """``(t_opaque [N], t_refractive [N])``: each shadow ray's nearest
    ``t`` over the geoms whose material is not refractive, and over those
    whose material is (``BIG`` = none); port of
    ``pathtracer_tpu/ops/intersect.py:742-762``.  Volumetric NEE lets
    refractive interfaces bound the attenuated segment instead of blocking.
    ``mtab`` is the packed material table.  JAX computes it in plain XLA,
    so the analytic geoms here are plain PyTorch on every device; each mesh
    instance of ``meshes`` takes its kernel-10 minimum (``ops/mesh.
    mesh_occlusion_t``), split by its material."""
    o, d = rays.origin.unbind(-1), rays.direction.unbind(-1)
    gtypes = gtab[:, 12].tolist()
    refr = (mtab[gtab[:, 13].long(), 7] > 0.0).tolist()
    t_op = torch.full_like(o[0], BIG)
    t_re = torch.full_like(o[0], BIG)
    for g, row in enumerate(gtab.unbind(0)):
        t_g = geom_t(row, *o, *d, T_MIN, gtypes[g])[0]
        if refr[g]:
            t_re = torch.minimum(t_re, t_g)
        else:
            t_op = torch.minimum(t_op, t_g)
    if meshes:
        # ops/mesh imports this module
        from pathtracer_tpu_torch.ops.mesh import mesh_occlusion_t, object_rays

        for m in meshes:
            mt = mesh_occlusion_t(m, *object_rays(rays, gtab, m.geom_index))
            if refr[m.geom_index]:
                t_re = torch.minimum(t_re, mt)
            else:
                t_op = torch.minimum(t_op, mt)
    return t_op, t_re


def winner_t_gid_plain(rays: Rays, gtab: torch.Tensor):
    """Plain version of kernel 7 (``csrc/intersect.cu:winner_kernel``): the
    sweep's winner, ``(t [N] float32, gid [N] int32)``.  Strict ``t < best``
    keeps the first minimum; a miss gives ``BIG`` and geom 0, as
    ``_winner_kernel`` and ``jnp.argmin`` do."""
    o, d = rays.origin.unbind(-1), rays.direction.unbind(-1)
    gtypes = gtab[:, 12].tolist()
    best_t = torch.full_like(o[0], BIG)
    gid = torch.zeros(o[0].shape, dtype=torch.int32, device=o[0].device)
    for g, row in enumerate(gtab.unbind(0)):
        t_g = geom_t(row, *o, *d, T_MIN, gtypes[g])[0]
        better = t_g < best_t
        best_t = torch.where(better, t_g, best_t)
        gid = torch.where(better, g, gid)
    return best_t, gid


def intersect_scene_lean(rays: Rays, gtab: torch.Tensor, winner=None, meshes=()) -> Hit:
    """Nearest hit whose backward costs O(N), not O(N G + N T): a detached
    winner search, then the differentiable recompute of the winner only
    (``pathtracer_tpu/ops/intersect.py:777-926``).  ``winner`` is the
    search's ``(t, gid[, mesh_idx])`` when the caller ran it (kernel 7 and
    kernel 9 or the LBVH per mesh on the card, ``ops/mesh.
    merge_mesh_winners``); without it the plain search runs
    on detached inputs.  ``mesh_idx`` holds, per mesh of ``meshes``, each
    lane's nearest triangle (a row of ``mesh_scan_verts``).

    Equal to the sweep a.e.; cotangents reach the winner's geom row, the
    ray and, on a mesh winner, the winning triangle's vertices in file order
    (the scan-to-file permutation is applied to the table, so the gather's
    backward adds them back to ``tri_verts``).  The winner's row and
    triangle are gathered per lane (JAX: one-hot matmuls of the same
    values).  Where the recompute disagrees with the search about hitting
    at all, the detached ``t`` of the search stands (``:882-884``).  A miss
    keeps geom 0's row and material, as JAX's argmin does.  A mesh winner
    shades with its face normal, as JAX's recompute does: authored normals
    and UVs do not enter the lean route."""
    if winner is None:
        from pathtracer_tpu_torch.ops.mesh import merge_mesh_winners  # ops/mesh imports this module

        rays_d, gtab_d = Rays(rays.origin.detach(), rays.direction.detach()), gtab.detach()
        winner = merge_mesh_winners(rays_d, gtab_d, meshes, *winner_t_gid_plain(rays_d, gtab_d))
    t_win, gid = winner[0], winner[1]
    mesh_idx = winner[2] if len(winner) > 2 else ()
    hit = t_win < BIG
    rows = gather_rows(gtab, gid).unbind(-1)
    o, d = rays.origin.unbind(-1), rays.direction.unbind(-1)
    obj = to_object(rows, *o, *d)
    is_sphere = rows[12] == float(SPHERE)
    ts = sphere_t_planes(*obj)
    tc = cube_t_planes(*obj)
    t_re = torch.where(is_sphere, ts, torch.where(rows[12] == float(CUBE), tc, BIG))
    mesh_normals = []
    if meshes:
        o_obj, d_obj = torch.stack(obj[:3], dim=-1), torch.stack(obj[3:], dim=-1)
        for m, idx in zip(meshes, mesh_idx):
            verts = m.tri_verts
            if m.accel is not None:
                verts = torch.index_select(verts, 0, m.accel.scan_to_file.long())
            tri = gather_rows(verts, idx)
            mt_re, mn = mt_single(o_obj, d_obj, tri)
            sel = gid == m.geom_index
            t_re = torch.where(sel, mt_re, t_re)
            mesh_normals.append((sel, mn))
    t = torch.where(t_re < BIG, t_re, t_win)
    t_safe = torch.where(hit, t, 1.0)
    p = tuple(oc + t_safe * dc for oc, dc in zip(o, d))
    p_obj = (obj[0] + t_safe * obj[3], obj[1] + t_safe * obj[4], obj[2] + t_safe * obj[5])
    n_obj = object_normal(is_sphere, p_obj)
    for sel, mn in mesh_normals:
        inv_len = torch.rsqrt(torch.clamp(torch.sum(mn * mn, dim=-1), min=1e-24))
        n_obj = tuple(torch.where(sel, mn[:, k] * inv_len, n_obj[k]) for k in range(3))
    normal = world_normal(rows, n_obj)
    return Hit(
        t=t,
        hit=hit,
        geom_id=gid,
        material_id=rows[13].to(torch.int32),
        position=torch.stack(p, dim=-1),
        position_obj=torch.stack(p_obj, dim=-1),
        normal=torch.stack(normal, dim=-1),
    )


def replay_winner(rays: Rays, gtab: torch.Tensor, found, gid) -> tuple:
    """The lean search's ``(t, gid)`` with a replayed winner: ``gid`` [N]
    is the geom the forward kernel hit (-1: a miss), ``found`` the detached
    search's own ``(t, gid)`` on the same rays.  The replayed geom stands,
    geom 0 on a miss, as the search's argmin.  Its ``t`` is the search's
    where the search found that geom, else the geom's own distance on the
    detached rays taken as a grazing ray's: the sphere's discriminant
    clamped at 0 and the cube's slabs unordered, so that a replayed hit
    whose re-trace arithmetic misses it still gets a finite ``t`` (the one
    :func:`intersect_scene_lean` keeps where its recompute misses), never
    ``BIG``."""
    hit = gid >= 0
    g = torch.where(hit, gid.long(), 0)
    rows = gtab[g].unbind(-1)
    ox, oy, oz, dx, dy, dz = to_object(rows, *rays.origin.unbind(-1),
                                       *rays.direction.unbind(-1))
    a = dx * dx + dy * dy + dz * dz
    b = ox * dx + oy * dy + oz * dz
    sq = torch.sqrt(torch.clamp(b * b - a * (ox * ox + oy * oy + oz * oz - 0.25), min=0.0))
    inv_a = safe_recip(a)
    t0, t1 = (-b - sq) * inv_a, (-b + sq) * inv_a
    t_sphere = torch.where(t0 > T_MIN, t0, t1)
    ix, iy, iz = safe_recip(dx), safe_recip(dy), safe_recip(dz)
    slabs = [torch.stack([(-0.5 - oc) * ic, (0.5 - oc) * ic])
             for oc, ic in ((ox, ix), (oy, iy), (oz, iz))]
    t_near = torch.amax(torch.stack([torch.amin(s, 0) for s in slabs]), 0)
    t_far = torch.amin(torch.stack([torch.amax(s, 0) for s in slabs]), 0)
    t_cube = torch.where(t_near > T_MIN, t_near, t_far)
    t_own = torch.clamp(torch.where(rows[12] == float(SPHERE), t_sphere, t_cube), min=T_MIN)
    same = (found[1].long() == g) & (found[0] < BIG)
    t = torch.where(same, found[0], t_own)
    return torch.where(hit, t, BIG), g.to(torch.int32)


def mt_single(o_obj, d_obj, tri, t_min=T_MIN):
    """Differentiable Moeller-Trumbore of ray ``i`` against triangle ``i``
    (``pathtracer_tpu/ops/intersect.py:636-660``): ``tri`` ``[N, 3, 3]``;
    returns ``(t [N], unnormalized face normal [N, 3])``, BIG on a miss."""
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    h = torch.linalg.cross(d_obj, e2, dim=-1)
    a = torch.sum(e1 * h, dim=-1)
    f = safe_recip(a)
    s = o_obj - v0
    u = f * torch.sum(s * h, dim=-1)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = f * torch.sum(d_obj * q, dim=-1)
    t = f * torch.sum(e2 * q, dim=-1)
    ok = (torch.abs(a) > 1e-12) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (
        t > t_min)
    return torch.where(ok, t, BIG), torch.linalg.cross(e1, e2, dim=-1)


# ---------------------------------------------------------------------------
# triangle meshes (the split route)
# ---------------------------------------------------------------------------


def mt_chunk_t(o_obj, d_obj, cv0, ce1, ce2, t_min=T_MIN):
    """Moeller-Trumbore distances ``[N rays, C triangles]`` (BIG = miss) of
    ``[N, 3]`` object-space rays against triangles given as ``v0``, ``e1 =
    v1 - v0``, ``e2 = v2 - v0`` (``[C, 3]`` each); a near-zero determinant
    (below 1e-12) misses."""
    return mt_planes(o_obj.unbind(-1), d_obj.unbind(-1), cv0, ce1, ce2, t_min)[0]


def mt_planes(o, d, cv0, ce1, ce2, t_min=T_MIN):
    """:func:`mt_chunk_t` on ray planes (3-tuples of ``[N]``): ``(t, u, v)``,
    each ``[N, C]``, with the barycentrics ``u``, ``v`` of every pair."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    v0x, v0y, v0z = (cv0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (ce1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (ce2[None, :, i] for i in range(3))
    hx = dy * e2z - dz * e2y  # h = d x e2
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = safe_recip(a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y  # q = s x e1
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = (torch.abs(a) > 1e-12) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (
        t > t_min)
    return torch.where(ok, t, BIG), u, v


def winner_face_normal(scan_verts, best_i):
    """Unnormalized face normal ``cross(v1 - v0, v2 - v0)`` of each lane's
    winning row of ``scan_verts`` (``[T, 3, 3]``)."""
    tri = gather_rows(scan_verts, best_i)
    return torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)


def mesh_scan_verts(m) -> torch.Tensor:
    """The triangles, ``[T', 3, 3]``, that a mesh's winner indices refer to:
    the LBVH's Morton scan order for meshes with one, else file order."""
    if m.accel is not None:
        return m.accel.chunks.reshape(-1, 3, 3)
    return m.tri_verts


def unit(v):
    """``v / max(|v|, 1e-12)`` along the last axis, as ``jnp.linalg.norm``."""
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-12)


def mesh_winner_attrs(m, o_obj, d_obj, best_i):
    """The authored attributes at each lane's winning triangle ``best_i``
    (a scan-order row): ``(n_sm, uv)``, the smooth normal (object space,
    unit; None for a mesh without ``vn``) and the UV ``[N, 2]`` (None for
    a mesh without ``vt``).  The barycentrics are recomputed against the
    winner alone and clipped to [0, 1]; the scan-to-file permutation is
    applied to the tables, and each lane's row is gathered with
    ``ops/bsdf.gather_rows``."""
    if not m.has_attrs:
        return None, None
    idx = best_i.long()
    verts, norms, uvs = m.tri_verts, m.tri_norm, m.tri_uv
    if m.accel is not None:
        perm = m.accel.scan_to_file.long()
        verts = verts[perm]
        norms = None if norms is None else norms[perm]
        uvs = None if uvs is None else uvs[perm]
    tri = gather_rows(verts, idx)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    h = torch.linalg.cross(d_obj, e2, dim=-1)
    f = safe_recip(torch.sum(e1 * h, dim=-1))
    s = o_obj - v0
    u = torch.clamp(f * torch.sum(s * h, dim=-1), 0.0, 1.0)
    q = torch.linalg.cross(s, e1, dim=-1)
    v = torch.clamp(f * torch.sum(d_obj * q, dim=-1), 0.0, 1.0)
    w0 = torch.clamp(1.0 - u - v, 0.0, 1.0)

    def blend(table):
        c = torch.index_select(table, 0, idx)
        return w0[:, None] * c[:, 0] + u[:, None] * c[:, 1] + v[:, None] * c[:, 2]

    return (None if norms is None else unit(blend(norms)),
            None if uvs is None else blend(uvs))
