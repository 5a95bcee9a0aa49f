"""Triangle-mesh intersection for the split route: kernels 9 and 10 with
their plain versions and dispatch, and the mesh winner of a wavefront.

Port of ``pathtracer_tpu/ops/mesh_pallas.py:39-54,118-181``
(``MESH_PALLAS_MAX_TRIS``, ``pack_tri_table``, ``mesh_nearest_pallas``,
``mesh_min_pallas``) and ``pathtracer_tpu/ops/intersect.py:376-498,679-739``
(``mesh_query``, ``mesh_occlusion_t``, ``mesh_only_hit``,
``mesh_only_occlusion``), and the mesh half of the lean route's detached
winner search (``intersect.py:808-826``, :func:`merge_mesh_winners`).

* Kernel 9, :func:`mesh_nearest`: each ray's nearest triangle ``t`` and
  index over a ``[T * 9]`` table of ``(v0, e1, e2)`` rows; kernel 10,
  :func:`mesh_min`: the nearest ``t`` alone, for shadow rays.  Both cull by
  chunk: the table's rows fall into chunks of :data:`SCAN_CHUNK` (the
  LBVH's where the mesh has one), and a lane tests a chunk's triangles only
  where its ray's slab interval meets the chunk's padded box
  (:func:`pad_boxes`, ``[C, 6]``) nearer than its running best times
  :data:`REACH_SLACK` (``ops/mesh_tables.chunk_reaches``).  The CUDA kernels
  are ``csrc/mesh.cu`` (shared-memory tiles, a block skips a chunk none of
  its lanes reaches); the plain versions (:func:`mesh_nearest_plain`,
  :func:`mesh_min_plain`) run ``ops/intersect.mt_chunk_t`` on each chunk,
  apply the same per-lane test and fold the chunk's first minimum into the
  running best under a strict ``<``, which equals the kernels' one
  triangle after another, so the two are equal on every lane.  With
  ``boxes=None`` both sweep every chunk: the dense sweep, the oracle that
  shows what culling changes (a hit so ill-conditioned that its ``t`` lies
  beyond the padded box; ``csrc/mesh.cu`` says why a well-conditioned hit
  cannot be culled).  JAX's CPU route for an LBVH mesh culls by chunk too
  (``ops/accel.mesh_t_and_normal_accel``).  A CUDA tensor launches the
  kernel or raises; a CPU tensor takes the plain version.
* :func:`mesh_query` / :func:`mesh_occlusion_t` take the kernels for
  meshes of at most :data:`MESH_KERNEL_MAX_TRIS` triangles, with the
  mesh's ``scan_table`` and ``scan_boxes``, and above that the LBVH
  traversal of ``ops/accel.py`` (``scene_for_frame`` builds an LBVH for
  every mesh of ``ACCEL_MIN_TRIS`` triangles or more).  Every path tests
  against ``T_MIN``, which the kernels hard-code.  A mesh's table is its
  scan order without the LBVH's pad rows: a pad row repeats the last
  triangle and cannot beat it under a strict ``<``, so the winners are
  those of the padded table.
* JAX guards both kernels with a ``lax.cond`` on whether any ray reaches
  the mesh's root box; that needs a host sync here, so the kernels launch
  unconditionally and each block skips the chunks it does not reach.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.accel import ACCEL_CHUNK, mesh_t_and_normal_accel
from pathtracer_tpu_torch.ops.intersect import (
    BIG,
    T_MIN,
    mesh_scan_verts,
    mesh_winner_attrs,
    mt_chunk_t,
    safe_recip,
    to_object,
    unit,
    winner_face_normal,
)
from pathtracer_tpu_torch.ops.mesh_tables import chunk_reaches
from pathtracer_tpu_torch.ops.trace import check_tensor

# kernels 9 and 10 take meshes up to this many triangles; larger ones take
# the LBVH traversal, as in JAX
MESH_KERNEL_MAX_TRIS = 8192
SCAN_CHUNK = ACCEL_CHUNK  # table rows per culling chunk (csrc/mesh.cu SCAN_CHUNK)
REACH_SLACK = 1.000001  # a chunk's entry may round up to the running best (float32)
BOX_PAD = 1e-5  # of a box's largest extent plus its largest |coordinate|

nearest_launches = 0  # launches of csrc/mesh.cu's kernel 9 (culled) in this process
min_launches = 0  # launches of kernel 10 (culled)
dense_launches = 0  # launches of either without boxes: the dense oracle, off the main path

P, I = ctypes.c_void_p, ctypes.c_int


def pack_tri_table(tri_verts: torch.Tensor) -> torch.Tensor:
    """``[T, 3, 3]`` corners -> flat ``[T * 9]`` ``(v0, e1, e2)`` table."""
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    return torch.cat([v0, e1, e2], dim=-1).reshape(-1).contiguous()


def pad_boxes(lo, hi) -> torch.Tensor:
    """``[C, 6]`` chunk boxes (lo, hi) widened on every side by
    :data:`BOX_PAD` of the box's largest extent plus its largest
    ``|coordinate|``, detached float32: the boxes kernels 9 and 10 cull
    with (``csrc/mesh.cu`` says why the margin covers a well-conditioned
    hit)."""
    lo, hi = lo.detach().float(), hi.detach().float()
    scale = torch.amax(hi - lo, dim=-1) + torch.amax(torch.maximum(lo.abs(), hi.abs()), dim=-1)
    pad = (BOX_PAD * scale)[:, None]
    return torch.cat([lo - pad, hi + pad], dim=-1).contiguous()


def table_boxes(table) -> torch.Tensor:
    """The padded boxes (:func:`pad_boxes`) of a ``[T * 9]`` table's rows in
    chunks of :data:`SCAN_CHUNK`, over the corners ``v0``, ``v0 + e1``,
    ``v0 + e2``."""
    rows = table.detach().view(-1, 9)
    v0 = rows[:, 0:3]
    corners = torch.stack([v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]], dim=1)
    lo = torch.stack([c.amin(dim=(0, 1)) for c in corners.split(SCAN_CHUNK)])
    hi = torch.stack([c.amax(dim=(0, 1)) for c in corners.split(SCAN_CHUNK)])
    return pad_boxes(lo, hi)


def mesh_chunk_boxes(m, pad: bool = True) -> torch.Tensor:
    """One mesh's chunk boxes over its scan order: the LBVH's chunk boxes
    where it has one (rebound to the live vertices by ``ops/accel.
    refresh_accel``), else boxes of :data:`SCAN_CHUNK` file-order
    triangles; padded (:func:`pad_boxes`) or the bare ``[C, 6]`` boxes."""
    if m.accel is not None:
        lo, hi = m.accel.lo, m.accel.hi
    else:
        chunks = m.tri_verts.detach().float().split(SCAN_CHUNK)
        lo = torch.stack([c.amin(dim=(0, 1)) for c in chunks])
        hi = torch.stack([c.amax(dim=(0, 1)) for c in chunks])
    return pad_boxes(lo, hi) if pad else torch.cat([lo.float(), hi.float()], dim=-1)


def _scan(table, boxes, o_obj, d_obj, with_index: bool):
    """The plain sweep of kernels 9 (``with_index``) and 10: per chunk of
    :data:`SCAN_CHUNK` rows, Moeller-Trumbore of every lane, and where
    ``boxes`` are given only the lanes whose ray reaches the chunk's box
    (tested before the chunk, against the running best) take its first
    minimum under a strict ``<``."""
    rows = table.view(-1, 9)
    n = o_obj.shape[0]
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o_obj.device)
    best_i = torch.zeros(n, dtype=torch.int32, device=o_obj.device)
    o, inv = o_obj.unbind(-1), tuple(safe_recip(c) for c in d_obj.unbind(-1))
    slack = torch.tensor(REACH_SLACK, dtype=torch.float32, device=o_obj.device)
    for c, b in enumerate(range(0, rows.shape[0], SCAN_CHUNK)):
        r = rows[b:b + SCAN_CHUNK]
        t_c = mt_chunk_t(o_obj, d_obj, r[:, 0:3], r[:, 3:6], r[:, 6:9], T_MIN)
        if with_index:
            t_b, i_b = torch.min(t_c, dim=-1)
            better = t_b < best_t
        else:
            t_b = torch.minimum(best_t, torch.amin(t_c, dim=-1))
            better = torch.ones_like(best_t, dtype=torch.bool)
        if boxes is not None:
            better = better & chunk_reaches(boxes[c].unbind(-1), o, inv, best_t * slack)
        best_t = torch.where(better, t_b, best_t)
        if with_index:
            best_i = torch.where(better, (b + i_b).to(torch.int32), best_i)
    return best_t, best_i


def mesh_nearest_plain(table, boxes, o_obj, d_obj):
    """Plain version of kernel 9: ``(t [N] float32, index [N] int32)``,
    BIG and index 0 on a miss; ``boxes`` None sweeps every chunk."""
    return _scan(table, boxes, o_obj, d_obj, True)


def mesh_min_plain(table, boxes, o_obj, d_obj):
    """Plain version of kernel 10: each ray's nearest ``t`` (BIG = clear);
    ``boxes`` None sweeps every chunk."""
    return _scan(table, boxes, o_obj, d_obj, False)[0]


def _lib():
    lib = _build.load("mesh")
    if lib.mesh_nearest_launch.argtypes is None:  # ctypes would cut pointers to 32 bits
        lib.mesh_nearest_launch.restype = ctypes.c_int
        # table, T, boxes, n, o_obj, d_obj, t, index, stream
        lib.mesh_nearest_launch.argtypes = [P, I, P, I, P, P, P, P, P]
        lib.mesh_min_launch.restype = ctypes.c_int
        # table, T, boxes, n, o_obj, d_obj, t, stream
        lib.mesh_min_launch.argtypes = [P, I, P, I, P, P, P, P]
    return lib


def _check(table, boxes, o_obj, d_obj):
    device = o_obj.device
    if device.type != "cuda":
        raise ValueError(f"mesh kernels need CUDA tensors, got {device}")
    n, n_tris = o_obj.shape[0], table.shape[0] // 9
    if 3 * n >= 2**31:  # the kernels index the [N, 3] planes with 32-bit ints
        raise ValueError(f"mesh kernels take fewer than {2**31 // 3} rays, got {n}")
    if not 1 <= n_tris <= MESH_KERNEL_MAX_TRIS:
        raise ValueError(f"mesh kernels take 1..{MESH_KERNEL_MAX_TRIS} triangles, got {n_tris}")
    check_tensor(table, "triangle table", torch.float32, (n_tris * 9,), device)
    if boxes is not None:
        check_tensor(boxes, "chunk boxes", torch.float32, (-(-n_tris // SCAN_CHUNK), 6), device)
    check_tensor(o_obj, "origin", torch.float32, (n, 3), device)
    check_tensor(d_obj, "direction", torch.float32, (n, 3), device)
    return n, n_tris, device


def _count(boxes, kernel: str) -> None:
    global nearest_launches, min_launches, dense_launches
    if boxes is None:
        dense_launches += 1
    elif kernel == "nearest":
        nearest_launches += 1
    else:
        min_launches += 1


def mesh_nearest_cuda(table, boxes, o_obj, d_obj):
    """Launch kernel 9 on the rays' CUDA device, on the current stream
    (``boxes`` None: the dense sweep)."""
    n, n_tris, device = _check(table, boxes, o_obj, d_obj)
    t = torch.empty(n, dtype=torch.float32, device=device)
    idx = torch.empty(n, dtype=torch.int32, device=device)
    err = _lib().mesh_nearest_launch(
        table.data_ptr(), n_tris, None if boxes is None else boxes.data_ptr(), n,
        o_obj.data_ptr(), d_obj.data_ptr(), t.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mesh nearest kernel launch failed: CUDA error {err}")
    _count(boxes, "nearest")
    return t, idx


def mesh_min_cuda(table, boxes, o_obj, d_obj):
    """Launch kernel 10 on the rays' CUDA device, on the current stream
    (``boxes`` None: the dense sweep)."""
    n, n_tris, device = _check(table, boxes, o_obj, d_obj)
    t = torch.empty(n, dtype=torch.float32, device=device)
    err = _lib().mesh_min_launch(
        table.data_ptr(), n_tris, None if boxes is None else boxes.data_ptr(), n,
        o_obj.data_ptr(), d_obj.data_ptr(), t.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mesh min kernel launch failed: CUDA error {err}")
    _count(boxes, "min")
    return t


def _route(o_obj, kernel, plain):
    device_type = o_obj.device.type
    if device_type == "cuda":
        return kernel
    if device_type == "cpu":
        return plain
    raise ValueError(f"no mesh intersection for device type {device_type!r}")


def mesh_nearest(table, boxes, o_obj, d_obj):
    """Kernel 9 or its plain version, by the rays' device."""
    return _route(o_obj, mesh_nearest_cuda, mesh_nearest_plain)(table, boxes, o_obj, d_obj)


def mesh_min(table, boxes, o_obj, d_obj):
    """Kernel 10 or its plain version, by the rays' device."""
    return _route(o_obj, mesh_min_cuda, mesh_min_plain)(table, boxes, o_obj, d_obj)


# ---------------------------------------------------------------------------
# the split route's mesh winner
# ---------------------------------------------------------------------------


def _kernel_rows(m) -> int:
    """Rows of the mesh's scan order that its kernel table holds."""
    return m.accel.n_tris if m.accel is not None else m.tri_verts.shape[0]


def mesh_query(m, o_obj, d_obj, with_index=False):
    """Nearest triangle of one mesh for ``[N, 3]`` object-space rays:
    ``(t [N], n_obj [N, 3])`` with the winner's unnormalized face normal
    (BIG = miss), and with ``with_index`` its row in
    ``ops/intersect.mesh_scan_verts(m)``."""
    if _kernel_rows(m) <= MESH_KERNEL_MAX_TRIS:
        t, idx = mesh_nearest(m.scan_table, m.scan_boxes, o_obj.contiguous(),
                              d_obj.contiguous())
        nrm = winner_face_normal(mesh_scan_verts(m), idx)
        return (t, nrm, idx) if with_index else (t, nrm)
    if m.accel is None:
        raise ValueError(f"a mesh of {_kernel_rows(m)} triangles needs its LBVH "
                         "(scene_for_frame builds one)")
    return mesh_t_and_normal_accel(o_obj, d_obj, m.accel, T_MIN, with_index=with_index)


def mesh_occlusion_t(m, o_obj, d_obj):
    """Nearest ``t`` of one mesh for shadow rays (BIG = clear)."""
    if _kernel_rows(m) <= MESH_KERNEL_MAX_TRIS:
        return mesh_min(m.scan_table, m.scan_boxes, o_obj.contiguous(), d_obj.contiguous())
    return mesh_query(m, o_obj, d_obj)[0]


def object_rays(rays, gtab, g):
    """The rays in geom ``g``'s object space as two ``[N, 3]`` tensors."""
    obj = to_object(gtab[g].unbind(-1), *rays.origin.unbind(-1), *rays.direction.unbind(-1))
    return torch.stack(obj[:3], dim=-1), torch.stack(obj[3:], dim=-1)


def _world_normal_unit(m, n_obj):
    """``inv^T n`` normalized as ``transforms.transform_normal`` does."""
    n = torch.stack([m[0] * n_obj[:, 0] + m[4] * n_obj[:, 1] + m[8] * n_obj[:, 2],
                     m[1] * n_obj[:, 0] + m[5] * n_obj[:, 1] + m[9] * n_obj[:, 2],
                     m[2] * n_obj[:, 0] + m[6] * n_obj[:, 1] + m[10] * n_obj[:, 2]], dim=-1)
    return unit(n)


def mesh_only_hit(rays, gtab, meshes):
    """Nearest hit over the mesh instances only: ``(t [N], p_obj [N, 3],
    normal [N, 3] world unit, material_id [N] int32, geom_id [N] int32,
    uv [N, 2], uv_valid [N] bool)``, t >= BIG on a miss.  The geoms' inverse
    transforms and material ids are read from the geom table ``gtab``; a
    mesh with authored ``vn`` shades with its smooth normal.  ``uv`` is the
    winner's authored UV where its mesh has ``vt`` (a winning mesh without
    clears what an earlier one set)."""
    n = rays.origin.shape[0]
    f32 = dict(dtype=torch.float32, device=rays.origin.device)
    t = torch.full((n,), BIG, **f32)
    pobj = torch.zeros((n, 3), **f32)
    nrm = torch.zeros((n, 3), **f32)
    uv = torch.zeros((n, 2), **f32)
    uv_valid = torch.zeros(n, dtype=torch.bool, device=rays.origin.device)
    mid = torch.zeros(n, dtype=torch.int32, device=rays.origin.device)
    gid = torch.zeros(n, dtype=torch.int32, device=rays.origin.device)
    for m in meshes:
        g = m.geom_index
        o_obj, d_obj = object_rays(rays, gtab, g)
        mt, mn, mi = mesh_query(m, o_obj, d_obj, with_index=True)
        n_sm, m_uv = mesh_winner_attrs(m, o_obj, d_obj, mi)
        better = mt < t
        t_safe = torch.where(better, mt, 1.0)
        mpo = o_obj + t_safe[:, None] * d_obj
        mnw = _world_normal_unit(gtab[g], unit(mn) if n_sm is None else n_sm)
        b = better[:, None]
        t = torch.where(better, mt, t)
        pobj = torch.where(b, mpo, pobj)
        nrm = torch.where(b, mnw, nrm)
        mid = torch.where(better, gtab[g, 13].to(torch.int32), mid)
        gid = torch.where(better, g, gid)
        if m_uv is not None:
            uv = torch.where(b, m_uv, uv)
            uv_valid = uv_valid | better
        else:
            uv_valid = uv_valid & ~better
    return t, pobj, nrm, mid, gid, uv, uv_valid


def merge_mesh_winners(rays, gtab, meshes, t, gid):
    """The lean route's detached winner search over the meshes: each mesh's
    nearest triangle (kernel 9, or the LBVH traversal) merged into the
    analytic winner ``(t, gid)`` where it is nearer.  Returns ``(t, gid,
    mesh_idx)``, ``mesh_idx`` per mesh each lane's triangle row in
    ``ops/intersect.mesh_scan_verts`` order (whether or not it won)."""
    idx = []
    for m in meshes:
        o_obj, d_obj = object_rays(rays, gtab, m.geom_index)
        mt, _, mi = mesh_query(m, o_obj, d_obj, with_index=True)
        better = mt < t
        t = torch.where(better, mt, t)
        gid = torch.where(better, m.geom_index, gid)
        idx.append(mi)
    return t, gid, tuple(idx)


def mesh_only_occlusion(rays, gtab, meshes):
    """Nearest ``t`` per shadow ray over the mesh instances only."""
    t = torch.full((rays.origin.shape[0],), BIG, dtype=torch.float32, device=rays.origin.device)
    for m in meshes:
        o_obj, d_obj = object_rays(rays, gtab, m.geom_index)
        t = torch.minimum(t, mesh_occlusion_t(m, o_obj, d_obj))
    return t
