"""The in-kernel triangle sweep of kernels 1 and 2: its tables and its plain
version.

Port of ``pathtracer_tpu/ops/bounce_pallas.py:196-501``
(``MESH_INKERNEL_MAX_TRIS``, ``mesh_inkernel_eligible``, ``MESH_CHUNK``,
``_morton3_jnp``, ``pack_mesh_tables``, ``_chunk_cull_loop``,
``mesh_sweep_planes``, ``mesh_occ_planes``, ``mesh_occ_split_planes``).
Scenes whose meshes total at
most :data:`MESH_INKERNEL_MAX_TRIS` triangles trace them inside the trace
kernel (``csrc/trace.cu``) and the per-bounce kernel (``csrc/bounce.cu``),
both through ``csrc/trace_common.cuh:mesh_sweep`` / ``mesh_occ`` /
``mesh_occ_split``.

Tables, per mesh as :func:`pack_mesh_tables` builds them (JAX's arrays,
element for element): triangles sorted by the Morton code of their float32
centroid (stable), padded to a multiple of :data:`MESH_CHUNK` with copies of
the last one; ``[Tp * 12]`` rows ``(v0, e1, e2, cross(e1, e2))``, ``[C * 6]``
chunk boxes ``(lo, hi)``, ``[Tp * 9]`` corner normals when the mesh has
authored ``vn`` and ``[Tp * 6]`` corner UVs when it has authored ``vt``.
:func:`kernel_meshes` concatenates every mesh's tables for a launch, with one
descriptor row per mesh ``(geom index, chunks, first chunk, has normals, has
UVs)``.

The sweep: per mesh, the ray in the geom's object space; per chunk, the
slab test of its box against the lane's current best; per triangle of a
chunk that passes, Moeller-Trumbore and a strict ``t < best`` update of the
winner's distance, object-space point, world normal (the clipped
barycentric blend of the corner normals, or the face normal, through the
geom's inverse transpose; normalized once after the loop) and material,
and with ``want_uv`` (kernel 2m's deferred texel, ``bounce_pallas.py:430-473``)
the clipped barycentric blend of the winner's corner UVs and whether its
mesh has them.  The shadow ray keeps the minimum ``t`` alone.  JAX skips a chunk when no
lane of its TPU tile reaches the box; here each lane makes that test for
itself, in the kernel as in :func:`mesh_sweep` and :func:`mesh_occ`, so the
kernels equal these plain versions on every lane.  A chunk box contains its
triangles, so the two agree up to a hit a rounding below its box's entry.
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.ops.intersect import BIG, T_MIN, mt_planes, safe_recip, to_object

MESH_INKERNEL_MAX_TRIS = 4096  # total triangles the in-kernel sweep takes
MESH_CHUNK = 32  # triangles per culling chunk


def mesh_inkernel_eligible(meshes) -> bool:
    """True when the scene has meshes and they total at most
    :data:`MESH_INKERNEL_MAX_TRIS` triangles."""
    return bool(meshes) and sum(m.tri_verts.shape[0] for m in meshes) <= MESH_INKERNEL_MAX_TRIS


def morton3(cent: torch.Tensor) -> torch.Tensor:
    """``[T, 3]`` float32 centroids -> 30-bit Morton codes (int32), on the
    centroids' own box, truncating the 10-bit cells as ``astype`` does."""
    lo = torch.amin(cent, dim=0)
    hi = torch.amax(cent, dim=0)
    ext = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((cent - lo) / ext * 1023.0, 0.0, 1023.0).to(torch.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def pack_mesh_tables(meshes):
    """Per mesh ``((geom_index, n_chunks, has_norm, has_uv), [tri, aabb(,
    norm)(, uv)])``: the flat float32 tables of
    ``bounce_pallas.pack_mesh_tables``.  Built from the vertices as they
    are, detached: the kernels take no gradients."""
    out = []
    for m in meshes:
        tv = m.tri_verts.detach().to(torch.float32)
        attrs = [a.detach().to(torch.float32) for a in (m.tri_norm, m.tri_uv) if a is not None]
        cent = (tv[:, 0] + tv[:, 1] + tv[:, 2]) / 3.0  # jnp.mean of three
        order = torch.argsort(morton3(cent), stable=True)
        tv, attrs = tv[order], [a[order] for a in attrs]
        pad = (-tv.shape[0]) % MESH_CHUNK
        if pad:
            tv, *attrs = (torch.cat([a, a[-1:].expand(pad, *a.shape[1:])], dim=0)
                          for a in (tv, *attrs))
        n_chunks = tv.shape[0] // MESH_CHUNK
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        tables = [torch.cat([tv[:, 0], e1, e2, _cross(e1, e2)], dim=-1).reshape(-1)]
        ch = tv.reshape(n_chunks, MESH_CHUNK * 3, 3)
        tables.append(torch.cat([torch.amin(ch, dim=1), torch.amax(ch, dim=1)], dim=-1).reshape(-1))
        tables += [a.reshape(-1) for a in attrs]
        desc = (int(m.geom_index), n_chunks, m.tri_norm is not None, m.tri_uv is not None)
        out.append((desc, tables))
    return out


@dataclasses.dataclass(frozen=True)
class KernelMeshes:
    """Every mesh's in-kernel tables, concatenated for one launch."""

    # per mesh (geom index, chunks, first chunk, has normals, has UVs), host ints
    descs: tuple
    desc: torch.Tensor  # [n_mesh, 5] int32: the same, on the tables' device
    tri: torch.Tensor  # [Tp * 12] (v0, e1, e2, face normal)
    aabb: torch.Tensor  # [C * 6] chunk boxes (lo, hi)
    norm: torch.Tensor  # [Tp * 9] corner normals, zeros for a mesh without vn
    uv: torch.Tensor  # [Tp * 6] corner UVs, zeros for a mesh without vt

    @property
    def has_uv(self) -> bool:
        """Some mesh has authored UVs (JAX's ``want_uv`` under image textures)."""
        return any(d[4] for d in self.descs)


def kernel_meshes(meshes):
    """:class:`KernelMeshes` of ``meshes``, or None when the in-kernel sweep
    does not take them (no meshes, or too many triangles)."""
    if not mesh_inkernel_eligible(meshes):
        return None
    descs, tri, aabb, norm, uv = [], [], [], [], []
    first = 0
    for (g, n_chunks, has_norm, has_uv), tables in pack_mesh_tables(meshes):
        descs.append((g, n_chunks, first, int(has_norm), int(has_uv)))
        tri.append(tables[0])
        aabb.append(tables[1])
        rows = n_chunks * MESH_CHUNK
        norm.append(tables[2] if has_norm else tables[0].new_zeros(rows * 9))
        uv.append(tables[-1] if has_uv else tables[0].new_zeros(rows * 6))
        first += n_chunks
    device = tri[0].device
    return KernelMeshes(
        descs=tuple(descs),
        desc=torch.tensor(descs, dtype=torch.int32, device=device),
        tri=torch.cat(tri).contiguous(),
        aabb=torch.cat(aabb).contiguous(),
        norm=torch.cat(norm).contiguous(),
        uv=torch.cat(uv).contiguous(),
    )


def chunk_reaches(box, oo, inv, best):
    """Per lane: the ray's slab interval meets the box nearer than ``best``
    (``csrc/trace_common.cuh:chunk_reaches``)."""
    t_lo, t_hi = [], []
    for ax in range(3):
        t1 = (box[ax] - oo[ax]) * inv[ax]
        t2 = (box[3 + ax] - oo[ax]) * inv[ax]
        t_lo.append(torch.minimum(t1, t2))
        t_hi.append(torch.maximum(t1, t2))
    tmin = torch.maximum(torch.maximum(t_lo[0], t_lo[1]), torch.clamp(t_lo[2], min=T_MIN))
    tmax = torch.minimum(torch.minimum(t_hi[0], t_hi[1]), t_hi[2])
    return (tmax >= tmin) & (tmin < best)


def _meshes(km: KernelMeshes, gtab, o, d):
    """Per mesh: its geom row, whether it has normals, its first row, its
    chunk boxes, the ray in its object space with the reciprocal direction,
    and every triangle's ``(t, u, v)`` as ``[N, chunks, MESH_CHUNK]``.  All
    triangles are tested at once; the chunk loop of the callers then keeps
    what the kernel's culled loop keeps (a culled chunk changes nothing)."""
    tri, aabb = km.tri.view(-1, 12), km.aabb.view(-1, 6)
    for g, n_chunks, first, has_norm, _ in km.descs:
        m = gtab[g].unbind(-1)
        obj = to_object(m, *o, *d)
        oo, od = obj[:3], obj[3:]
        inv = tuple(safe_recip(c) for c in od)
        tr = tri[first * MESH_CHUNK:(first + n_chunks) * MESH_CHUNK]
        tuv = tuple(x.view(-1, n_chunks, MESH_CHUNK)
                    for x in mt_planes(oo, od, tr[:, 0:3], tr[:, 3:6], tr[:, 6:9]))
        yield m, has_norm, first * MESH_CHUNK, aabb[first:first + n_chunks], oo, od, inv, tuv


def mesh_sweep(km: KernelMeshes, gtab, o, d, want_uv: bool = False) -> dict:
    """Plain version of the in-kernel sweep for the ray planes ``o``, ``d``:
    ``et`` (BIG = no triangle), ``epo`` (hit point in the mesh's object
    space), ``en`` (unit world normal), ``emid`` (int64 material id), and
    ``reached``, the chunks whose triangles the kernel tests for each lane
    (int64).  With ``want_uv`` also ``muv_u``, ``muv_v`` (the winner's
    authored UV; a winner whose mesh has none keeps the lane's earlier
    values, as JAX's) and ``muvv`` (1.0 where the winner's mesh has UVs)."""
    zero = torch.zeros_like(o[0])
    et = torch.full_like(o[0], BIG)
    epo, enw = (zero, zero, zero), (zero, zero, zero)
    uu, vv, uvv = zero, zero, zero
    emid = torch.zeros(o[0].shape, dtype=torch.int64, device=o[0].device)
    reached = torch.zeros_like(emid)
    uv_tab = km.uv.view(-1, 6)
    for (*_, has_uv), (m, has_norm, row0, boxes, oo, od, inv, (tc, u, v)) in zip(
            km.descs, _meshes(km, gtab, o, d)):
        t_min, j_min = torch.min(tc, dim=-1)  # per chunk the first minimum, as the strict < loop
        for c in range(boxes.shape[0]):
            t_c, j = t_min[:, c], j_min[:, c]
            reach = chunk_reaches(boxes[c].unbind(-1), oo, inv, et)
            reached = reached + reach
            better = reach & (t_c < et)
            row = row0 + c * MESH_CHUNK + j
            if has_norm or (want_uv and has_uv):
                uc = torch.clamp(u[:, c].gather(1, j[:, None])[:, 0], 0.0, 1.0)
                vc = torch.clamp(v[:, c].gather(1, j[:, None])[:, 0], 0.0, 1.0)
                w0 = torch.clamp(1.0 - uc - vc, 0.0, 1.0)
            if want_uv:
                if has_uv:
                    ur = torch.index_select(uv_tab, 0, row).unbind(-1)
                    uu = torch.where(better, w0 * ur[0] + uc * ur[2] + vc * ur[4], uu)
                    vv = torch.where(better, w0 * ur[1] + uc * ur[3] + vc * ur[5], vv)
                uvv = torch.where(better, float(has_uv), uvv)
            if has_norm:
                nr = torch.index_select(km.norm.view(-1, 9), 0, row).unbind(-1)
                n = tuple(w0 * nr[k] + uc * nr[3 + k] + vc * nr[6 + k] for k in range(3))
            else:
                n = torch.index_select(km.tri.view(-1, 12)[:, 9:12], 0, row).unbind(-1)
            nw = (m[0] * n[0] + m[4] * n[1] + m[8] * n[2],
                  m[1] * n[0] + m[5] * n[1] + m[9] * n[2],
                  m[2] * n[0] + m[6] * n[1] + m[10] * n[2])
            et = torch.where(better, t_c, et)
            epo = tuple(torch.where(better, a + t_c * b, p) for a, b, p in zip(oo, od, epo))
            enw = tuple(torch.where(better, a, p) for a, p in zip(nw, enw))
            emid = torch.where(better, m[13].to(torch.int64), emid)
    inv_len = torch.rsqrt(torch.clamp(enw[0] * enw[0] + enw[1] * enw[1] + enw[2] * enw[2],
                                      min=1e-24))
    out = dict(et=et, epo=epo, en=tuple(inv_len * c for c in enw), emid=emid, reached=reached)
    if want_uv:
        out.update(muv_u=uu, muv_v=vv, muvv=uvv)
    return out


def mesh_occ(km: KernelMeshes, gtab, x, wi) -> torch.Tensor:
    """Plain version of the in-kernel shadow-ray sweep: the nearest
    triangle ``t`` per lane (BIG = clear)."""
    occ = torch.full_like(x[0], BIG)
    for _, _, _, boxes, oo, _, inv, (tc, _, _) in _meshes(km, gtab, x, wi):
        t_min = torch.amin(tc, dim=-1)
        for c in range(boxes.shape[0]):
            reach = chunk_reaches(boxes[c].unbind(-1), oo, inv, occ)
            occ = torch.where(reach, torch.minimum(occ, t_min[:, c]), occ)
    return occ


def mesh_occ_split(km: KernelMeshes, gtab, mtab, x, wi):
    """Plain version of the in-kernel triangle split of volumetric NEE's
    shadow ray (``bounce_pallas.py:504-541``, ``mesh_occ_split_planes``):
    ``(t_opaque, t_refractive)``, each mesh's nearest ``t`` (culled against
    that mesh's own running minimum) going to the refractive side when its
    geom's material is refractive.  ``mtab`` is the packed material
    table."""
    occ_op = torch.full_like(x[0], BIG)
    occ_re = torch.full_like(x[0], BIG)
    refr = (mtab[gtab[:, 13].long(), 7] > 0.0).tolist()
    meshes = _meshes(km, gtab, x, wi)
    for (g, *_), (_, _, _, boxes, oo, _, inv, (tc, _, _)) in zip(km.descs, meshes):
        mt = torch.full_like(x[0], BIG)
        t_min = torch.amin(tc, dim=-1)
        for c in range(boxes.shape[0]):
            reach = chunk_reaches(boxes[c].unbind(-1), oo, inv, mt)
            mt = torch.where(reach, torch.minimum(mt, t_min[:, c]), mt)
        if refr[g]:
            occ_re = torch.minimum(occ_re, mt)
        else:
            occ_op = torch.minimum(occ_op, mt)
    return occ_op, occ_re
