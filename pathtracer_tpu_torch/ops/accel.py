"""Triangle-mesh acceleration structure: a Morton-ordered chunked LBVH.

Port of ``pathtracer_tpu/ops/accel.py:55-119,156-247``.  The build runs on
the host in numpy, op for op as in the JAX package: triangles sorted by the
30-bit Morton code of their centroid (stable), grouped into chunks of 128,
the last chunk padded with copies of the last triangle (a copy can never
win a strict ``t < best`` against its original, which comes first), a box
per chunk and one for the whole mesh.  ``scan_to_file`` maps a row of the
scan order to the triangle's index in the file's order, where the authored
attributes live.

:func:`mesh_t_and_normal_accel` is the traversal the split route takes for
meshes above ``ops/mesh.MESH_KERNEL_MAX_TRIS`` triangles: plain PyTorch, as
JAX leaves it to XLA.  It skips the whole mesh when no ray reaches the root
box and a chunk when no ray reaches that chunk's box nearer than its
current best, as JAX's ``lax.cond`` does; in PyTorch each such test is a
host sync.  :func:`refresh_accel` (``accel.py:122``) rebinds an LBVH to a
mesh's live vertices for differentiable meshes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracer_tpu_torch.ops.intersect import (
    BIG,
    T_MIN,
    mt_chunk_t,
    safe_recip,
    winner_face_normal,
)

ACCEL_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class MeshAccel:
    """Two-level chunked LBVH over one mesh's object-space triangles."""

    n_tris: int  # real (unpadded) triangle count
    chunks: torch.Tensor  # [C, 128, 3, 3] Morton-sorted, last-triangle padded
    lo: torch.Tensor  # [C, 3] chunk box min
    hi: torch.Tensor  # [C, 3] chunk box max
    root_lo: torch.Tensor  # [3]
    root_hi: torch.Tensor  # [3]
    scan_to_file: torch.Tensor  # [C * 128] int32 scan row -> file-order triangle


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit x/y/z into 30-bit Morton codes; ``q`` ``[T, 3]``."""

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (spread(q[:, 2]) << np.uint64(2))


def build_mesh_accel(tri_verts: np.ndarray, chunk: int = ACCEL_CHUNK, device="cpu") -> MeshAccel:
    """Host build (Morton sort, chunk, boxes), deterministic; the arrays go
    to ``device``."""
    tris = np.asarray(tri_verts, np.float32)
    t_count = tris.shape[0]
    cent = tris.mean(axis=1)
    mn = tris.min(axis=(0, 1))
    mx = tris.max(axis=(0, 1))
    ext = np.maximum(mx - mn, 1e-12)
    q = np.clip(((cent - mn) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable")
    tris = tris[order]
    scan_to_file = order.astype(np.int32)
    pad = (-t_count) % chunk
    if pad:
        tris = np.concatenate([tris, np.repeat(tris[-1:], pad, axis=0)], axis=0)
        scan_to_file = np.concatenate([scan_to_file, np.repeat(scan_to_file[-1:], pad)], axis=0)
    ch = tris.reshape(-1, chunk, 3, 3)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return MeshAccel(
        n_tris=t_count,
        chunks=dev(ch),
        lo=dev(ch.min(axis=(1, 2))),
        hi=dev(ch.max(axis=(1, 2))),
        root_lo=dev(tris.min(axis=(0, 1))),
        root_hi=dev(tris.max(axis=(0, 1))),
        scan_to_file=dev(scan_to_file),
    )


def refresh_accel(accel: MeshAccel, tri_verts: torch.Tensor) -> MeshAccel:
    """``accel`` rebound to the vertices ``tri_verts`` (file order): its
    Morton grouping (``scan_to_file``) stays, its triangle copies and its
    chunk and root boxes are recomputed from the vertices, detached.  A
    vertex can then move anywhere and the traversal still sees the exact
    triangles; a stale grouping only loosens the boxes."""
    verts = tri_verts.detach().to(torch.float32)
    perm = accel.scan_to_file.to(verts.device)
    chunks = verts[perm.long()].reshape(-1, accel.chunks.shape[1], 3, 3)
    lo = torch.amin(chunks, dim=(1, 2))
    hi = torch.amax(chunks, dim=(1, 2))
    return MeshAccel(n_tris=accel.n_tris, chunks=chunks, lo=lo, hi=hi,
                     root_lo=torch.amin(lo, dim=0), root_hi=torch.amax(hi, dim=0),
                     scan_to_file=perm)


def _aabb_hits_any(o_obj, inv_d, lo, hi, best_t, t_min) -> torch.Tensor:
    """True iff some ray's ``[t_min, best_t]`` interval crosses the box."""
    t0 = (lo[None, :] - o_obj) * inv_d
    t1 = (hi[None, :] - o_obj) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.any((tf >= tn) & (tf > t_min) & (tn < best_t))


def mesh_t_and_normal_accel(o_obj, d_obj, accel: MeshAccel, t_min=T_MIN, with_index=False):
    """Nearest triangle of ``[N, 3]`` object-space rays: ``(t [N], n_obj
    [N, 3])`` with the winner's unnormalized face normal (BIG = miss), and
    with ``with_index`` its row in ``accel.chunks.reshape(-1, 3, 3)``."""
    n = o_obj.shape[0]
    n_chunks, chunk = accel.chunks.shape[0], accel.chunks.shape[1]
    scan = accel.chunks.reshape(-1, 3, 3)
    inv_d = safe_recip(d_obj)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o_obj.device)
    best_i = torch.zeros(n, dtype=torch.int32, device=o_obj.device)
    root = torch.full_like(best_t, BIG)
    if bool(_aabb_hits_any(o_obj, inv_d, accel.root_lo, accel.root_hi, root, t_min)):
        for c in range(n_chunks):
            if not bool(_aabb_hits_any(o_obj, inv_d, accel.lo[c], accel.hi[c], best_t, t_min)):
                continue
            tri = accel.chunks[c]
            t = mt_chunk_t(o_obj, d_obj, tri[:, 0], tri[:, 1] - tri[:, 0],
                           tri[:, 2] - tri[:, 0], t_min)
            t_c, i_c = torch.min(t, dim=-1)  # the first minimum
            better = t_c < best_t
            best_t = torch.where(better, t_c, best_t)
            best_i = torch.where(better, (c * chunk + i_c).to(torch.int32), best_i)
    nrm = winner_face_normal(scan, best_i)
    return (best_t, nrm, best_i) if with_index else (best_t, nrm)
