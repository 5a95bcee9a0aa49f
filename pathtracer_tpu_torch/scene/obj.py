"""Wavefront OBJ mesh loading.

Port of ``pathtracer_tpu/scene/obj.py:23-122`` (``MeshData``,
``load_obj_full``, ``load_obj``, ``load_mesh_for_scene``), host-side numpy.
Supported OBJ subset: ``v`` positions, ``vt`` texture coordinates, ``vn``
normals and ``f`` faces of any arity (fan-triangulated; ``v/vt/vn`` index
syntax; negative indices count back from the end).  The arrays are the JAX
package's bit for bit: the same parse, the same fan order, the same float32
casts.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshData:
    """Host-side mesh: expanded per-corner arrays in file (face) order."""

    verts: np.ndarray  # [T, 3, 3] float32 positions (mesh object space)
    uv: np.ndarray | None  # [T, 3, 2] float32 authored texcoords, or None
    norm: np.ndarray | None  # [T, 3, 3] float32 authored unit normals, or None


def load_obj_full(path: str) -> MeshData:
    """Load an OBJ file.  ``uv`` / ``norm`` are present only when every face
    corner references one (a partly attributed mesh drops them)."""
    verts, uvs, norms = [], [], []
    tris, tri_uvs, tri_norms = [], [], []
    any_missing_uv = False
    any_missing_norm = False

    def resolve(i: int, n: int) -> int:
        return i - 1 if i > 0 else n + i

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "vt" and len(parts) >= 3:
                uvs.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "vn" and len(parts) >= 4:
                norms.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                vi, ti, ni = [], [], []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi.append(resolve(int(fields[0]), len(verts)))
                    ti.append(resolve(int(fields[1]), len(uvs))
                              if len(fields) >= 2 and fields[1] else None)
                    ni.append(resolve(int(fields[2]), len(norms))
                              if len(fields) >= 3 and fields[2] else None)
                for k in range(1, len(vi) - 1):  # fan triangulation
                    corners = (0, k, k + 1)
                    tris.append(tuple(vi[c] for c in corners))
                    if all(ti[c] is not None for c in corners):
                        tri_uvs.append(tuple(ti[c] for c in corners))
                    else:
                        any_missing_uv = True
                    if all(ni[c] is not None for c in corners):
                        tri_norms.append(tuple(ni[c] for c in corners))
                    else:
                        any_missing_norm = True
    if not tris:
        raise ValueError(f"{path}: OBJ has no faces")
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int64)
    if t.min() < 0 or t.max() >= len(v):
        raise ValueError(f"{path}: face index out of range")

    uv = None
    if uvs and not any_missing_uv and len(tri_uvs) == len(tris):
        ti = np.asarray(tri_uvs, np.int64)
        if ti.min() < 0 or ti.max() >= len(uvs):
            raise ValueError(f"{path}: vt index out of range")
        uv = np.asarray(uvs, np.float32)[ti]  # [T, 3, 2]
    norm = None
    if norms and not any_missing_norm and len(tri_norms) == len(tris):
        ni = np.asarray(tri_norms, np.int64)
        if ni.min() < 0 or ni.max() >= len(norms):
            raise ValueError(f"{path}: vn index out of range")
        nn = np.asarray(norms, np.float32)[ni]  # [T, 3, 3]
        norm = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-12)
    return MeshData(verts=v[t], uv=uv, norm=norm)


def load_obj(path: str) -> np.ndarray:
    """Expanded triangle vertices ``[T, 3, 3]`` float32, positions only."""
    return load_obj_full(path).verts


def load_mesh_for_scene(scene_path: str, mesh_token: str) -> np.ndarray:
    """A mesh named in a scene file: the token as given, else relative to
    the scene file's directory."""
    candidates = [
        mesh_token,
        os.path.join(os.path.dirname(os.path.abspath(scene_path)), mesh_token),
    ]
    for c in candidates:
        if os.path.exists(c):
            return load_obj(c)
    raise FileNotFoundError(f"mesh {mesh_token!r} (tried {candidates})")
