"""Displacement mapping at load time.

Port of ``pathtracer_tpu/scene/displace.py:27-94``, numpy op for op: the
mesh is midpoint-subdivided ``levels`` times and every shared vertex moves
along its area-weighted vertex normal by ``amount * h(p)``, with ``h`` the
sin lattice ``sin(f x) sin(f y) sin(f z)`` in object space.  The displaced
mesh is an ordinary triangle mesh to everything downstream.  DSL:
``DISPLACE <amount> <levels> [sin <freq>]`` on an OBJECT block.
"""

from __future__ import annotations

import numpy as np


def subdivide(tris: np.ndarray, levels: int) -> np.ndarray:
    """Midpoint 4-way subdivision: ``[T, 3, 3] -> [T * 4**levels, 3, 3]``."""
    tris = np.asarray(tris, np.float32)
    for _ in range(levels):
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        m01 = 0.5 * (v0 + v1)
        m12 = 0.5 * (v1 + v2)
        m20 = 0.5 * (v2 + v0)
        tris = np.concatenate(
            [
                np.stack([v0, m01, m20], axis=1),
                np.stack([m01, v1, m12], axis=1),
                np.stack([m20, m12, v2], axis=1),
                np.stack([m01, m12, m20], axis=1),
            ],
            axis=0,
        ).astype(np.float32)
    return tris


def vertex_normals(tris: np.ndarray, decimals: int = 5):
    """Area-weighted unit normals per corner, ``[T, 3, 3]``; corners are
    shared by their position rounded to ``decimals``."""
    tris = np.asarray(tris, np.float64)
    face_n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    flat = tris.reshape(-1, 3)
    keys = np.round(flat, decimals)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    acc = np.zeros((uniq.shape[0], 3), np.float64)
    np.add.at(acc, inv, np.repeat(face_n, 3, axis=0))
    norm = np.linalg.norm(acc, axis=-1, keepdims=True)
    acc = acc / np.maximum(norm, 1e-20)
    return acc[inv].reshape(tris.shape).astype(np.float32)


def _height_sin(p: np.ndarray, freq: float) -> np.ndarray:
    return (
        np.sin(freq * p[..., 0]) * np.sin(freq * p[..., 1]) * np.sin(freq * p[..., 2])
    ).astype(np.float32)


def displace_mesh(tris: np.ndarray, amount: float, levels: int, mode: str = "sin",
                  arg: float = 8.0) -> np.ndarray:
    """Subdivide ``levels`` times, then displace every shared vertex by
    ``amount * h(p)`` along its vertex normal."""
    tris = subdivide(tris, levels)
    if amount == 0.0:
        return tris
    if mode != "sin":
        raise ValueError(f"unknown displacement mode {mode!r}")
    n = vertex_normals(tris)
    # h at the rounded shared position, so coincident corners move alike
    shared_p = np.round(tris.astype(np.float64), 5).astype(np.float32)
    h = _height_sin(shared_p, float(arg))[..., None]
    return (tris + amount * h * n).astype(np.float32)
