"""TRS transform construction.

Port of ``pathtracer_tpu/ops/transforms.py:17-128``: angles in degrees,
``M = T @ Rx @ Ry @ Rz @ S``, and the inverse built analytically as
``S^-1 Rz^T Ry^T Rx^T T^-1``.  Products of 3x3 matrices are written as
explicit float32 multiply-adds, as the JAX package does for its vector
applies, so no BLAS reassociation enters the geometry.  The matrices are
built out of place from tensor inputs, so the differentiable render
(``render/diff.py``) carries gradients to the TRS values.
"""

from __future__ import annotations

import math

import torch


def _mat3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``[..., 3, 3]`` as explicit sums in index order."""
    rows = []
    for i in range(3):
        rows.append(
            torch.stack(
                [
                    a[..., i, 0] * b[..., 0, j]
                    + a[..., i, 1] * b[..., 1, j]
                    + a[..., i, 2] * b[..., 2, j]
                    for j in range(3)
                ],
                dim=-1,
            )
        )
    return torch.stack(rows, dim=-2)


def mat3_apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m[..., :3, :3] @ v[..., 3]`` as explicit float32 multiply-adds."""
    return torch.stack(
        [
            m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1] + m[..., i, 2] * v[..., 2]
            for i in range(3)
        ],
        dim=-1,
    )


def _affine(lin: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` from a ``[..., 3, 3]`` linear part and a ``[..., 3]``
    translation, built out of place so that autograd sees every entry."""
    top = torch.cat([lin, trans[..., :, None]], dim=-1)
    bottom = torch.zeros(lin.shape[:-2] + (1, 4), dtype=lin.dtype, device=lin.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def build_transform(translation, rotation_deg, scale, device=None):
    """``([..., 4, 4] transform, [..., 4, 4] inverse)`` from ``[..., 3]``
    translation, rotation (degrees) and scale.  Tensor inputs keep their
    graph: the matrices are differentiable in all three.  ``device``
    defaults to the translation's device (the CPU for array inputs)."""
    if device is None:
        device = translation.device if isinstance(translation, torch.Tensor) else "cpu"
    f32 = dict(dtype=torch.float32, device=device)
    translation = torch.as_tensor(translation, **f32)
    rotation_deg = torch.as_tensor(rotation_deg, **f32)
    scale = torch.as_tensor(scale, **f32)

    rad = rotation_deg * (math.pi / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    zero = torch.zeros_like(cx)
    one = torch.ones_like(cx)

    def mat3(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rx = mat3([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat3([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat3([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    r = _mat3_mul(_mat3_mul(rx, ry), rz)

    m = _affine(r * scale[..., None, :], translation)
    inv3 = r.transpose(-1, -2) / scale[..., :, None]
    minv = _affine(inv3, -mat3_apply(inv3, translation))
    return m, minv
