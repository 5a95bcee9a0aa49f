"""Batched camera ray generation.

Port of ``pathtracer_tpu/ops/camera.py:32-130`` and of the fast-RNG half
of ``pathtracer_tpu/render/common.py:51-58`` (``camera_uniforms``).
Conventions: basis ``A = view x up``, ``B = A x view``; half-extents
``|view| tan(fovx)`` along A and ``|view| tan(-fovy)`` along B (row 0 is the
top of the image); pixel coordinates ``x / (w - 1)``; one uniform jitter
per pixel per iteration; thin-lens depth of field when ``aperture > 0``.
Vector algebra is written component by component in the JAX package's
order of operations.
"""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.ops.rng import CAMERA_STREAM, hash_uniforms
from pathtracer_tpu_torch.scene.structs import Camera, Rays


def camera_uniforms(seed: int, sample_idx: torch.Tensor) -> torch.Tensor:
    """``[N, 4]`` camera jitter + lens uniforms per global sample."""
    return hash_uniforms(seed, sample_idx, CAMERA_STREAM, 4)


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _normalize(v):
    return v / _norm(v).clamp(min=1e-12)[..., None]


def generate_camera_rays(
    camera: Camera,
    pixel_index: torch.Tensor,
    per_ray_uniforms: torch.Tensor,
    jitter: bool = True,
) -> Rays:
    """One primary ray per entry of ``pixel_index`` (``x + y * width``);
    ``per_ray_uniforms`` is ``[N, 4]``: jitter xy, lens radius and angle."""
    w, h = camera.width, camera.height
    x = (pixel_index % w).to(torch.float32)
    y = torch.div(pixel_index, w, rounding_mode="floor").to(torch.float32)
    if jitter:
        x = x + (per_ray_uniforms[:, 0] - 0.5)
        y = y + (per_ray_uniforms[:, 1] - 0.5)
    sx = x / (w - 1)
    sy = y / (h - 1)

    eye = camera.position
    view = camera.view
    a = _cross(view, camera.up)
    b = _cross(a, view)
    view_len = _norm(view)
    fov_rad = camera.fov * (math.pi / 180.0)
    a_hat = _normalize(a)
    b_hat = _normalize(b)
    half_x = a_hat * view_len * torch.tan(fov_rad[0])
    half_y = b_hat * view_len * torch.tan(-fov_rad[1])

    mid = eye + view
    point = (
        mid[None, :]
        + (2.0 * sx - 1.0)[:, None] * half_x[None, :]
        + (2.0 * sy - 1.0)[:, None] * half_y[None, :]
    )
    direction = _normalize(point - eye[None, :])
    origin = eye[None, :].expand_as(direction)

    focal = torch.where(camera.focal_distance > 0, camera.focal_distance, view_len)
    r = torch.sqrt(per_ray_uniforms[:, 2]) * camera.aperture
    theta = (2.0 * math.pi) * per_ray_uniforms[:, 3]
    lens_offset = (r * torch.cos(theta))[:, None] * a_hat[None, :] + (
        r * torch.sin(theta)
    )[:, None] * b_hat[None, :]
    cos_to_view = _dot(direction, _normalize(view)[None, :])
    focus_point = origin + direction * (focal / cos_to_view)[:, None]
    origin_dof = origin + lens_offset
    dir_dof = _normalize(focus_point - origin_dof)

    use_dof = camera.aperture > 0
    origin = torch.where(use_dof, origin_dof, origin)
    direction = torch.where(use_dof, dir_dof, direction)
    return Rays(origin=origin.contiguous(), direction=direction.contiguous())
