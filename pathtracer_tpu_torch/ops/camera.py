"""Batched camera ray generation.

Port of ``pathtracer_tpu/ops/camera.py:32-130`` and of
``pathtracer_tpu/render/common.py:51-58`` (``camera_uniforms``, both RNGs).
Conventions: basis ``A = view x up``, ``B = A x view``; half-extents
``|view| tan(fovx)`` along A and ``|view| tan(-fovy)`` along B (row 0 is the
top of the image); pixel coordinates ``x / (w - 1)``; one uniform jitter
per pixel per iteration; thin-lens depth of field when ``aperture > 0``.
Vector algebra is written component by component in the JAX package's
order of operations.

:func:`primary_rays` is the one dispatch of a render's primary rays
(``render/integrator.camera_sample`` and both engines of
``render/wavefront`` call it).  On CUDA tensors, with the counter hash
(``cfg.fast_rng``) and no camera field to differentiate, it launches
``csrc/camera.cu`` (:func:`camera_rays_cuda`, counted in
:data:`launches`): the camera uniforms and the rays in one pass, bit-equal
to the plain ops on the card.
Every other case (the CPU, threefry, a camera that needs a gradient) takes
the plain ops, :func:`camera_uniforms` and :func:`generate_camera_rays`.
Both read the per-camera constants of :func:`camera_frame`, made on the
camera's device by torch ops, so the host never waits for them; the
kernel reads them packed in :func:`camera_table`, made once for a camera.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.rng import CAMERA_STREAM, MASK32, hash_uniforms, sample_keys, uniform
from pathtracer_tpu_torch.ops.trace import check_tensor
from pathtracer_tpu_torch.scene.structs import Camera, Rays

launches = 0  # launches of csrc/camera.cu in this process
FRAME_COLS = 23  # floats of the kernel's per-camera table: the fields of CameraFrame

# the camera's tensors, in the order the differentiable scene lists them
CAMERA_FIELDS = ("position", "view", "up", "fov", "aperture", "focal_distance")


def camera_uniforms(seed: int, sample_idx: torch.Tensor, fast_rng: bool = True) -> torch.Tensor:
    """``[N, 4]`` camera jitter + lens uniforms per global sample: the
    counter hash's camera stream, or with ``fast_rng`` off threefry's
    ``uniform(fold_in(key, sample), (4,))`` (``seed`` a ``KeyedSeed``)."""
    if fast_rng:
        return hash_uniforms(seed, sample_idx, CAMERA_STREAM, 4)
    return uniform(sample_keys(seed, sample_idx), (4,))


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


class CameraFrame(NamedTuple):
    """The per-camera constants of the rays: ``[3]`` vectors and ``[]``
    scalars on the camera's device (``csrc/camera.cu`` reads them in this
    order, :data:`FRAME_COLS` floats)."""

    eye: torch.Tensor
    mid: torch.Tensor  # eye + view: the image plane's centre
    half_x: torch.Tensor  # half-extent along A
    half_y: torch.Tensor  # half-extent along B
    a_hat: torch.Tensor
    b_hat: torch.Tensor
    view_hat: torch.Tensor
    focal: torch.Tensor  # the focal distance, |view| where it is <= 0
    aperture: torch.Tensor


def camera_frame(camera: Camera) -> CameraFrame:
    """The constants every ray of ``camera`` shares, by the JAX package's
    operations (differentiable in the camera's fields)."""
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
    focal = torch.where(camera.focal_distance > 0, camera.focal_distance, view_len)
    return CameraFrame(eye, eye + view, half_x, half_y, a_hat, b_hat, _normalize(view), focal,
                       camera.aperture)


def generate_camera_rays(
    camera: Camera,
    pixel_index: torch.Tensor,
    per_ray_uniforms: torch.Tensor,
    jitter: bool = True,
) -> Rays:
    """One primary ray per entry of ``pixel_index`` (``x + y * width``);
    ``per_ray_uniforms`` is ``[N, 4]``: jitter xy, lens radius and angle."""
    f = camera_frame(camera)
    w, h = camera.width, camera.height
    x = (pixel_index % w).to(torch.float32)
    y = torch.div(pixel_index, w, rounding_mode="floor").to(torch.float32)
    if jitter:
        x = x + (per_ray_uniforms[:, 0] - 0.5)
        y = y + (per_ray_uniforms[:, 1] - 0.5)
    sx = x / (w - 1)
    sy = y / (h - 1)

    point = (
        f.mid[None, :]
        + (2.0 * sx - 1.0)[:, None] * f.half_x[None, :]
        + (2.0 * sy - 1.0)[:, None] * f.half_y[None, :]
    )
    direction = _normalize(point - f.eye[None, :])
    origin = f.eye[None, :].expand_as(direction)

    r = torch.sqrt(per_ray_uniforms[:, 2]) * f.aperture
    theta = (2.0 * math.pi) * per_ray_uniforms[:, 3]
    lens_offset = (r * torch.cos(theta))[:, None] * f.a_hat[None, :] + (
        r * torch.sin(theta)
    )[:, None] * f.b_hat[None, :]
    cos_to_view = _dot(direction, f.view_hat[None, :])
    focus_point = origin + direction * (f.focal / cos_to_view)[:, None]
    origin_dof = origin + lens_offset
    dir_dof = _normalize(focus_point - origin_dof)

    use_dof = f.aperture > 0
    origin = torch.where(use_dof, origin_dof, origin)
    direction = torch.where(use_dof, dir_dof, direction)
    return Rays(origin=origin.contiguous(), direction=direction.contiguous())


def camera_kernel_takes(camera: Camera, pixel_index: torch.Tensor, fast_rng: bool) -> bool:
    """The dispatch rule of :func:`primary_rays`: the kernel runs on CUDA
    tensors, with the counter hash, for a camera that needs no gradient
    (grad mode off, or none of its tensors requiring grad)."""
    needs_grad = torch.is_grad_enabled() and any(getattr(camera, k).requires_grad
                                                 for k in CAMERA_FIELDS)
    return (pixel_index.device.type == "cuda" and camera.position.device.type == "cuda"
            and bool(fast_rng) and not needs_grad)


def _lib():
    fn = _build.load("camera").camera_launch
    if fn.argtypes is None:  # without argtypes ctypes would cut pointers to 32 bits
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # pixel, sample, n
            ctypes.c_void_p, ctypes.c_uint,  # the frame table, seed
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # width, height, jitter
            ctypes.c_void_p, ctypes.c_void_p,  # origin, direction
            ctypes.c_void_p,  # stream
        ]
    return fn


# the last camera whose table was made: its tensors, their version counters, the table
_held = ((), (), None)


def _pack(camera: Camera) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([t.reshape(-1) for t in camera_frame(camera)])


def camera_table(camera: Camera) -> torch.Tensor:
    """The kernel's ``[FRAME_COLS]`` table: the fields of
    :func:`camera_frame` flattened in order, with no autograd history.  It
    is made once for a camera and kept while the camera's tensors are the
    same objects, unchanged in place (their version counters), so a
    progressive render makes it once, not once a call."""
    global _held
    tensors = tuple(getattr(camera, k) for k in CAMERA_FIELDS)
    if any(t.is_inference() for t in tensors):  # such tensors keep no version counter
        return _pack(camera)
    versions = tuple(t._version for t in tensors)
    held, held_versions, table = _held
    if versions != held_versions or any(a is not b for a, b in zip(held, tensors)):
        table = _pack(camera)
        _held = (tensors, versions, table)
    return table


def camera_rays_cuda(camera: Camera, pixel_index: torch.Tensor, sample_idx: torch.Tensor,
                     seed: int, jitter: bool = True) -> Rays:
    """Launch the camera kernel: the rays of :func:`generate_camera_rays`
    over :func:`camera_uniforms` (the counter hash), on the CUDA device of
    ``pixel_index``, on the current stream.  ``sample_idx`` holds the global
    sample indices (their uint32 bits key the hash)."""
    global launches
    device = pixel_index.device
    if device.type != "cuda":
        raise ValueError(f"the camera kernel needs CUDA tensors, got {device}")
    n = pixel_index.shape[0]
    if n >= 2**31:  # the kernel's lane count is a 32-bit int
        raise ValueError(f"the camera kernel takes fewer than 2**31 rays, got {n}")
    pixel = pixel_index.to(torch.int64).contiguous()
    sample = sample_idx.to(torch.int64).contiguous()
    check_tensor(sample, "sample_idx", torch.int64, (n,), device)
    table = camera_table(camera)
    check_tensor(table, "camera frame", torch.float32, (FRAME_COLS,), device)
    f32 = dict(dtype=torch.float32, device=device)
    origin = torch.empty((n, 3), **f32)
    direction = torch.empty((n, 3), **f32)
    err = _lib()(
        pixel.data_ptr(), sample.data_ptr(), n, table.data_ptr(), int(seed) & MASK32,
        camera.width, camera.height, int(bool(jitter)), origin.data_ptr(), direction.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"camera kernel launch failed: CUDA error {err}")
    launches += 1
    return Rays(origin=origin, direction=direction)


def primary_rays(camera: Camera, pixel_index: torch.Tensor, sample_idx: torch.Tensor, seed: int,
                 cfg) -> Rays:
    """The primary rays of pixels ``pixel_index`` for the global sample
    indices ``sample_idx`` under ``cfg`` (``fast_rng``, ``jitter``): the
    kernel where :func:`camera_kernel_takes`, the plain ops elsewhere, the
    same rays bit for bit."""
    if camera_kernel_takes(camera, pixel_index, cfg.fast_rng):
        return camera_rays_cuda(camera, pixel_index, sample_idx, seed, cfg.jitter)
    return generate_camera_rays(camera, pixel_index,
                                camera_uniforms(seed, sample_idx, cfg.fast_rng),
                                jitter=cfg.jitter)
