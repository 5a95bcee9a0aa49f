"""Image-file textures: the atlas, the UV map and the bilinear fetch.

Port of ``pathtracer_tpu/ops/texture.py``: ``TextureAtlas``, ``decode_srgb``
and ``build_atlas`` (``:38-69``), ``compute_uv`` (``:70-95``) and
``sample_atlas`` (``:97-178``).  Every image of a scene is decoded to linear
light (gamma 2.2) and padded into one ``[K, H, W, 3]`` float32 atlas on the
scene's device, with each slot's own ``(height, width)``.

The UV comes from the object-space hit: the longitude / latitude of the
sphere's r = 0.5 point, the face-local planar map of the cube (dominant
``|p_obj|`` axis) and, for meshes, the box map of the object-space normal;
a mesh hit with authored ``vt`` takes that UV instead (the callers'
business: ``render/common.shade_bounce``, ``ops/bounce.bounce_physics``).
``compute_uv`` uses libm's ``atan2`` / ``asin`` as the JAX split path does;
kernel 2's deferred-texel variant computes its UV in the kernel with JAX's
polynomial (``ops/bounce.atan2_planes``), as the JAX kernel does.

The fetch is plain PyTorch, as the JAX package left it to XLA: four row
gathers and a bilinear blend with wrapping.  JAX's one-hot MXU fetch at
HIGHEST precision gives the exact texel values, so the gathers give the
same numbers.  The texels are differentiable (the atlas is a leaf of
``render/diff.SceneParams``): the gathers' backward adds each texel's
cotangents in float64 and rounds once (``ops/bsdf.gather_rows``), so a
texel's gradient is the same from run to run on the card, where float32
atomics would add its lanes in no fixed order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracer_tpu_torch.ops.bsdf import gather_rows
from pathtracer_tpu_torch.scene.structs import CUBE, SPHERE


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """All image textures of a scene, padded into one array."""

    data: torch.Tensor  # [K, H, W, 3] float32 linear-light texels
    hw: torch.Tensor  # [K, 2] float32 (height, width) of each slot

    @property
    def count(self) -> int:
        return self.data.shape[0]


def decode_srgb(img_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB(A) -> float32 linear RGB (gamma 2.2 decode)."""
    rgb = np.asarray(img_u8, np.float32)[..., :3] / 255.0
    return rgb**2.2


def build_atlas(images, device="cuda") -> TextureAtlas:
    """Pack decoded float ``[Hi, Wi, 3]`` images into one padded atlas on
    ``device``."""
    images = [np.asarray(im, np.float32) for im in images]
    if not images:
        raise ValueError("build_atlas needs at least one image")
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    data = np.zeros((len(images), h, w, 3), np.float32)
    hw = np.zeros((len(images), 2), np.float32)
    for k, im in enumerate(images):
        data[k, : im.shape[0], : im.shape[1]] = im[..., :3]
        hw[k] = (im.shape[0], im.shape[1])
    return TextureAtlas(data=torch.as_tensor(data, device=device),
                        hw=torch.as_tensor(hw, device=device))


def compute_uv(gtype: torch.Tensor, p_obj: torch.Tensor, n_obj: torch.Tensor) -> torch.Tensor:
    """Per-hit texture coordinates ``[N, 2]`` from the object-space hit;
    ``gtype`` is the winning geom's type.  All three maps are evaluated and
    selected per lane."""
    px, py, pz = p_obj.unbind(-1)
    sphere = gtype == SPHERE
    # the sphere map sees its own lanes only: on a cube face at |y| = 0.5
    # its asin is infinitely steep, and the zero cotangent of the lane it
    # does not select would make the gradient NaN (JAX's is)
    sx, sy, sz = (torch.where(sphere, c, fill) for c, fill in ((px, 1.0), (py, 0.0), (pz, 0.0)))
    u_sph = torch.atan2(sz, sx) / (2.0 * np.pi) + 0.5
    v_sph = torch.asin(torch.clamp(sy * 2.0, -1.0, 1.0)) / np.pi + 0.5
    # cube: the dominant |p_obj| axis; mesh: the dominant |n_obj| axis (the
    # first maximum wins, as argmax)
    sel = torch.where((gtype == CUBE)[:, None], torch.abs(p_obj), torch.abs(n_obj))
    axis = torch.argmax(sel, dim=-1)
    u_box = torch.where(axis == 0, pz, px) + 0.5
    v_box = torch.where(axis == 2, py, torch.where(axis == 0, py, pz)) + 0.5
    return torch.stack([torch.where(sphere, u_sph, u_box), torch.where(sphere, v_sph, v_box)],
                       dim=-1)


def sample_atlas(atlas: TextureAtlas, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, wrapping texel fetch ``[N, 3]``; lanes with ``tex_id < 0``
    get 1 (no modulation)."""
    k_count, height, width, _ = atlas.data.shape
    k = torch.clamp(tex_id.to(torch.int64), 0, k_count - 1)
    hw = atlas.hw[k]
    h, w = hw[:, 0], hw[:, 1]
    # wrap to [0, 1), flip v (image rows go top-down)
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    fx = u * w - 0.5
    fy = (1.0 - v) * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    table = atlas.data.reshape(k_count * height * width, 3)
    h_safe, w_safe = torch.clamp(h, min=1.0), torch.clamp(w, min=1.0)

    def texel(yi, xi):
        yi = torch.remainder(yi, h_safe).to(torch.int64)
        xi = torch.remainder(xi, w_safe).to(torch.int64)
        return gather_rows(table, (k * height + yi) * width + xi)

    c00 = texel(y0, x0)
    c01 = texel(y0, x0 + 1.0)
    c10 = texel(y0 + 1.0, x0)
    c11 = texel(y0 + 1.0, x0 + 1.0)
    top = c00 + (c01 - c00) * ax
    bot = c10 + (c11 - c10) * ax
    out = top + (bot - top) * ay
    return torch.where((tex_id >= 0.0)[:, None], out, 1.0)
