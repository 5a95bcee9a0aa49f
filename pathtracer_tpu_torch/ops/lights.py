"""Light areas and area-light sampling for next-event estimation.

Port of ``pathtracer_tpu/ops/lights.py:33-165``: ``geom_surface_areas`` and
``light_areas`` (the world-space surface area of each geom: exact for
cubes under TRS; exact for spheres under uniform scale, Knud Thomsen's
ellipsoid approximation otherwise; zero for geoms that do not emit), and
``LightSample`` / ``sample_lights`` with the unit cube and sphere surface
samplers, which the split per-bounce route (``render/common.py``) uses.
The light table of the kernels (``ops/bounce.py``) is built from the same
areas.  Light selection is area-weighted, so every sample's area pdf is
``1 / total light area``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pathtracer_tpu_torch.ops.bsdf import gather_rows
from pathtracer_tpu_torch.ops.transforms import mat3_apply
from pathtracer_tpu_torch.scene.structs import SPHERE, Geoms, Materials


@dataclasses.dataclass(frozen=True)
class LightSample:
    """A point sampled on the scene's lights, per ray."""

    position: torch.Tensor  # [N, 3] world point on the light surface
    normal: torch.Tensor  # [N, 3] world light-surface normal
    emitted: torch.Tensor  # [N, 3] color * emittance of the sampled light
    pdf_area: torch.Tensor  # [N] area-measure pdf (1 / total light area)
    valid: torch.Tensor  # [N] bool: the scene has a light


def axis_scales(transform: torch.Tensor) -> torch.Tensor:
    """``[G, 3]`` per-axis world scale: column norms of the linear part."""
    lin = transform[:, :3, :3]
    return torch.sqrt(
        lin[:, 0, :] * lin[:, 0, :] + lin[:, 1, :] * lin[:, 1, :] + lin[:, 2, :] * lin[:, 2, :]
    )


def geom_surface_areas(geoms: Geoms) -> torch.Tensor:
    s = axis_scales(geoms.transform)
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    cube_area = 2.0 * (sx * sy + sy * sz + sz * sx)
    p = 1.6075
    a, b, c = sx / 2, sy / 2, sz / 2
    ellipsoid = (4.0 * math.pi) * (
        ((a * b) ** p + (b * c) ** p + (c * a) ** p) / 3.0
    ) ** (1.0 / p)
    return torch.where(geoms.type == SPHERE, ellipsoid, cube_area)


def light_areas(geoms: Geoms, materials: Materials) -> torch.Tensor:
    """``[G]`` surface area for emissive geoms, 0 for the rest."""
    emissive = materials.emittance[geoms.material_id.long()] > 0.0
    return torch.where(emissive, geom_surface_areas(geoms), 0.0)


def _sample_unit_cube_surface(u: torch.Tensor, face_areas: torch.Tensor):
    """Area-weighted point and normal on the unit cube, object space.
    ``u`` is ``[N, 3]`` (face pick, two surface coordinates), ``face_areas``
    ``[N, 3]`` the world areas of the x-, y- and z-normal face pairs."""
    total = torch.clamp(torch.sum(face_areas, dim=-1, keepdim=True), min=1e-20)
    cdf0 = face_areas[:, 0:1] / total  # the face-pair CDF, as a cumsum adds it
    cdf1 = (face_areas[:, 0:1] + face_areas[:, 1:2]) / total
    pick = u[:, 0:1]
    axis = ((pick > cdf0).long() + (pick > cdf1).long())[:, 0]
    side = torch.where(u[:, 1] < 0.5, -0.5, 0.5)  # which face of the pair
    c1 = torch.where(u[:, 1] < 0.5, u[:, 1] * 2.0, (u[:, 1] - 0.5) * 2.0) - 0.5
    c2 = u[:, 2] - 0.5
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    onehot, nxt, nxt2 = eye[axis], eye[(axis + 1) % 3], eye[(axis + 2) % 3]
    p = onehot * side[:, None] + nxt * c1[:, None] + nxt2 * c2[:, None]
    n = onehot * torch.sign(side)[:, None]
    return p, n


def _sample_unit_sphere_surface(u: torch.Tensor):
    """Uniform point and normal on the radius-0.5 sphere, object space."""
    z = 1.0 - 2.0 * u[:, 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u[:, 2]
    n = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return 0.5 * n, n


def sample_lights(geoms: Geoms, materials: Materials, u: torch.Tensor) -> LightSample:
    """One light point per ray.  ``u`` is ``[N, 4]`` (light pick, face or z,
    two surface coordinates); the pick is detached."""
    n = u.shape[0]
    areas = light_areas(geoms, materials)
    total_area = torch.sum(areas)
    valid = total_area > 0.0
    cdf = torch.cumsum(areas, dim=0) / torch.clamp(total_area, min=1e-20)
    pick = u[:, 0:1].detach()
    light_id = torch.sum((pick > cdf.detach()[None, :]).long(), dim=-1)
    light_id = torch.clamp(light_id, 0, geoms.count - 1)

    xf = gather_rows(geoms.transform, light_id)
    inv = gather_rows(geoms.inv_transform, light_id)
    is_sphere = geoms.type[light_id] == SPHERE
    s = axis_scales(xf)  # [N, 3] per-axis world scale of the picked light
    face_pairs = 2.0 * torch.stack([s[:, 1] * s[:, 2], s[:, 0] * s[:, 2], s[:, 0] * s[:, 1]],
                                   dim=-1)
    p_cube, n_cube = _sample_unit_cube_surface(u[:, 1:4], face_pairs)
    p_sph, n_sph = _sample_unit_sphere_surface(u[:, 1:4])
    p_obj = torch.where(is_sphere[:, None], p_sph, p_cube)
    n_obj = torch.where(is_sphere[:, None], n_sph, n_cube)

    p_world = mat3_apply(xf, p_obj) + xf[:, :3, 3]
    n_world = mat3_apply(inv.transpose(-1, -2), n_obj)  # the inverse-transpose
    n_world = n_world / torch.clamp(
        torch.sqrt(torch.sum(n_world * n_world, dim=-1, keepdim=True)), min=1e-12
    )
    mid = geoms.material_id.long()
    emit_g = materials.color[mid] * materials.emittance[mid][:, None]
    pdf = torch.where(valid, 1.0 / torch.clamp(total_area, min=1e-20), 0.0)
    return LightSample(
        position=p_world,
        normal=n_world,
        emitted=gather_rows(emit_g, light_id),
        pdf_area=torch.ones(n, dtype=u.dtype, device=u.device) * pdf,
        valid=valid.expand(n),
    )
