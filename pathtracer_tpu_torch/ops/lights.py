"""Light areas for area-weighted light selection.

Port of ``pathtracer_tpu/ops/lights.py:43-68`` (``geom_surface_areas``,
``light_areas``): the world-space surface area of each geom (exact for
cubes under TRS; exact for spheres under uniform scale, Knud Thomsen's
ellipsoid approximation otherwise), zero for geoms that do not emit.  The
light table of the trace (``ops/bounce.py``) is built from these.
"""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.scene.structs import SPHERE, Geoms, Materials


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
