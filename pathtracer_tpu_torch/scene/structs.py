"""Scene data model: struct-of-arrays dataclasses of torch tensors.

Port of ``pathtracer_tpu/scene/structs.py:49-307``: ``Rays``, ``Geoms``,
``Materials``, ``Camera``, ``Scene`` and ``SceneDescription`` with
``scene_for_frame`` / ``camera_for_frame``.  One tensor per field, on the
device the caller names.  Mesh and texture fields are carried as data only;
the slices that render them come later.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

SPHERE = 0
CUBE = 1
MESH = 2

MATERIAL_FIELDS = (
    "color", "specular_exponent", "specular_color", "has_reflective",
    "has_refractive", "index_of_refraction", "has_scatter",
    "absorption_coefficient", "reduced_scatter_coefficient", "emittance",
    "texture_type", "texture_scale", "texture_color2", "bump_scale",
    "bump_amp", "texture_image", "brdf_model", "roughness", "roughness_y",
    "phase_g",
)


@dataclasses.dataclass(frozen=True)
class Rays:
    origin: torch.Tensor  # [N, 3] float32
    direction: torch.Tensor  # [N, 3] float32, normalized

    @property
    def count(self) -> int:
        return self.origin.shape[0]


@dataclasses.dataclass(frozen=True)
class Geoms:
    """Geometry instances of one frame: unit primitives (sphere r=0.5,
    cube side 1) placed by ``transform``."""

    type: torch.Tensor  # [G] int32 in {SPHERE, CUBE, MESH}
    material_id: torch.Tensor  # [G] int32
    transform: torch.Tensor  # [G, 4, 4] float32, object->world
    inv_transform: torch.Tensor  # [G, 4, 4] float32, world->object

    @property
    def count(self) -> int:
        return self.type.shape[0]


@dataclasses.dataclass(frozen=True)
class Materials:
    color: torch.Tensor  # [M, 3]
    specular_exponent: torch.Tensor  # [M]
    specular_color: torch.Tensor  # [M, 3]
    has_reflective: torch.Tensor  # [M] float flag
    has_refractive: torch.Tensor  # [M]
    index_of_refraction: torch.Tensor  # [M]
    has_scatter: torch.Tensor  # [M]
    absorption_coefficient: torch.Tensor  # [M, 3]
    reduced_scatter_coefficient: torch.Tensor  # [M]
    emittance: torch.Tensor  # [M]
    texture_type: torch.Tensor  # [M] 0 none, 1 checker, 2 stripes, 3 image
    texture_scale: torch.Tensor  # [M]
    texture_color2: torch.Tensor  # [M, 3]
    bump_scale: torch.Tensor  # [M]
    bump_amp: torch.Tensor  # [M]
    texture_image: torch.Tensor  # [M] atlas slot for type 3 (-1 = none)
    brdf_model: torch.Tensor  # [M] 0 Phong, 1 Cook-Torrance GGX, 2 Ward
    roughness: torch.Tensor  # [M]
    roughness_y: torch.Tensor  # [M]
    phase_g: torch.Tensor  # [M] Henyey-Greenstein g

    @property
    def count(self) -> int:
        return self.emittance.shape[0]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole / thin-lens camera of one frame; ``fov`` is (fovx, fovy) in
    degrees."""

    resolution: tuple  # (width, height)
    position: torch.Tensor  # [3]
    view: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    fov: torch.Tensor  # [2] degrees
    aperture: torch.Tensor  # [] lens radius; 0 => pinhole
    focal_distance: torch.Tensor  # [] focus distance; <= 0 => |view|

    @property
    def width(self) -> int:
        return int(self.resolution[0])

    @property
    def height(self) -> int:
        return int(self.resolution[1])


@dataclasses.dataclass(frozen=True)
class Scene:
    geoms: Geoms
    materials: Materials
    camera: Camera
    meshes: tuple = ()  # triangle meshes: data of a later slice
    textures: Any = None  # image-texture atlas: data of a later slice

    @property
    def device(self) -> torch.device:
        return self.geoms.transform.device


def derive_fov(fovy_deg: float, width: int, height: int):
    """(fovx, fovy) in degrees, fovx from fovy and the aspect ratio."""
    yscaled = math.tan(math.radians(fovy_deg))
    xscaled = yscaled * width / height
    return (math.degrees(math.atan(xscaled)), float(fovy_deg))


@dataclasses.dataclass(frozen=True)
class SceneDescription:
    """Host-side parsed scene: all animation frames + render settings."""

    frames: int
    iterations: int
    image_name: str
    resolution: tuple  # (w, h)
    fovy: float
    eye: np.ndarray  # [F, 3]
    view: np.ndarray
    up: np.ndarray
    aperture: float
    focal_distance: float
    geom_type: np.ndarray  # [G]
    geom_material: np.ndarray  # [G]
    translations: np.ndarray  # [F, G, 3]
    rotations: np.ndarray  # [F, G, 3]
    scales: np.ndarray  # [F, G, 3]
    materials: dict  # field -> np.ndarray
    mesh_tris: tuple = ()  # per object [T, 3, 3] or None (meshes: later slice)
    texture_images: tuple = ()  # decoded images (image textures: later slice)

    def scene_for_frame(self, frame: int, device="cuda") -> Scene:
        """One animation frame as a :class:`Scene` on ``device``."""
        from pathtracer_tpu_torch.ops.transforms import build_transform

        if self.texture_images or any(t is not None for t in self.mesh_tris):
            raise NotImplementedError("scenes with meshes or image textures: later slice")
        t, inv = build_transform(
            self.translations[frame], self.rotations[frame], self.scales[frame],
            device=device,
        )
        geoms = Geoms(
            type=torch.as_tensor(self.geom_type, dtype=torch.int32, device=device),
            material_id=torch.as_tensor(
                self.geom_material, dtype=torch.int32, device=device
            ),
            transform=t,
            inv_transform=inv,
        )
        mats = Materials(
            **{
                k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
                for k, v in self.materials.items()
            }
        )
        return Scene(
            geoms=geoms, materials=mats, camera=self.camera_for_frame(frame, device=device)
        )

    def camera_for_frame(self, frame: int, device="cuda") -> Camera:
        f32 = dict(dtype=torch.float32, device=device)
        fov = derive_fov(self.fovy, self.resolution[0], self.resolution[1])
        return Camera(
            resolution=tuple(self.resolution),
            position=torch.as_tensor(self.eye[frame], **f32),
            view=torch.as_tensor(self.view[frame], **f32),
            up=torch.as_tensor(self.up[frame], **f32),
            fov=torch.as_tensor(fov, **f32),
            aperture=torch.as_tensor(self.aperture, **f32),
            focal_distance=torch.as_tensor(self.focal_distance, **f32),
        )
