"""Scene data model: struct-of-arrays dataclasses of torch tensors.

Port of ``pathtracer_tpu/scene/structs.py:31-33,49-307``: ``Rays``,
``Geoms``, ``Materials``, ``Camera``, ``MeshInstance``, ``Scene`` and
``SceneDescription`` with ``mesh_tris_for_frame`` / ``scene_for_frame`` /
``camera_for_frame``.  One tensor per field, on the device the caller names.
A mesh of at least :data:`ACCEL_MIN_TRIS` triangles gets its chunked LBVH
(``ops/accel.py``) when its frame is built.  Two packed forms of the meshes
are built once, on first use: a mesh's ``(v0, e1, e2)`` table of kernels 9
and 10 (:attr:`MeshInstance.scan_table`) and the scene's in-kernel tables of
kernels 1 and 2 (:attr:`Scene.mesh_tables`).  A scene's image textures
become one ``ops/texture.TextureAtlas`` on its device (``:284-288``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

SPHERE = 0
CUBE = 1
MESH = 2

# meshes with at least this many triangles get a chunked-LBVH accel
# structure (ops/accel.py); below it the split route sweeps file order
ACCEL_MIN_TRIS = 256

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
class MeshInstance:
    """A triangle mesh bound to the geom slot ``geom_index`` (type MESH):
    triangles in the mesh's object space, placed by that geom's transform.
    Authored attributes are in file order; ``accel.scan_to_file`` maps the
    LBVH's scan order to it."""

    geom_index: int
    tri_verts: torch.Tensor  # [T, 3, 3] float32
    accel: Any = None  # ops/accel.MeshAccel, or None (below ACCEL_MIN_TRIS)
    tri_uv: Any = None  # [T, 3, 2] float32 authored texture coordinates
    tri_norm: Any = None  # [T, 3, 3] float32 authored unit shading normals

    @property
    def has_attrs(self) -> bool:
        return self.tri_uv is not None or self.tri_norm is not None

    @functools.cached_property
    def scan_table(self) -> torch.Tensor:
        """The ``[T * 9]`` ``(v0, e1, e2)`` table of kernels 9 and 10 in
        scan order, without the LBVH's pad rows (``ops/mesh.py``); detached,
        as the searches it serves."""
        from pathtracer_tpu_torch.ops.mesh import pack_tri_table

        if self.accel is None:
            return pack_tri_table(self.tri_verts.detach())
        return pack_tri_table(self.accel.chunks.detach().reshape(-1, 3, 3)[: self.accel.n_tris])

    @functools.cached_property
    def scan_boxes(self) -> torch.Tensor:
        """The padded ``[C, 6]`` boxes of :attr:`scan_table`'s chunks of 128
        rows, which kernels 9 and 10 cull with (``ops/mesh.
        mesh_chunk_boxes``); detached, built once."""
        from pathtracer_tpu_torch.ops.mesh import mesh_chunk_boxes

        return mesh_chunk_boxes(self)


@dataclasses.dataclass(frozen=True)
class Scene:
    geoms: Geoms
    materials: Materials
    camera: Camera
    meshes: tuple = ()  # MeshInstance per mesh geom
    textures: Any = None  # ops/texture.TextureAtlas of the image textures, or None

    @property
    def device(self) -> torch.device:
        return self.geoms.transform.device

    @functools.cached_property
    def mesh_tables(self):
        """The in-kernel triangle tables of kernels 1 and 2
        (``ops/mesh_tables.KernelMeshes``), or None for a scene without
        meshes or with more triangles than they take."""
        from pathtracer_tpu_torch.ops.mesh_tables import kernel_meshes

        return kernel_meshes(self.meshes)


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
    mesh_tris: tuple = ()  # per object [T, 3, 3] float32, or None
    texture_images: tuple = ()  # decoded linear-light [H, W, 3] images, one per atlas slot
    # per object a tuple of per-frame [T, 3, 3] arrays (FILE lines), or None
    mesh_tris_frames: tuple = ()
    # per object (uv [T, 3, 2] | None, norm [T, 3, 3] | None), or None
    mesh_attrs: tuple = ()

    def mesh_tris_for_frame(self, frame: int) -> tuple:
        """Per-object triangle arrays at ``frame``: a deforming mesh's array
        of that frame, a rigid mesh's only one, None for other objects."""
        anim = self.mesh_tris_frames or ()
        return tuple(
            anim[g][frame] if g < len(anim) and anim[g] is not None else tris
            for g, tris in enumerate(self.mesh_tris or ())
        )

    def scene_for_frame(self, frame: int, device="cuda") -> Scene:
        """One animation frame as a :class:`Scene` on ``device``."""
        from pathtracer_tpu_torch.ops.accel import build_mesh_accel
        from pathtracer_tpu_torch.ops.transforms import build_transform

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

        def f32(a):
            return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)

        meshes = []
        for g, tris in enumerate(self.mesh_tris_for_frame(frame)):
            if tris is None:
                continue
            attrs = self.mesh_attrs[g] if g < len(self.mesh_attrs) else None
            uv, norm = attrs if attrs else (None, None)
            accel = build_mesh_accel(tris, device=device) if len(tris) >= ACCEL_MIN_TRIS else None
            meshes.append(MeshInstance(geom_index=g, tri_verts=f32(tris), accel=accel,
                                       tri_uv=f32(uv), tri_norm=f32(norm)))
        textures = None
        if self.texture_images:
            from pathtracer_tpu_torch.ops.texture import build_atlas

            textures = build_atlas(self.texture_images, device=device)
        return Scene(
            geoms=geoms, materials=mats, camera=self.camera_for_frame(frame, device=device),
            meshes=tuple(meshes), textures=textures,
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
