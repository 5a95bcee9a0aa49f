"""Build the port's :class:`Scene` from plain numpy arrays.

A scene's arrays are its "weights": with this converter, a scene built by
any other means (the JAX package's ``Scene``, a saved file) crosses into
the port unchanged, bit for bit, and both packages render the very same
numbers.  ``d`` holds

* ``type``, ``material_id`` (``[G]`` ints), ``transform``,
  ``inv_transform`` (``[G, 4, 4]``);
* ``materials``: one array per field of :class:`Materials`;
* ``camera``: ``resolution`` (w, h), ``position``, ``view``, ``up``,
  ``fov`` (degrees), ``aperture``, ``focal_distance``;
* ``meshes`` (optional): per mesh instance ``geom_index``, ``tri_verts``
  (``[T, 3, 3]``), ``tri_norm`` / ``tri_uv`` (or None) and ``accel``: None
  or the LBVH's ``n_tris``, ``chunks``, ``lo``, ``hi``, ``root_lo``,
  ``root_hi``, ``scan_to_file``;
* ``textures`` (optional): None or the image atlas's ``data`` (``[K, H, W,
  3]``) and ``hw`` (``[K, 2]``).

The differentiable render's state crosses the same way:
:func:`params_from_numpy` takes the leaves of a ``SceneParams`` as numpy
(``materials`` as a dict of fields, then ``translations``, ``rotations``,
``scales``, ``cam_position``, ``cam_view``, ``cam_up``, ``cam_fov``,
``cam_aperture``, ``cam_focal`` and, optionally, ``mesh_verts``: a list of
``[T, 3, 3]`` arrays, and ``textures``: the image atlas's ``data`` and
``hw``, as the scene's), and :func:`params_to_numpy` gives a port
``SceneParams`` (its gradients, say) back in that form.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracer_tpu_torch.ops.accel import MeshAccel
from pathtracer_tpu_torch.ops.texture import TextureAtlas
from pathtracer_tpu_torch.scene.structs import (
    MATERIAL_FIELDS,
    Camera,
    Geoms,
    Materials,
    MeshInstance,
    Scene,
)


def scene_from_numpy(d: dict, device="cuda") -> Scene:
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.array(x, np.int32), device=device)

    geoms = Geoms(
        type=i32(d["type"]),
        material_id=i32(d["material_id"]),
        transform=f32(d["transform"]),
        inv_transform=f32(d["inv_transform"]),
    )
    materials = Materials(**{k: f32(d["materials"][k]) for k in MATERIAL_FIELDS})
    c = d["camera"]
    camera = Camera(
        resolution=tuple(int(v) for v in c["resolution"]),
        position=f32(c["position"]),
        view=f32(c["view"]),
        up=f32(c["up"]),
        fov=f32(c["fov"]),
        aperture=f32(c["aperture"]),
        focal_distance=f32(c["focal_distance"]),
    )

    def opt(x):
        return None if x is None else f32(x)

    meshes = []
    for m in d.get("meshes", ()):
        a = m["accel"]
        accel = None if a is None else MeshAccel(
            n_tris=int(a["n_tris"]), scan_to_file=i32(a["scan_to_file"]),
            **{k: f32(a[k]) for k in ("chunks", "lo", "hi", "root_lo", "root_hi")},
        )
        meshes.append(MeshInstance(geom_index=int(m["geom_index"]), tri_verts=f32(m["tri_verts"]),
                                   accel=accel, tri_uv=opt(m["tri_uv"]),
                                   tri_norm=opt(m["tri_norm"])))
    tex = d.get("textures")
    textures = None if tex is None else TextureAtlas(data=f32(tex["data"]), hw=f32(tex["hw"]))
    return Scene(geoms=geoms, materials=materials, camera=camera, meshes=tuple(meshes),
                 textures=textures)


PARAM_FIELDS = (
    "translations", "rotations", "scales", "cam_position", "cam_view", "cam_up",
    "cam_fov", "cam_aperture", "cam_focal",
)


def params_from_numpy(d: dict, device="cuda"):
    """The port's ``render.diff.SceneParams`` holding ``d``'s numbers."""
    from pathtracer_tpu_torch.render.diff import SceneParams

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    tex = d.get("textures")
    return SceneParams(
        materials=Materials(**{k: f32(d["materials"][k]) for k in MATERIAL_FIELDS}),
        mesh_verts=tuple(f32(v) for v in d.get("mesh_verts", ())),
        textures=None if tex is None else TextureAtlas(data=f32(tex["data"]), hw=f32(tex["hw"])),
        **{k: f32(d[k]) for k in PARAM_FIELDS},
    )


def params_to_numpy(p) -> dict:
    """A port ``SceneParams`` as the numpy dict of :func:`params_from_numpy`."""

    def arr(x):
        return x.detach().cpu().numpy()

    out = {k: arr(getattr(p, k)) for k in PARAM_FIELDS}
    out["materials"] = {k: arr(getattr(p.materials, k)) for k in MATERIAL_FIELDS}
    if p.mesh_verts:
        out["mesh_verts"] = [arr(v) for v in p.mesh_verts]
    if p.textures is not None:
        out["textures"] = {"data": arr(p.textures.data), "hw": arr(p.textures.hw)}
    return out
