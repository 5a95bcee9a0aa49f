"""Build the port's :class:`Scene` from plain numpy arrays.

A scene's arrays are its "weights": with this converter, a scene built by
any other means (the JAX package's ``Scene``, a saved file) crosses into
the port unchanged, bit for bit, and both packages render the very same
numbers.  ``d`` holds

* ``type``, ``material_id`` (``[G]`` ints), ``transform``,
  ``inv_transform`` (``[G, 4, 4]``);
* ``materials``: one array per field of :class:`Materials`;
* ``camera``: ``resolution`` (w, h), ``position``, ``view``, ``up``,
  ``fov`` (degrees), ``aperture``, ``focal_distance``.
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracer_tpu_torch.scene.structs import (
    MATERIAL_FIELDS,
    Camera,
    Geoms,
    Materials,
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
    return Scene(geoms=geoms, materials=materials, camera=camera)
