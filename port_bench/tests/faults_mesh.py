"""Faults planted in the timed path of a mesh render cell, for the tests and
for the readings its limits are set from (``calibrate_mesh.py``).

``mesh_render_fault(kind)`` returns the ``program`` mapping of
``entries/mesh_render.py``: the program's own ``render``, on a scene broken
where the meshes are made.  ``flat``: the meshes' authored normals dropped,
so they shade by their face normals; ``object``: the meshes' material
scaled by 0.99 in both of its colours (smooth_mesh's gold is glossy and
renders with its specular colour); ``half``: half of the pixels' new
samples left out (``faults.render_fault``); ``dropped``: one 32-triangle
chunk of each mesh left out, the chunk of the triangles' Morton order that
holds the triangle nearest the camera.  A broken scene is made once per
scene the cell renders, so its triangle tables stay built.
"""

import dataclasses

import torch

from port_bench.tests.faults import render_fault

CHUNK = 32
SCALE = 0.99


def _nearest_chunk(scene, m):
    """The triangle indices of mesh ``m``'s Morton chunk nearest the camera."""
    from pathtracer_tpu_torch.ops.mesh_tables import morton3

    tv = m.tri_verts
    cent = (tv[:, 0] + tv[:, 1] + tv[:, 2]) / 3.0
    order = torch.argsort(morton3(cent), stable=True)
    fwd = scene.geoms.transform[m.geom_index]
    world = cent @ fwd[:3, :3].T + fwd[:3, 3]
    nearest = int(torch.argmin(((world - scene.camera.position) ** 2).sum(-1)))
    k = int((order == nearest).nonzero()[0, 0]) // CHUNK
    return order[k * CHUNK:(k + 1) * CHUNK]


def broken_scene(scene, kind: str):
    if kind == "object":
        mats = scene.materials
        ids = [int(scene.geoms.material_id[m.geom_index]) for m in scene.meshes]
        color, spec = mats.color.clone(), mats.specular_color.clone()
        color[ids] *= SCALE
        spec[ids] *= SCALE
        return dataclasses.replace(scene, materials=dataclasses.replace(
            mats, color=color, specular_color=spec))
    meshes = []
    for m in scene.meshes:
        if kind == "flat":
            m = dataclasses.replace(m, tri_norm=None)
        elif kind == "dropped":
            keep = torch.ones(m.tri_verts.shape[0], dtype=torch.bool, device=m.tri_verts.device)
            keep[_nearest_chunk(scene, m)] = False
            m = dataclasses.replace(m, tri_verts=m.tri_verts[keep], accel=None,
                                    **{a: None if getattr(m, a) is None else getattr(m, a)[keep]
                                       for a in ("tri_uv", "tri_norm")})
        else:
            raise ValueError(f"no mesh fault {kind!r}")
        meshes.append(m)
    return dataclasses.replace(scene, meshes=tuple(meshes))


def mesh_render_fault(kind):
    if kind == "half":
        return render_fault("half")
    from pathtracer_tpu_torch.render.integrator import render

    made = {}

    def broken(scene, spp, cfg, **kw):
        if made.get("of") is not scene:
            made.update(of=scene, scene=broken_scene(scene, kind))
        return render(made["scene"], spp, cfg, **kw)

    return {"render": broken}
