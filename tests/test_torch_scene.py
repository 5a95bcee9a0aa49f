"""Scene data of the PyTorch port vs the JAX package.

The port's parser and ``scene_from_numpy`` against
``pathtracer_tpu.scene.parser.load_scene(...).scene_for_frame(0)``.
Tolerances: integers and material values exact (both parse the same
decimal text to float32); transforms to 1e-6 absolute (both build them in
float32 from the same TRS, with the 3x3 products summed in the same order,
so any difference is a last-ulp rounding of cos/sin).  The resolved feature
tuples are equal.

``jax_scene_arrays`` is shared with the other ``test_torch_*`` files: it is
how a JAX ``Scene`` crosses into the port bit for bit.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render.diff import resolve_features as jax_resolve
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.scene.convert import scene_from_numpy
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.scene.structs import MATERIAL_FIELDS

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENES = os.path.join(ROOT, "scenes")
ANALYTIC = ["cornell", "glass_dof", "fog", "milky", "sss", "ward", "animation"]


def jax_scene_arrays(scene) -> dict:
    """A JAX ``Scene`` as the numpy dict of ``scene_from_numpy``."""
    g, m, c = scene.geoms, scene.materials, scene.camera
    return dict(
        type=np.asarray(g.type),
        material_id=np.asarray(g.material_id),
        transform=np.asarray(g.transform),
        inv_transform=np.asarray(g.inv_transform),
        materials={k: np.asarray(getattr(m, k)) for k in MATERIAL_FIELDS},
        camera=dict(
            resolution=c.resolution,
            position=np.asarray(c.position),
            view=np.asarray(c.view),
            up=np.asarray(c.up),
            fov=np.asarray(c.fov),
            aperture=np.asarray(c.aperture),
            focal_distance=np.asarray(c.focal_distance),
        ),
    )


def port_scene_from_jax(scene, resolution=None):
    """The port's CPU ``Scene`` holding exactly the JAX scene's numbers."""
    if resolution is not None:
        scene = dataclasses.replace(
            scene, camera=dataclasses.replace(scene.camera, resolution=resolution)
        )
    return scene_from_numpy(jax_scene_arrays(scene), device="cpu")


def _compare(jscene, tscene):
    jg, tg = jscene.geoms, tscene.geoms
    np.testing.assert_array_equal(tg.type.numpy(), np.asarray(jg.type))
    np.testing.assert_array_equal(tg.material_id.numpy(), np.asarray(jg.material_id))
    np.testing.assert_allclose(tg.transform.numpy(), np.asarray(jg.transform), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tg.inv_transform.numpy(), np.asarray(jg.inv_transform), rtol=0, atol=1e-6
    )
    for k in MATERIAL_FIELDS:
        np.testing.assert_array_equal(
            getattr(tscene.materials, k).numpy(), np.asarray(getattr(jscene.materials, k)), k
        )
    jc, tc = jscene.camera, tscene.camera
    assert tc.resolution == tuple(jc.resolution)
    for k in ("position", "view", "up", "fov", "aperture", "focal_distance"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)), k)


@pytest.mark.parametrize("name", ANALYTIC)
def test_parser_matches_jax(name):
    path = os.path.join(SCENES, f"{name}.txt")
    jdesc = jax_load_scene(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tdesc = load_scene(path)
    assert (tdesc.frames, tdesc.iterations, tdesc.image_name) == (
        jdesc.frames, jdesc.iterations, jdesc.image_name
    )
    for frame in range(tdesc.frames):
        jscene = jdesc.scene_for_frame(frame)
        tscene = tdesc.scene_for_frame(frame, device="cpu")
        _compare(jscene, tscene)
    jfeat = jax_resolve(JaxConfig(), jscene.materials).features
    assert resolve_features(RenderConfig(), tscene.materials).features == jfeat


@pytest.mark.parametrize("name", ["cornell", "glass_dof"])
def test_scene_from_numpy_is_exact(name):
    jscene = jax_load_scene(os.path.join(SCENES, f"{name}.txt")).scene_for_frame(0)
    tscene = port_scene_from_jax(jscene)
    np.testing.assert_array_equal(tscene.geoms.transform.numpy(), np.asarray(jscene.geoms.transform))
    np.testing.assert_array_equal(
        tscene.geoms.inv_transform.numpy(), np.asarray(jscene.geoms.inv_transform)
    )
    _compare(jscene, tscene)


def test_cornell_resolves_to_base_physics():
    scene = load_scene(os.path.join(SCENES, "cornell.txt")).scene_for_frame(0, device="cpu")
    assert resolve_features(RenderConfig(), scene.materials).features == ()
    assert scene.geoms.count == 9 and scene.materials.count == 7
    pinned = RenderConfig(features=("glossy",))
    assert resolve_features(pinned, scene.materials) is pinned


@pytest.mark.parametrize("name", ["mesh_demo", "textured_image"])
def test_assets_wait_for_their_slice(name):
    with pytest.raises(NotImplementedError, match="later slice"):
        load_scene(os.path.join(SCENES, f"{name}.txt"))


def test_scene_for_frame_places_tensors_on_device():
    scene = load_scene(os.path.join(SCENES, "cornell.txt")).scene_for_frame(0, device="cpu")
    assert scene.device == torch.device("cpu")
    assert scene.geoms.transform.dtype == torch.float32
