"""Camera rays, tone map and image encoders of the PyTorch port vs JAX.

Tolerances: rays to 1e-6 absolute.  Both packages run the same float32
formula on the same scene numbers, but JAX's jitted ``jnp.linalg.norm``
fuses its multiply-adds (and tan/sin/cos come from different libraries),
so a direction may differ in its last ulp (~1.2e-7); DoF rays go through
one more normalize and a divide, a few ulps more.  The tone map to 1e-6
(``pow`` may differ in the last ulp); the PNG / BMP bytes of one uint8
image are identical.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops.camera import generate_camera_rays as jax_rays
from pathtracer_tpu.ops.tonemap import tonemap as jax_tonemap
from pathtracer_tpu.render.common import camera_uniforms as jax_camera_uniforms
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.utils import imageio as jio
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.ops.tonemap import tonemap
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils import imageio as tio

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.mark.parametrize("name,jitter", [("cornell", True), ("cornell", False), ("glass_dof", True)])
def test_camera_rays_match(name, jitter):
    import jax

    res = (96, 96)
    path = os.path.join(SCENES, f"{name}.txt")
    jscene = dataclasses.replace(jax_load_scene(path), resolution=res).scene_for_frame(0)
    tscene = dataclasses.replace(load_scene(path), resolution=res).scene_for_frame(0, device="cpu")
    n = res[0] * res[1]
    iteration = 3
    pix = np.arange(n)
    key = jax.random.PRNGKey(0)
    jsample = jnp.asarray(iteration * n + pix, jnp.int32)
    ju4 = jax_camera_uniforms(key, jsample, True)
    tsample = torch.from_numpy(iteration * n + pix)
    tu4 = camera_uniforms(key_to_seed(prng_key(0)), tsample)
    np.testing.assert_array_equal(tu4.numpy(), np.asarray(ju4))

    jr = jax_rays(jscene.camera, jnp.asarray(pix, jnp.int32), None, jitter=jitter, per_ray_uniforms=ju4)
    tr = generate_camera_rays(tscene.camera, torch.from_numpy(pix), tu4, jitter=jitter)
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(jr.origin), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.direction.numpy(), np.asarray(jr.direction), rtol=0, atol=1e-6)
    if name == "glass_dof":  # thin lens: the origins spread over the aperture
        assert float(tr.origin.std(0).max()) > 0.05


def test_tonemap_matches():
    rs = np.random.default_rng(0)
    accum = (rs.random((32, 24, 3)) * 40.0).astype(np.float32)
    accum[0, 0] = [-1.0, 0.0, 1e4]
    want = np.asarray(jax_tonemap(jnp.asarray(accum), 16))
    got = tonemap(torch.from_numpy(accum), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_png_and_bmp_bytes_identical(tmp_path):
    rs = np.random.default_rng(1)
    rgb = rs.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    assert tio.encode_png(rgb) == jio.encode_png(rgb)
    assert tio.encode_bmp(rgb) == jio.encode_bmp(rgb)
    img = rgb.astype(np.float32) / 255.0
    path = tio.save_image(str(tmp_path / "out.png"), img)
    np.testing.assert_array_equal(jio.load_png(path), tio.load_png(path))
    with open(path, "rb") as f:
        assert f.read() == jio.encode_png(np.clip(img * 255.0, 0, 255).astype(np.uint8))
