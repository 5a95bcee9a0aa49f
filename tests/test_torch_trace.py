"""Full-depth trace of the PyTorch port vs the JAX megakernel on the CPU.

The port's ``render.megakernel.trace_paths`` (on CPU tensors: the plain
version of the CUDA trace kernel) against
``pathtracer_tpu.render.megakernel.trace_paths`` (on the CPU: the split
per-op path, which JAX's own tests pin to the fused kernel), on the same
scene numbers, camera rays and seed: cornell at 48x48, depth 8, NEE; and
``MINI_SCENE`` with russian roulette on and NEE off.

Tolerances, with the reason: ray counts are equal exactly (a hit/miss or
russian-roulette flip would change them).  Radiance per lane to 1e-5
relative / 1e-6 absolute on at least 97% of lanes, every lane to 1e-2
relative, and the wavefront's sum to 1e-5 relative.  A path is a chain of
up to 8 bounces; a last-ulp difference in one normal (XLA's CPU rsqrt is
not torch's correctly rounded one; JAX's jitted graph fuses multiply-adds)
moves every later hit point a little, and glass refraction and grazing
geometry terms magnify it.  Measured (printed under ``pytest -s``) on
cornell 48x48: 2262 of 2304 lanes within the tight bar (98.2%), the worst
lane at 2.7e-3 relative, the sum at 2.1e-7 relative, and equal ray counts;
on MINI_SCENE every lane within the tight bar.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.ops.camera import generate_camera_rays as jax_rays
from pathtracer_tpu.render.common import camera_uniforms as jax_camera_uniforms
from pathtracer_tpu.render.diff import resolve_features as jax_resolve
from pathtracer_tpu.render.megakernel import trace_paths as jax_trace_paths
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import trace
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.megakernel import trace_paths
from pathtracer_tpu_torch.scene.structs import Rays
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_scene import port_scene_from_jax

CASES = {
    "cornell_d8_nee": ("cornell", (48, 48), dict(max_depth=8, nee=True), 0.97),
    "mini_rr_no_nee": (
        "mini", None,
        dict(max_depth=5, nee=False, russian_roulette=True, rr_start=1), 1.0,
    ),
}


def _jax_scene(name, res):
    if name == "mini":
        return jax_parse(MINI_SCENE, name="mini").scene_for_frame(0)
    path = os.path.join(os.path.dirname(__file__), "..", "scenes", f"{name}.txt")
    return dataclasses.replace(jax_load_scene(path), resolution=res).scene_for_frame(0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_paths_matches_jax(case):
    name, res, kw, min_frac = CASES[case]
    jscene = _jax_scene(name, res)
    tscene = port_scene_from_jax(jscene)
    jcfg = jax_resolve(JaxConfig(**kw), jscene.materials)
    tcfg = resolve_features(RenderConfig(**kw), tscene.materials)
    assert tcfg.features == jcfg.features

    n = jscene.camera.width * jscene.camera.height
    iteration = 1
    key = jax.random.PRNGKey(0)
    pix = jnp.arange(n, dtype=jnp.int32)
    sample = iteration * n + pix
    rays = jax_rays(
        jscene.camera, pix, None, jitter=True,
        per_ray_uniforms=jax_camera_uniforms(key, sample, True),
    )
    want, want_rays = jax_trace_paths(jscene, rays, sample, key, jcfg)
    want = np.asarray(want)

    trays = Rays(torch.from_numpy(np.array(rays.origin)), torch.from_numpy(np.array(rays.direction)))
    got, got_rays = trace_paths(
        tscene, trays, torch.from_numpy(np.array(sample)).long(), key_to_seed(prng_key(0)), tcfg
    )
    got = got.numpy()

    assert int(got_rays) == int(want_rays)
    tight = np.isclose(got, want, rtol=1e-5, atol=1e-6).all(-1)
    rel = np.abs(got - want).max(-1) / np.maximum(np.abs(want).max(-1), 1e-6)
    print(f"{case}: rays {int(got_rays)}; {int(tight.sum())} of {n} lanes within 1e-5, "
          f"worst {rel.max():.3g} relative, sum rel {abs(got.sum() - want.sum()) / abs(want.sum()):.3g}")
    assert tight.mean() >= min_frac, f"{(~tight).sum()} of {n} lanes beyond 1e-5"
    assert rel.max() <= 1e-2, f"worst lane {rel.max():.3g} relative"
    assert abs(got.sum() - want.sum()) <= 1e-5 * abs(want.sum())


def test_trace_dispatch_on_device():
    """CPU tensors take the plain version; the kernel wrapper refuses
    anything but CUDA tensors (nothing falls back)."""
    tscene = port_scene_from_jax(_jax_scene("mini", None))
    cfg = resolve_features(RenderConfig(max_depth=2), tscene.materials)
    tables = pack_tables(tscene)
    o = torch.tensor([[0.0, 2.5, 9.0]]).repeat(4, 1)
    d = torch.tensor([[0.0, -0.15, -1.0]]).repeat(4, 1)
    d = d / d.norm(dim=-1, keepdim=True)
    sample = torch.arange(4)
    before = trace.launches
    rad, nrays = trace.trace_fused(tscene, Rays(o, d), sample, 5, cfg, tables=tables)
    assert rad.shape == (4, 3) and int(nrays) > 0
    assert trace.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        trace.trace_cuda(*tables, 5, o, d, sample, max_depth=2, nee=True, rr=False, rr_start=3)
    bad = dataclasses.replace(
        tscene, geoms=dataclasses.replace(tscene.geoms, material_id=tscene.geoms.material_id + 9)
    )
    with pytest.raises(ValueError, match="material ids"):
        pack_tables(bad)
    with pytest.raises(NotImplementedError, match="volumetric"):
        trace.trace_fused(
            tscene, Rays(o, d), sample, 5, dataclasses.replace(cfg, features=("volumetric",))
        )
