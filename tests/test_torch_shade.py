"""The port's per-bounce step and its intersection kernels' plain versions
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
scenes cross through ``tests/test_torch_scene.port_scene_from_jax``.

* ``nearest_hit_plain`` / ``occlusion_t_plain`` (kernels 6 and 8) against
  JAX's ``nearest_hit_planes`` / ``occlusion_t_planes`` run in interpret
  mode (``tests/test_pallas.py:30-68``'s pattern): hit flags, geom and
  material ids equal; ``t``, the world hit point and the normal within
  1e-5 (XLA's CPU sweep and torch round the last ulps differently:
  measured up to 1.2e-6 relative on ``t``, 4.4e-6 absolute on the point
  and 2.8e-6 on the normal); the object-space point within 1e-4,
  ``test_pallas.py``'s bar for the frame (it is ``o_obj + t d_obj``, a
  difference of terms tens of times its size inside Cornell's scaled
  walls: measured up to 7.4e-5).
* ``shade_bounce``, both of the port's routes, against JAX's split
  ``shade_bounce(..., RenderConfig(pallas=False, fused=False))`` on 1,024
  random lanes with mixed depth and emit state, NEE on and off, with
  ``tests/test_pallas.py:167-221``'s bar: terminate, emit state and the
  russian-roulette uniform equal on every lane; contrib, next origin and
  direction, throughput multiplier and medium within rtol 2e-4, atol 2e-5
  on live lanes.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.ops.intersect_pallas import nearest_hit_planes, occlusion_t_planes
from pathtracer_tpu.render.common import shade_bounce as jax_shade_bounce
from pathtracer_tpu.render.diff import resolve_features as jax_resolve_features
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse_scene_text
from pathtracer_tpu.scene.structs import Rays as JaxRays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.intersect import nearest_hit_plain, occlusion_t_plain
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.scene.structs import Rays
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_scene import port_scene_from_jax

# MINI_SCENE with its mirror sphere turned Phong-glossy (the glossy lobe)
GLOSSY_MINI = MINI_SCENE.replace("SPECEX 0\nSPECRGB .95 .92 .9", "SPECEX 30\nSPECRGB .95 .92 .9")


def random_lanes(n: int, seed: int = 0) -> dict:
    """Numpy lanes of one bounce: rays from around the scene's centre,
    throughput, sample index, depth 0..7 and emit state 0/1/2."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    return dict(
        origin=(rng.standard_normal((n, 3)) * 3.0).astype(np.float32),
        direction=(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
        throughput=rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        sample=rng.integers(0, 10_000_000, n).astype(np.int32),
        depth=rng.integers(0, 8, n).astype(np.int32),
        prev=rng.choice(np.array([0.0, 1.0, 2.0], np.float32), n, p=[0.6, 0.3, 0.1]),
    )


def _jax_scene(name, cornell_scene):
    if name == "cornell":
        return cornell_scene
    return jax_parse_scene_text(GLOSSY_MINI, name="glossy").scene_for_frame(0)


@pytest.mark.parametrize("name", ["cornell", "glossy"])
def test_nearest_and_occlusion_plain_match_jax_kernels(cornell_scene, name):
    jscene = _jax_scene(name, cornell_scene)
    lanes = random_lanes(300, seed=3)
    jrays = JaxRays(origin=jnp.asarray(lanes["origin"]), direction=jnp.asarray(lanes["direction"]))
    want = nearest_hit_planes(jrays, jscene.geoms, interpret=True)
    want_occ = np.asarray(occlusion_t_planes(jrays, jscene.geoms, interpret=True))

    tscene = port_scene_from_jax(jscene)
    gtab = pack_tables(tscene)[0]
    rays = Rays(origin=torch.from_numpy(lanes["origin"]),
                direction=torch.from_numpy(lanes["direction"]))
    got = nearest_hit_plain(rays, gtab)
    # the dispatch takes the plain version for CPU tensors, without a launch
    before = (intersect_cuda.nearest_launches, intersect_cuda.occlusion_launches)
    via = intersect_cuda.nearest_hit(rays, gtab)
    assert torch.equal(via.t, got.t) and torch.equal(via.normal, got.normal)
    got_occ = intersect_cuda.occlusion_t(rays, gtab)
    assert (intersect_cuda.nearest_launches, intersect_cuda.occlusion_launches) == before

    hit = np.asarray(want.hit)
    assert 0.2 < hit.mean() < 1.0  # both hits and misses
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.geom_id.numpy(), np.asarray(want.geom_id))
    np.testing.assert_array_equal(got.material_id.numpy(), np.asarray(want.material_id))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=0)
    for f, tol in (("position", 1e-5), ("position_obj", 1e-4), ("normal", 1e-5)):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=tol, atol=tol, err_msg=f)
    np.testing.assert_allclose(got_occ.numpy(), want_occ, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(occlusion_t_plain(rays, gtab).numpy(), got_occ.numpy())
    # the occlusion sweep is the nearest hit's t
    np.testing.assert_array_equal(got_occ.numpy(), got.t.numpy())


def _compare_bounce(ref, got, tag):
    """``tests/test_pallas.py:202-221``'s bar; ``ref`` JAX's, ``got`` the
    port's ``BounceResult``."""
    np.testing.assert_array_equal(got.terminate.numpy(), np.asarray(ref.terminate), tag)
    np.testing.assert_array_equal(got.was_specular.numpy(), np.asarray(ref.was_specular), tag)
    np.testing.assert_array_equal(got.rr_uniform.numpy(), np.asarray(ref.rr_uniform), tag)
    live = ~np.asarray(ref.terminate)
    assert 0.2 < live.mean() < 0.95
    for f in ("contrib", "next_origin", "next_direction", "throughput_mult", "next_medium"):
        np.testing.assert_allclose(getattr(got, f).numpy()[live], np.asarray(getattr(ref, f))[live],
                                   rtol=2e-4, atol=2e-5, err_msg=f"{f} ({tag})")


@pytest.mark.parametrize("name", ["cornell", "glossy"])
@pytest.mark.parametrize("nee", [True, False])
def test_shade_bounce_both_routes_match_jax_split(cornell_scene, name, nee):
    jscene = _jax_scene(name, cornell_scene)
    features = jax_resolve_features(JaxConfig(), jscene.materials).features
    lanes = random_lanes(1024, seed=11)
    n = 1024
    key = jax.random.PRNGKey(7)
    jrays = JaxRays(origin=jnp.asarray(lanes["origin"]), direction=jnp.asarray(lanes["direction"]))
    ref = jax_shade_bounce(
        jscene, jrays, jnp.asarray(lanes["throughput"]), jnp.asarray(lanes["sample"]),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]), key,
        JaxConfig(nee=nee, pallas=False, fused=False, features=features),
        medium_sigma=jnp.zeros((n, 4), jnp.float32),
    )

    tscene = port_scene_from_jax(jscene)
    rays = Rays(origin=torch.from_numpy(lanes["origin"]),
                direction=torch.from_numpy(lanes["direction"]))
    args = (tscene, rays, torch.from_numpy(lanes["throughput"]),
            torch.from_numpy(lanes["sample"]).long(), torch.from_numpy(lanes["depth"]),
            torch.from_numpy(lanes["prev"]), key_to_seed(prng_key(7)))
    before = bounce_fused.launches
    for fused in (None, False):
        cfg = RenderConfig(nee=nee, fused=fused, features=features)
        _compare_bounce(ref, shade_bounce(*args, cfg), f"fused={fused}, nee={nee}")
    assert bounce_fused.launches == before  # CPU tensors take the plain versions
    # the surface features run forward and differentiably: on materials that
    # select none of their blocks, the same bounce
    cfg = RenderConfig(nee=nee, features=(*features, "texture"), grad_lean=True)
    _compare_bounce(ref, shade_bounce(*args, cfg), f"texture, grad_lean, nee={nee}")
    # media in a vacuum scene with a vacuum carry: the same bounce on both
    # routes (zero sigmas attenuate by exactly 1 and never scatter)
    for fused in (None, False):
        cfg = RenderConfig(nee=nee, fused=fused, features=(*features, "volumetric"))
        _compare_bounce(ref, shade_bounce(*args, cfg), f"volumetric, fused={fused}, nee={nee}")
    # under grad_lean both differentiable routes give the same bounce: the
    # per-bounce engine's (kernel 2 with replay planes) and, outside the
    # fused scope, the lean split route (kernels 7 and 8)
    for grad_fused in (None, False):
        cfg = RenderConfig(nee=nee, features=features, grad_lean=True, grad_fused=grad_fused)
        _compare_bounce(ref, shade_bounce(*args, cfg), f"grad_lean, grad_fused={grad_fused}")


def test_bounce_fused_plain_takes_int_or_lane_depth():
    """An int depth and the same depth on every lane give the same bounce;
    the medium passes through."""
    from pathtracer_tpu_torch.scene.parser import parse_scene_text

    scene = parse_scene_text(GLOSSY_MINI, name="glossy").scene_for_frame(0, device="cpu")
    tables = pack_tables(scene)
    lanes = random_lanes(200, seed=5)
    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    medium = torch.rand(200, 4)
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long())
    a = bounce_fused.bounce_fused_plain(*args, 3, t["prev"], medium, 99, nee=True)
    b = bounce_fused.bounce_fused_plain(*args, torch.full((200,), 3, dtype=torch.int32),
                                        t["prev"], medium, 99, nee=True)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert torch.equal(a.next_medium, medium)
