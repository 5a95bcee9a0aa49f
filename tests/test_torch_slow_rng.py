"""``RenderConfig(fast_rng=False)`` in the port vs the JAX package's on the CPU.

Under ``fast_rng=False`` every uniform is threefry's (``ops/threefry.py``):
the renders take the per-bounce scan and the wavefront engines on the split
route (the kernels draw the counter hash), the gradient the lean engine,
as JAX's do (``pathtracer_tpu/render/common.py:145-190``,
``megakernel.py:44-80``, ``diff.py:322-326``).

Bars (ROADMAP's "Golden bar" and "Gradients against JAX's lean CPU
backward"):

* renders, Cornell 32x32, depth 4, 2 spp: at least 95% of accumulator
  entries within rtol = atol = 1e-5 of JAX's and the sums within 2e-5
  relative, ray counts equal.  Not every entry: JAX's XLA and the port's
  PyTorch round apart in the last ulp, and bounces magnify that; measured
  99.5% of entries, sums within 6e-7 at 48x48.
* ``loss_and_grad``, Cornell 16x16, depth 3, 2 spp: the loss within 1e-6
  relative (measured 1.4e-7 at 24x24, depth 4), every leaf within 5e-4 of
  the largest gradient (measured 5e-5).

Also: the warning and the split route when ``fused`` is None or True, and
the fused kernels' direct entries refusing ``fast_rng=False`` as JAX's do.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render.diff import loss_and_grad as jax_loss_and_grad
from pathtracer_tpu.render.diff import params_from_description as jax_params
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda, trace, trace_grad
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from pathtracer_tpu_torch.scene.parser import load_scene
from tests.test_torch_diff import _flat, _jax_params_numpy
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "scenes", "cornell.txt")
SLOW = dict(fast_rng=False, max_depth=4)
ENGINES = {
    "megakernel": dict(),
    "pinned": dict(wavefront=True),
    "queue": dict(wavefront=True, wavefront_pinned=False, wavefront_capacity=1 << 9),
}


def _counts():
    return (trace.launches, bounce_fused.launches, intersect_cuda.nearest_launches,
            intersect_cuda.occlusion_launches)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_slow_rng_render_matches_jax(engine):
    res, spp = (32, 32), 2
    jscene = jax_load_scene(CORNELL).scene_for_frame(0)
    jscene = dataclasses.replace(jscene, camera=dataclasses.replace(jscene.camera, resolution=res))
    kw = dict(SLOW, iters_per_launch=spp, **ENGINES[engine])
    _, want, jstats = jax_render(jscene, spp, JaxConfig(**kw))
    want = np.asarray(want)
    before = _counts()
    with pytest.warns(UserWarning, match=r"auto-disabled \(fast_rng=False\)"):
        _, got, stats = render(port_scene_from_jax(jscene), spp, RenderConfig(**kw), device="cpu")
    assert _counts() == before  # the plain versions ran
    got = got.numpy()
    share = float(np.isclose(got, want, rtol=1e-5, atol=1e-5).mean())
    sum_rel = abs(float(got.sum()) - float(want.sum())) / abs(float(want.sum()))
    print(f"{engine}: {share:.5f} of entries within 1e-5 of JAX, sums within {sum_rel:.3g}")
    assert stats["rays_traced"] == int(jstats["rays_traced"])
    assert share >= 0.95
    assert sum_rel <= 2e-5
    # threefry's samples are not the counter hash's
    _, fast, _ = render(port_scene_from_jax(jscene), spp,
                        RenderConfig(**dict(kw, fast_rng=True)), device="cpu")
    assert not np.allclose(fast.numpy(), got, rtol=1e-3, atol=1e-3)


def test_slow_rng_loss_and_grad_matches_jax():
    res, spp, seed = (16, 16), 2, 7
    jdesc = dataclasses.replace(jax_load_scene(CORNELL), resolution=res)
    jp, js = jax_params(jdesc, 0)
    n = res[0] * res[1]
    kw = dict(fast_rng=False, max_depth=3, wavefront=False)
    jl, jg = jax_loss_and_grad(jp, js, jnp.zeros((n, 3), jnp.float32), spp,
                               jax.random.PRNGKey(seed), JaxConfig(**kw))
    tp = params_from_numpy(_jax_params_numpy(jp), device="cpu")
    ts = diff.SceneStatic(js.geom_type, js.geom_material, js.resolution)
    tl, tg, rays = diff.loss_and_grad_rays(tp, ts, torch.zeros((n, 3)), spp, prng_key(seed),
                                           RenderConfig(**kw), device="cpu")
    jl, tl = float(jl), float(tl)
    print(f"loss JAX {jl:.9g} port {tl:.9g}")
    assert rays.dtype == torch.int64 and int(rays) >= spp * n
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    want, got = _flat(_jax_params_numpy(jg)), _flat(params_to_numpy(tg))
    gscale = max(float(np.abs(v).max()) for v in want.values())
    worst = max(float(np.abs(want[k] - got[k]).max()) for k in want)
    print(f"gscale {gscale:.4g}, worst leaf {worst:.3g} ({worst / gscale:.3g} of it)")
    assert gscale > 0 and worst <= 5e-4 * max(gscale, 1.0)


@pytest.fixture(scope="module")
def lanes():
    scene = dataclasses.replace(load_scene(CORNELL), resolution=(8, 6)).scene_for_frame(
        0, device="cpu")
    pix = torch.arange(48)
    seed = KeyedSeed(prng_key(3))
    rays = generate_camera_rays(scene.camera, pix, camera_uniforms(seed, pix, fast_rng=False))
    return scene, rays, pix, seed


def test_shade_bounce_takes_the_split_route_and_warns(lanes):
    """``fused`` None or True under ``fast_rng=False``: JAX's two warnings
    and the split route's result (``fused=False``, which does not warn),
    equal in every field."""
    scene, rays, pix, seed = lanes
    args = (scene, rays, torch.ones(48, 3), pix, 1, torch.zeros(48), seed)
    cfg = RenderConfig(fast_rng=False, features=())
    want = shade_bounce(*args, dataclasses.replace(cfg, fused=False))
    for fused, msg in ((None, "auto-disabled"), (True, r"cfg.fused=True unsupported")):
        with pytest.warns(UserWarning, match=msg):
            got = shade_bounce(*args, dataclasses.replace(cfg, fused=fused))
        for f in dataclasses.fields(got):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


def test_fused_entries_refuse_slow_rng(lanes):
    """The kernels' direct entries draw the counter hash and decline
    ``fast_rng=False``, as JAX's (``trace_pallas.py:196``, ``common.py:88``)."""
    scene, rays, pix, seed = lanes
    cfg = RenderConfig(fast_rng=False, features=(), max_depth=2)
    tables = pack_tables(scene)
    with pytest.raises(NotImplementedError, match="fast_rng=False"):
        trace.trace_fused(scene, rays, pix, seed, cfg, tables=tables)
    with pytest.raises(NotImplementedError, match="fast_rng=False"):
        bounce_fused.bounce_fused(scene, rays.origin, rays.direction, torch.ones(48, 3), pix, 0,
                                  torch.zeros(48), None, seed, cfg, tables=tables)
    with pytest.raises(NotImplementedError, match="fast_rng=False"):
        trace_grad.trace_fused_diff(scene, rays, pix, seed,
                                    dataclasses.replace(cfg, grad_lean=True), tables=tables)
