"""The port's sharded gradient and strided-pixel differentiable renders on
the CPU.

* ``render/diff.loss_and_grad_sharded`` on 4 CPU shards against the
  port's ``loss_and_grad`` on each differentiable engine (full-depth,
  per-bounce, lean): the loss within 1e-5 relative and every leaf within
  rtol = 2e-3, atol = 1e-5 (``tests/test_grad.py:168-184``, JAX's bar
  between its sharded and single-device gradients).
* against JAX's ``loss_and_grad_sharded`` on its 8-device mesh (the
  port's full-depth engine on 8 shards; JAX takes its lean XLA graph on
  the CPU): the loss within 1e-5 relative, every leaf within 5e-4 *
  max(gscale, 1), the bar of ``tests/test_torch_diff.py`` between the
  frameworks.
* the strided subset ``d + D*j`` of ``render_linear`` with
  ``n_global_pixels=N`` equals those rows of the whole image, bit for bit,
  on every engine, and meets JAX's ``render_linear`` on the same subset
  within rtol = atol = 2e-4 (``tests/test_render.py:120``).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pathtracer_tpu.render.diff import loss_and_grad_sharded as jax_loss_and_grad_sharded
from pathtracer_tpu.render.diff import params_from_description as jax_params
from pathtracer_tpu.render.diff import render_linear as jax_render_linear
from pathtracer_tpu.render.diff import scatter_target as jax_scatter_target
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, intersect_cuda, trace_grad
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.parallel.mesh import make_mesh
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from pathtracer_tpu_torch.scene.parser import parse_scene_text
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_diff import _flat, _jax_params_numpy

RES = (16, 16)
N = RES[0] * RES[1]
ENGINES = {
    "full_depth": dict(),
    "per_bounce": dict(grad_full_trace=False),
    "lean": dict(grad_fused=False),
}
KW = dict(max_depth=3, nee=True)


@pytest.fixture(scope="module")
def mini():
    desc = dataclasses.replace(parse_scene_text(MINI_SCENE, name="mini"), resolution=RES)
    return diff.params_from_description(desc, 0, device="cpu")


def _target():
    return torch.from_numpy(np.random.default_rng(5).random((N, 3)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_sharded_grad_matches_single_device(mini, engine):
    params, static = mini
    cfg = RenderConfig(**KW, **ENGINES[engine])
    target = _target()
    mesh = make_mesh([torch.device("cpu")] * 4)
    l1, g1 = diff.loss_and_grad(params, static, target, 2, prng_key(3), cfg, device="cpu")
    l4, g4 = diff.loss_and_grad_sharded(params, static, diff.scatter_target(target, mesh), 2,
                                        prng_key(3), cfg, mesh)
    assert l4.shape == () and abs(float(l4) - float(l1)) <= 1e-5 * abs(float(l1))
    want, got = g1.leaves(), g4.leaves()
    assert sorted(want) == sorted(got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=2e-3, atol=1e-5, msg=k)
    assert max(float(v.abs().max()) for v in want.values()) > 0


def test_sharded_grad_matches_jax():
    jdesc = dataclasses.replace(jax_parse(MINI_SCENE, name="mini"), resolution=RES)
    jp, js = jax_params(jdesc, 0)
    target = _target().numpy()
    jmesh = jax_make_mesh()
    jcfg = JaxConfig(wavefront=False, **KW)
    jl, jg = jax_loss_and_grad_sharded(jp, js, jax_scatter_target(jnp.asarray(target), jmesh),
                                       2, jax.random.PRNGKey(3), jcfg, jmesh)

    tp = params_from_numpy(_jax_params_numpy(jp), device="cpu")
    ts = diff.SceneStatic(js.geom_type, js.geom_material, js.resolution)
    mesh = make_mesh([torch.device("cpu")] * 8)
    tl, tg = diff.loss_and_grad_sharded(tp, ts, diff.scatter_target(torch.from_numpy(target), mesh),
                                        2, prng_key(3), RenderConfig(wavefront=False, **KW), mesh)
    jl, tl = float(jl), float(tl)
    print(f"loss JAX {jl:.9g} port {tl:.9g}")
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    want, got = _flat(_jax_params_numpy(jg)), _flat(params_to_numpy(tg))
    assert sorted(want) == sorted(got)
    gscale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        d = float(np.abs(want[k] - got[k]).max())
        assert d <= 5e-4 * max(gscale, 1.0), (k, d, gscale)
    assert gscale > 0


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_strided_pixels_equal_the_whole_image(mini, engine):
    """Every engine keys a strided subset's samples by the global pixel:
    shard 1 of 4 renders the rows ``1 + 4j`` of the whole image."""
    params, static = mini
    cfg = RenderConfig(**KW, **ENGINES[engine])
    pix = torch.arange(1, N, 4)
    counts = (trace_grad.fwd_launches, bounce_fused.replay_launches, bounce_grad.launches,
              intersect_cuda.winner_launches)
    whole = diff.render_linear(params, static, 2, prng_key(3), cfg)
    part, rays = diff.render_linear_rays(params, static, 2, prng_key(3), cfg, pix, N)
    assert (trace_grad.fwd_launches, bounce_fused.replay_launches, bounce_grad.launches,
            intersect_cuda.winner_launches) == counts  # the plain versions ran
    assert part.shape == (N // 4, 3) and int(rays) >= 2 * (N // 4)
    assert torch.equal(part, whole[pix])
    loss = diff.l2_loss(params, static, _target()[pix], 2, prng_key(3), cfg, pix, N)
    assert torch.isclose(loss, torch.mean((whole[pix] - _target()[pix]) ** 2))
    if engine == "lean":  # the lean engine's measure of parted pixels
        parted, fwd, _ = diff.lean_parted(params, static, 0, prng_key(3), cfg, pix, N)
        _, whole_fwd, _ = diff.lean_parted(params, static, 0, prng_key(3), cfg)
        assert parted.shape == (N // 4,) and torch.equal(fwd, whole_fwd[pix])


def test_strided_pixels_match_jax():
    jdesc = dataclasses.replace(jax_parse(MINI_SCENE, name="mini"), resolution=RES)
    jp, js = jax_params(jdesc, 0)
    pix = np.arange(2, N, 4, dtype=np.int32)
    want = np.asarray(jax_render_linear(jp, js, 2, jax.random.PRNGKey(3),
                                        JaxConfig(wavefront=False, **KW), jnp.asarray(pix), N))
    tp = params_from_numpy(_jax_params_numpy(jp), device="cpu")
    ts = diff.SceneStatic(js.geom_type, js.geom_material, js.resolution)
    got = diff.render_linear(tp, ts, 2, prng_key(3), RenderConfig(wavefront=False, **KW),
                             torch.from_numpy(pix), N).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
