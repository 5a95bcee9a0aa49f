"""Renders of the participating-media scenes through the port's engines,
against the JAX package and against each other, on the CPU; the ``sss_96``
golden; and the differentiable engines on media.

The scenes are ``scenes/glass_dof.txt`` (Beer-Lambert absorption in a
glass sphere, thin-lens depth of field), ``fog.txt`` (volumetric NEE in an
index-matched scattering cube), ``milky.txt`` (an isotropic scattering
sphere in the Cornell box) and ``sss.txt`` (Henyey-Greenstein and isotropic
scattering spheres).  Tolerances, with reasons:

* Each scene at 32x32, depth 4, NEE, 2 spp on the megakernel's plain
  version, the split route and both wavefront engines, against JAX's CPU
  ``render`` (its split XLA path), as ``tests/test_torch_mesh_render.py::
  test_renders_match_jax`` does: equal ray counts, at least 99.5% of
  accumulator entries within rtol = atol = 2e-4, sums within 2e-5 relative
  (last-ulp differences between XLA and torch, carried along the path).
* The port's engines against its megakernel at 40x40, depth 8, 2 spp:
  equal ray counts; the pinned and queue engines run the same plain bounce
  as the megakernel's loop (russian roulette is off), so at least 99.9% of
  entries within 2e-4 and sums within 1e-5; the split route's PyTorch
  shading rounds apart from the fused plain version, 99.5% and 2e-5.
* ``sss_96`` (96x96, 24 spp, depth 8, NEE: the golden's configuration)
  against ``tests/golden/sss_96.npy`` under the cornell_96 rule
  (``tests/test_torch_render.py``): at least 95% of entries within 1e-5
  relative (``tests/test_golden.py``'s entry-wise bar), the sum within
  2e-5 relative and the PNG golden's mean bar of 0.8/255.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce_fused, trace
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.imageio import load_png
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden")
MEDIA = ("glass_dof", "fog", "milky", "sss")


def _path(name):
    return os.path.join(ROOT, "scenes", f"{name}.txt")


def _counts():
    return (trace.launches, trace.vol_launches, trace.hg_launches, bounce_fused.launches,
            bounce_fused.vol_launches, bounce_fused.hg_launches)


@pytest.mark.parametrize("name", MEDIA)
def test_renders_match_jax(name):
    jscene = dataclasses.replace(jax_load_scene(_path(name)), resolution=(32, 32)).scene_for_frame(0)
    _, jacc, jst = jax_render(jscene, 2, JaxConfig(wavefront=False, nee=True, max_depth=4,
                                                  iters_per_launch=2))
    jacc = np.asarray(jacc)
    tscene = port_scene_from_jax(jscene)
    base = dict(nee=True, max_depth=4, iters_per_launch=2)
    before = _counts()
    for engine, cfg in (("megakernel", RenderConfig(**base)),
                        ("split route", RenderConfig(fused=False, **base)),
                        ("pinned wavefront", RenderConfig(wavefront=True, **base)),
                        ("queue wavefront", RenderConfig(wavefront=True, wavefront_pinned=False,
                                                         **base))):
        _, acc, st = render(tscene, 2, cfg, device="cpu")
        acc = acc.numpy()
        share = np.isclose(acc, jacc, rtol=2e-4, atol=2e-4).mean()
        sum_rel = abs(float(acc.sum()) - float(jacc.sum())) / float(jacc.sum())
        print(f"{name} {engine}: {share:.5f} of entries within 2e-4, sums within {sum_rel:.3g}")
        assert st["rays_traced"] == int(jst["rays_traced"])
        assert share >= 0.995 and sum_rel <= 2e-5
    assert _counts() == before  # CPU: the plain versions, no launch


@pytest.mark.parametrize("name", MEDIA)
def test_engines_agree(name):
    scene = dataclasses.replace(load_scene(_path(name)), resolution=(40, 40)).scene_for_frame(
        0, device="cpu")
    base = dict(nee=True, max_depth=8, iters_per_launch=2, seed=3)
    _, ref, st = render(scene, 2, RenderConfig(**base), device="cpu")
    assert float(ref.sum()) > 0
    for engine, cfg, (least, sum_tol) in (
        ("pinned", RenderConfig(wavefront=True, **base), (0.999, 1e-5)),
        ("queue", RenderConfig(wavefront=True, wavefront_pinned=False, wavefront_capacity=512,
                               **base), (0.999, 1e-5)),
        ("split", RenderConfig(fused=False, **base), (0.995, 2e-5)),
    ):
        _, acc, st_e = render(scene, 2, cfg, device="cpu")
        share = float(np.isclose(acc.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4).mean())
        sum_rel = abs(float(acc.sum()) - float(ref.sum())) / float(ref.sum())
        print(f"{name} {engine} vs megakernel: {share:.5f} within 2e-4, sums {sum_rel:.3g}")
        assert st_e["rays_traced"] == st["rays_traced"]
        assert share >= least and sum_rel <= sum_tol


def test_sss_96_golden():
    desc = dataclasses.replace(load_scene(_path("sss")), resolution=(96, 96))
    img, accum, _ = render(desc.scene_for_frame(0, device="cpu"), 24,
                           RenderConfig(nee=True, max_depth=8, iters_per_launch=8), device="cpu")
    accum = accum.numpy()
    golden = np.load(os.path.join(GOLDEN, "sss_96.npy"))
    frac = (np.abs(accum - golden) <= 1e-5 * (np.abs(golden) + 1e-3)).mean()
    sum_rel = abs(accum.sum() - golden.sum()) / abs(golden.sum())
    png = load_png(os.path.join(GOLDEN, "sss_96.png")).astype(np.float32) / 255.0
    png_mean = np.abs(img.numpy() - png).mean()
    print(f"sss_96: {frac:.5f} of entries within 1e-5, sum rel {sum_rel:.3g}, "
          f"PNG mean {png_mean * 255:.3f}/255")
    assert frac >= 0.95
    assert sum_rel <= 2e-5
    assert png_mean <= 0.8 / 255.0


@pytest.mark.parametrize("grad", [dict(), dict(grad_full_trace=False), dict(grad_fused=False)],
                         ids=["full-depth", "per-bounce", "lean"])
def test_differentiable_engines_refuse_media(grad):
    """Media differentiate on every engine (the full-depth trace, the
    per-bounce engine, the lean scan): glass_dof's render under
    ``grad_lean`` equals the forward render's, and ``loss_and_grad`` gives
    finite gradients with a nonzero gradient of the glass's absorption
    (``tests/test_torch_volume_diff.py`` holds them to JAX's)."""
    desc = dataclasses.replace(load_scene(_path("glass_dof")), resolution=(8, 8))
    scene = desc.scene_for_frame(0, device="cpu")
    cfg = RenderConfig(max_depth=4, features=("volumetric",), auto_features=False)
    _, want, _ = render(scene, 1, cfg, device="cpu")
    _, got, _ = render(scene, 1, dataclasses.replace(cfg, grad_lean=True, **grad), device="cpu")
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    loss, grads = diff.loss_and_grad(params, static, torch.zeros((64, 3)), 1, prng_key(0),
                                     RenderConfig(max_depth=4, **grad), device="cpu")
    assert float(loss) > 0
    assert all(bool(torch.isfinite(v).all()) for v in grads.leaves().values())
    absorption = grads.materials.absorption_coefficient
    print(f"{grad}: loss {float(loss):.6g}, absorption gradient {absorption.tolist()}")
    assert float(absorption.abs().max()) > 0
