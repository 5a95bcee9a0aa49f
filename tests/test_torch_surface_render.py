"""Renders of the surface-physics scenes through the port's engines, against
the JAX package and against each other, on the CPU; the ``ward_96`` and
``textured_image_96`` goldens; the differentiable engines' refusal of the
surface features; and image textures on meshes against JAX.

The scenes are ``scenes/ward.txt`` (an anisotropic Ward floor and an
isotropic Ward sphere), ``textured.txt`` (checker floor and walls, a bumped
sphere, mirror and glass) and ``textured_image.txt`` (an image-textured
cube and sphere).  Tolerances, with reasons:

* Each scene at 32x32, depth 4, NEE, 2 spp on the megakernel route (its
  plain version: the trace for ward and textured, the per-bounce scan with
  the deferred texel for textured_image), the split route and both
  wavefront engines, against JAX's CPU ``render`` (its split XLA path), as
  ``tests/test_torch_volume_render.py`` does: equal ray counts; ward and
  textured_image at least 99.5% of accumulator entries within rtol = atol =
  2e-4 and sums within 2e-5 relative.  textured by a share of entries, as
  ROADMAP queue 3's golden bar: the bump's ``sin`` of phases near 10^3 rad
  and the checker-cell edges turn one-ulp differences between XLA and
  torch into whole lanes that take another path, so at least 98% of
  entries within 2e-4 and the sums within 1e-4 (measured 0.99154 and
  2.28e-5).
* The port's engines against its megakernel route at 40x40, depth 8, 2 spp:
  equal ray counts; the pinned and queue engines run the same plain bounce
  (russian roulette off), at least 99.9% of entries within 2e-4 and sums
  within 1e-5; the split route's PyTorch shading rounds apart (and takes
  libm's atan2 where kernel 2t takes JAX's polynomial), 99.5% and 2e-5;
  on textured the split route's bump frame (JAX's split path thresholds at
  0.577 and leaves t2 unnormalized) may move 1% of entries and the sum by
  1e-4 (measured 0.99938 and 7.12e-5).
* ``ward_96`` (96x96, 16 spp, depth 8, NEE: the golden's configuration)
  against ``tests/golden/ward_96.npy`` under ROADMAP queue 3's accepted
  golden bar (``tests/test_torch_render.py``'s cornell_96 rule): at least
  95% of entries within 1e-5 relative, the sum within 2e-5 relative and the
  PNG's mean bar of 0.8/255.  ``textured_image_96`` against its PNG, on the
  deferred-texel route and the split route, at ``tests/test_golden.py``'s
  mean bar of 0.8/255, with its per-pixel bar of 2.5/255 on at least 99.9%
  of pixels: two of the 9,216 pixels miss it (3.53/255), each by one of its
  16 samples whose path JAX and the port end apart after a last-ulp
  difference at the floor cube's edge (x = 5: one hits the top face, the
  other the side; traced bounce by bounce): XLA's fused CPU arithmetic and
  torch's round that slab test apart.
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
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from pathtracer_tpu_torch.utils.imageio import load_png
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden")
SURFACE = ("ward", "textured", "textured_image")
# scene -> (least share of entries within 2e-4 of JAX, largest relative sum difference)
JAX_BARS = {"ward": (0.995, 2e-5), "textured": (0.98, 1e-4), "textured_image": (0.995, 2e-5)}


def _path(name):
    return os.path.join(ROOT, "scenes", f"{name}.txt")


def _counts():
    return (trace.launches, trace.surf_launches, bounce_fused.launches,
            bounce_fused.surf_launches, bounce_fused.tex_launches)


@pytest.mark.parametrize("name", SURFACE)
def test_renders_match_jax(name):
    jdesc = dataclasses.replace(jax_load_scene(_path(name)), resolution=(32, 32))
    jscene = jdesc.scene_for_frame(0)
    _, jacc, jst = jax_render(jscene, 2, JaxConfig(wavefront=False, nee=True, max_depth=4,
                                                  iters_per_launch=2))
    jacc = np.asarray(jacc)
    tscene = port_scene_from_jax(jscene)
    base = dict(nee=True, max_depth=4, iters_per_launch=2)
    least, sum_tol = JAX_BARS[name]
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
        assert share >= least and sum_rel <= sum_tol
    assert _counts() == before  # CPU: the plain versions, no launch


@pytest.mark.parametrize("name", SURFACE)
def test_engines_agree(name):
    scene = dataclasses.replace(load_scene(_path(name)), resolution=(40, 40)).scene_for_frame(
        0, device="cpu")
    base = dict(nee=True, max_depth=8, iters_per_launch=2, seed=3)
    _, ref, st = render(scene, 2, RenderConfig(**base), device="cpu")
    assert float(ref.sum()) > 0
    split_bar = (0.99, 1e-4) if name == "textured" else (0.995, 2e-5)
    for engine, cfg, (least, sum_tol) in (
        ("pinned", RenderConfig(wavefront=True, **base), (0.999, 1e-5)),
        ("queue", RenderConfig(wavefront=True, wavefront_pinned=False, wavefront_capacity=512,
                               **base), (0.999, 1e-5)),
        ("split", RenderConfig(fused=False, **base), split_bar),
    ):
        _, acc, st_e = render(scene, 2, cfg, device="cpu")
        share = float(np.isclose(acc.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4).mean())
        sum_rel = abs(float(acc.sum()) - float(ref.sum())) / float(ref.sum())
        print(f"{name} {engine} vs megakernel: {share:.5f} within 2e-4, sums {sum_rel:.3g}")
        assert st_e["rays_traced"] == st["rays_traced"]
        assert share >= least and sum_rel <= sum_tol


def test_ward_96_golden():
    desc = dataclasses.replace(load_scene(_path("ward")), resolution=(96, 96))
    img, accum, _ = render(desc.scene_for_frame(0, device="cpu"), 16,
                           RenderConfig(nee=True, max_depth=8, iters_per_launch=8), device="cpu")
    accum = accum.numpy()
    golden = np.load(os.path.join(GOLDEN, "ward_96.npy"))
    frac = (np.abs(accum - golden) <= 1e-5 * (np.abs(golden) + 1e-3)).mean()
    sum_rel = abs(accum.sum() - golden.sum()) / abs(golden.sum())
    png = load_png(os.path.join(GOLDEN, "ward_96.png")).astype(np.float32) / 255.0
    png_mean = np.abs(img.numpy() - png).mean()
    print(f"ward_96: {frac:.5f} of entries within 1e-5, sum rel {sum_rel:.3g}, "
          f"PNG mean {png_mean * 255:.3f}/255")
    assert frac >= 0.95
    assert sum_rel <= 2e-5
    assert png_mean <= 0.8 / 255.0


@pytest.mark.parametrize("fused", [None, False], ids=["deferred-texel", "split"])
def test_textured_image_96_golden(fused):
    desc = dataclasses.replace(load_scene(_path("textured_image")), resolution=(96, 96))
    img, _, _ = render(desc.scene_for_frame(0, device="cpu"), 16,
                       RenderConfig(nee=True, max_depth=8, iters_per_launch=8, fused=fused),
                       device="cpu")
    png = load_png(os.path.join(GOLDEN, "textured_image_96.png")).astype(np.float32) / 255.0
    diff_ = np.abs(img.numpy() - png)
    within = (diff_.max(-1) <= 2.5 / 255.0).mean()
    print(f"textured_image_96 fused={fused}: PNG max {diff_.max() * 255:.3f}/255, mean "
          f"{diff_.mean() * 255:.4f}/255, pixels within 2.5/255 {within:.5f}")
    assert within >= 0.999
    assert diff_.mean() <= 0.8 / 255.0


GRAD_ENGINES = [dict(), dict(grad_full_trace=False), dict(grad_fused=False)]
GRAD_IDS = ["full-depth", "per-bounce", "lean"]


@pytest.mark.parametrize("grad", GRAD_ENGINES, ids=GRAD_IDS)
@pytest.mark.parametrize("feature,name", [("texture", "textured"), ("bump", "textured"),
                                          ("microfacet", "ward"), ("ward", "ward")])
def test_differentiable_engines_refuse_surface_features(feature, name, grad):
    """Each differentiable engine takes the surface features (the name is
    from when they refused them): through ``render`` with the feature
    pinned, its image equal to the forward render's, and through the
    gradient entry point with the scene's resolved features, whose
    gradients are finite and reach the feature's material columns.  The
    values against JAX are ``tests/test_torch_surface_diff.py``'s."""
    desc = dataclasses.replace(load_scene(_path(name)), resolution=(8, 8))
    scene = desc.scene_for_frame(0, device="cpu")
    cfg = RenderConfig(grad_lean=True, max_depth=2, features=(feature,), **grad)
    _, acc, _ = render(scene, 1, cfg, device="cpu")
    _, acc_fwd, _ = render(scene, 1, dataclasses.replace(cfg, grad_lean=False), device="cpu")
    assert torch.allclose(acc, acc_fwd, rtol=1e-5, atol=1e-6)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    loss, grads = diff.loss_and_grad(params, static, torch.zeros((64, 3)), 1, prng_key(0),
                                     RenderConfig(max_depth=2, **grad), device="cpu")
    assert float(loss) > 0
    assert all(bool(torch.isfinite(v).all()) for v in grads.leaves().values())
    column = {"texture": "texture_color2", "bump": "bump_amp", "microfacet": "roughness",
              "ward": "roughness_y"}[feature]
    assert float(getattr(grads.materials, column).abs().max()) > 0


@pytest.mark.parametrize("grad", GRAD_ENGINES, ids=GRAD_IDS)
def test_differentiable_engines_refuse_image_textures(grad):
    """Image textures differentiate on every engine setting (the name is
    from when they refused them): each takes the lean engine, as in JAX,
    and the atlas's texels are a leaf whose gradient is finite and nonzero
    on the texels the image shows; the full-depth and per-bounce engines
    themselves refuse an atlas, as JAX's ``fused_diff_eligible`` does."""
    from pathtracer_tpu_torch.ops.bounce_grad import bounce_fused_diff
    from pathtracer_tpu_torch.ops.trace_grad import trace_fused_diff
    from pathtracer_tpu_torch.scene.structs import Rays

    desc = dataclasses.replace(load_scene(_path("textured_image")), resolution=(8, 8))
    scene = desc.scene_for_frame(0, device="cpu")
    for features in (("texture",), ("glossy",)):  # the feature, or a pin that leaves it out
        cfg = RenderConfig(grad_lean=True, max_depth=2, features=features, **grad)
        _, acc, _ = render(scene, 1, cfg, device="cpu")
        # the lean scan is the split route's physics (libm's atan2 for the UV)
        split = dataclasses.replace(cfg, grad_lean=False, fused=False)
        _, acc_fwd, _ = render(scene, 1, split, device="cpu")
        assert torch.allclose(acc, acc_fwd, rtol=1e-5, atol=1e-6)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    assert params.textures is not None and "textures.data" in params.leaves()
    _, grads = diff.loss_and_grad(params, static, torch.zeros((64, 3)), 1, prng_key(0),
                                  RenderConfig(max_depth=2, **grad), device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in grads.leaves().values())
    assert float(grads.textures.data.abs().max()) > 0
    cfg = RenderConfig(grad_lean=True, max_depth=2, features=("texture",))
    rays = Rays(origin=torch.zeros((4, 3)), direction=torch.tensor([[0.0, 0.0, -1.0]] * 4))
    pix = torch.arange(4)
    with pytest.raises(NotImplementedError, match="image textures"):
        trace_fused_diff(scene, rays, pix, 3, cfg)
    with pytest.raises(NotImplementedError, match="image textures"):
        bounce_fused_diff(scene, rays.origin, rays.direction, torch.ones((4, 3)), pix, 0,
                          torch.zeros(4), None, 3, cfg)


def _mesh_and_image_texture_scene():
    """textured_image.txt with smooth_mesh's icosphere added, in both
    packages: the JAX scene and the port's."""
    from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse_scene_text

    with open(_path("textured_image")) as f:
        text = f.read()
    text += ("\nOBJECT 5\nassets/ico_smooth.obj\nmaterial 1\nframe 0\nTRANS 0 1 2\n"
             "ROTAT 0 0 0\nSCALE 1 1 1\n")
    jdesc = jax_parse_scene_text(text, name="mesh_image", scene_dir=os.path.join(ROOT, "scenes"))
    jscene = dataclasses.replace(jdesc, resolution=(16, 16)).scene_for_frame(0)
    return jscene, port_scene_from_jax(jscene)


@pytest.mark.parametrize("engine", [dict(), dict(fused=False), dict(wavefront=True),
                                    dict(wavefront=True, wavefront_pinned=False)],
                         ids=["megakernel", "split", "pinned", "queue"])
def test_image_textures_on_meshes_raise(engine):
    """Image textures on a mesh (the box map of its object-space normal)
    render on every engine (the name is from when they raised): at 16x16,
    depth 3, NEE, 2 spp against JAX's CPU render (its split path), the bars
    of the scenes above (equal ray counts, 99.5% of entries within 2e-4,
    sums within 2e-5).  The megakernel route is the per-bounce scan on
    kernel 2mt's plain version."""
    jscene, scene = _mesh_and_image_texture_scene()
    assert scene.meshes and scene.textures is not None
    _, jacc, jst = jax_render(jscene, 2, JaxConfig(wavefront=False, nee=True, max_depth=3,
                                                  iters_per_launch=2))
    before = bounce_fused.mesh_tex_launches
    _, acc, st = render(scene, 2, RenderConfig(nee=True, max_depth=3, iters_per_launch=2,
                                               **engine), device="cpu")
    assert bounce_fused.mesh_tex_launches == before  # CPU: the plain versions
    jacc, acc = np.asarray(jacc), acc.numpy()
    share = np.isclose(acc, jacc, rtol=2e-4, atol=2e-4).mean()
    sum_rel = abs(float(acc.sum()) - float(jacc.sum())) / float(jacc.sum())
    print(f"mesh + image texture {engine}: {share:.5f} of entries within 2e-4, sums within "
          f"{sum_rel:.3g}")
    assert st["rays_traced"] == int(jst["rays_traced"])
    assert share >= 0.995 and sum_rel <= 2e-5
