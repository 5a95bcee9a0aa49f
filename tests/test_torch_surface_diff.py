"""Differentiable surface physics of the PyTorch port vs the JAX package,
on the CPU.

The port's three gradient engines (the full-depth engine: the plain
versions of kernels 4s and 5s, ``ops/trace_grad.py``; the per-bounce
engine: those of 2r-s and 3s, ``ops/bounce_grad.py``; the lean engine,
``render/diff.LeanSample``) against JAX's lean graph (``grad_fused=False``),
the same numbers on both sides (``scene/convert.params_from_numpy``, the
atlas's texels too).  Their kernels' lanes are held to these plain
versions in ``tests/test_torch_kernel_host.py``.

Cases (24x24, depth 2, 1 spp, NEE, a flat 0.3 target), those of
``tests/test_bounce_grad.py:218,321`` and more:

* ``checker_bump``: MINI_SCENE's floor checkered (scale 2) and bumped
  (scale 6, amplitude 0.2);
* ``cooktorrance`` / ``ward``: its mirror sphere a Cook-Torrance lobe
  (roughness 0.35) or an anisotropic Ward lobe (0.2, 0.5);
* ``ggx_ward``: ``scene/variants.ggx_ward_scene`` (the brushed Ward floor
  under a Cook-Torrance sphere);
* ``textured_image``: ``scenes/textured_image.txt``, the atlas's texels a
  leaf (JAX's ``grads.textures.data``);
* ``textured_mesh``: that scene with smooth_mesh's icosphere in the
  image-textured material, bumped (``variants.textured_mesh_scene``):
  surface features on a mesh, its vertices and the atlas leaves.
  The last two take the lean engine on every setting, as in JAX.

The loss is the mean squared error, as ``loss_and_grad``'s, over the
pixels where the port's forward image and JAX's agree within 1e-4; both
sides differentiate that same masked loss (``render_linear`` under
autograd and ``jax.value_and_grad``).  A lane whose path differs between
the frameworks is not a gradient error: on ``checker_bump`` the floor's
top face sits on a checker cell boundary (p_obj.y = 0.5 at scale 2), so
the last bit of the hit point picks the cell, and 42 of the 576 pixels
(7.3%) take the other colour in one of them; on ggx_ward one pixel, on
textured_mesh six, whose paths part at a grazing hit.  Each case holds a
stated share of agreeing pixels (measured: 0.927, 1, 1, 0.998, 1, 0.990)
and prints the others.

Tolerances, with the reason: the masked loss within 1e-5 relative, every
leaf within 5e-4 of gscale (the largest gradient entry of JAX's), the bar
JAX holds between its own engines, all finite; between the port's engines
that bar of ``tests/test_bounce_grad.py:259-263`` (loss within 1e-6 *
max(1, loss), leaves within 5e-4 * max(gscale, 1)).  JAX's own gradient
is NaN on some leaves: the roughness wherever the microfacet lobes are in
the graph; with the Ward lobe every geometry and camera leaf too (its
weight's sqrt of a zero cos_o under a zero cotangent); on the
image-textured scenes every geometry and camera leaf (the sphere map's
asin at a cube face's |y| = 0.5 on the lanes that do not select it).  The
port takes the same values with a zero gradient there (``ops/bsdf.sqrt0``,
``ops/texture.compute_uv``); those leaves are held between the port's
engines, JAX's NaN leaves are printed, and the roughness leaves are held
to central differences of the port's loss instead.

Where JAX's gradient is NaN, and where the bump's phases of ~10^3 rad
make it ill-posed, the port's engines are held to the float64 derivative of
the same paths (the split route under float64 autograd), which central
differences of the float64 loss witness: geometry and camera leaves on the
Ward and image-texture cases, the bump's leaves at textured.txt's own bump
scale, and textured.txt itself at depth 8, where the float32 forward's last
bits decide the derivative of its geometry and camera leaves on a few lanes
for every engine alike (printed).

About 60 s on one CPU thread, most of it JAX compiling five lean graphs.
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
from pathtracer_tpu.render.diff import params_from_description as jax_params
from pathtracer_tpu.render.diff import render_linear as jax_render_linear
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import trace_grad
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.render.integrator import render_sample
from pathtracer_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from pathtracer_tpu_torch.scene.parser import parse_scene_text
from pathtracer_tpu_torch.scene.structs import MATERIAL_FIELDS
from pathtracer_tpu_torch.scene.variants import ggx_ward_scene, textured_mesh_scene
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_volume_diff import VOL_MINI

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
RES, SEED, DEPTH = (24, 24), 5, 2

# MINI_SCENE's floor (material 1) and mirror sphere (material 2) blocks
FLOOR = ("RGB .45 .65 .85\nSPECEX 0\nSPECRGB 1 1 1\nREFL 0\nREFR 0\nREFRIOR 0\nSCATTER 0\n"
         "ABSCOEFF 0 0 0\nRSCTCOEFF 0\nEMITTANCE 0")
MIRROR = "REFL 1\nREFR 0\nREFRIOR 0\nSCATTER 0\nABSCOEFF 0 0 0\nRSCTCOEFF 0\nEMITTANCE 0"
assert MINI_SCENE.count(FLOOR) == 1 and MINI_SCENE.count(MIRROR) == 1
assert VOL_MINI.count(FLOOR) == 1 and VOL_MINI.count(MIRROR) == 1
# the cases of tests/test_bounce_grad.py:218,321: the floor checkered (scale
# 2, second colour .2 .8 .3) and bumped (scale 6, amplitude .2); the mirror
# sphere a Cook-Torrance or a Ward lobe
CHECKER_BUMP = "\nTEXTURE checker 2 .2 .8 .3\nBUMP 6 .2"
CHECKER_BUMP_MINI = MINI_SCENE.replace(FLOOR, FLOOR + CHECKER_BUMP)
CT_MINI = MINI_SCENE.replace(MIRROR, MIRROR + "\nBRDF cooktorrance 0.35")
WARD_MINI = MINI_SCENE.replace(MIRROR, MIRROR + "\nBRDF ward 0.2 0.5")
# participating media and every surface block in one scene (kVol x kSurf)
SURF_VOL_MINI = (VOL_MINI.replace(FLOOR, FLOOR + CHECKER_BUMP)
                 .replace(MIRROR, MIRROR + "\nBRDF ward 0.2 0.5"))


def _scene_text(name: str) -> str:
    if name == "textured_image":
        with open(os.path.join(SCENES, "textured_image.txt")) as f:
            return f.read()
    if name == "textured_mesh":
        return textured_mesh_scene(os.path.abspath(os.path.join(SCENES, "assets",
                                                                "ico_smooth.obj")), bump=True)
    return {"checker_bump": CHECKER_BUMP_MINI, "cooktorrance": CT_MINI, "ward": WARD_MINI,
            "ggx_ward": ggx_ward_scene()}[name]


ENGINE_CFG = {"full-depth": {}, "per-bounce": dict(grad_full_trace=False),
              "lean": dict(grad_fused=False)}
# checker_bump and cooktorrance share one feature set, so JAX compiles
# their graph once (the blocks a material does not select change nothing)
MINI_FEATURES = ("texture", "bump", "glossy", "microfacet")
# case -> features, least share of agreeing pixels, the material columns'
# leaves that must carry gradient, engines (the image-textured scenes take
# the lean engine on every setting)
CASES = {
    "checker_bump": (MINI_FEATURES, 0.9, ("texture_color2", "bump_scale", "bump_amp"),
                     tuple(ENGINE_CFG)),
    "cooktorrance": (MINI_FEATURES, 1.0, ("roughness", "specular_color"), tuple(ENGINE_CFG)),
    # the Ward sphere's 14 lanes leave the scene at depth 2: its leaves get
    # no gradient (ggx_ward's Ward floor does)
    "ward": (("glossy", "microfacet", "ward"), 1.0, (), tuple(ENGINE_CFG)),
    "ggx_ward": (("microfacet", "ward"), 0.99, ("roughness", "roughness_y"), tuple(ENGINE_CFG)),
    "textured_image": (("texture",), 1.0, ("color",), ("lean",)),
    "textured_mesh": (("texture", "bump"), 0.98, ("bump_amp",), ("lean",)),
}


def _cfg(cls, features, **kw):
    return cls(wavefront=False, nee=True, max_depth=DEPTH, auto_features=False,
               features=features, **kw)


def _jax_numpy(p) -> dict:
    """JAX's ``SceneParams`` (or its gradient) as ``scene/convert``'s dict."""
    d = {k: np.asarray(getattr(p, k)) for k in (
        "translations", "rotations", "scales", "cam_position", "cam_view", "cam_up",
        "cam_fov", "cam_aperture", "cam_focal")}
    d["materials"] = {k: np.asarray(getattr(p.materials, k)) for k in MATERIAL_FIELDS}
    d["mesh_verts"] = [np.asarray(v) for v in p.mesh_verts]
    if p.textures is not None:
        d["textures"] = {"data": np.asarray(p.textures.data), "hw": np.asarray(p.textures.hw)}
    return d


def _flat(d: dict) -> dict:
    """``{leaf name: array}`` of a params dict of ``scene/convert``: the
    port's leaves (the atlas's slot sizes are static)."""
    out = {k: v for k, v in d.items() if k not in ("materials", "mesh_verts", "textures")}
    out.update({f"materials.{k}": v for k, v in d["materials"].items()})
    out.update({f"mesh_verts.{i}": v for i, v in enumerate(d.get("mesh_verts", ()))})
    if d.get("textures") is not None:
        out["textures.data"] = d["textures"]["data"]
    return out


def _port_loss_and_grad(params, static, target, weight, cfg):
    """The masked loss and its gradient by the port's engine under ``cfg``,
    through ``render_linear`` as ``loss_and_grad`` runs it."""
    names, values = zip(*params.leaves().items())
    leaves = [v.detach().requires_grad_(True) for v in values]
    hw = None if params.textures is None else params.textures.hw
    p = diff.SceneParams.from_leaves(dict(zip(names, leaves)), hw)
    with torch.enable_grad():
        img = diff.render_linear(p, static, 1, prng_key(SEED), cfg)
        loss = torch.mean(weight[:, None] * (img - target) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {k: (np.zeros(x.shape, np.float32) if g is None else g.numpy())
             for k, g, x in zip(names, grads, leaves)}
    return float(loss), grads


_JAX_STEPS: dict = {}


def _jax_step(static, features):
    """JAX's lean ``(masked loss, image), gradient`` as one jitted function
    of (params, weight, target), compiled once per scene structure and
    feature set."""
    key = (static, features)
    if key not in _JAX_STEPS:
        cfg = _cfg(JaxConfig, features, grad_fused=False)

        def loss(p, weight, target):
            img = jax_render_linear(p, static, 1, jax.random.PRNGKey(SEED), cfg)
            return jnp.mean(weight[:, None] * (img - target) ** 2), img

        _JAX_STEPS[key] = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return _JAX_STEPS[key]


@pytest.fixture(scope="module")
def jax_cases():
    """JAX's lean gradient of each case's masked loss, computed once:
    ``{case: (loss, flat grads, port params, port static, target, weight,
    the disagreeing pixels)}``.  JAX's image comes from a first call with
    every pixel weighed, the masked gradient from a second."""
    out = {}
    for case, (features, _, _, _) in CASES.items():
        text = _scene_text(case)
        jdesc = dataclasses.replace(jax_parse(text, name=case, scene_dir=SCENES), resolution=RES)
        tdesc = dataclasses.replace(parse_scene_text(text, name=case, scene_dir=SCENES),
                                    resolution=RES)
        jp, js = jax_params(jdesc, 0)
        tp = params_from_numpy(_jax_numpy(jp), device="cpu")
        _, ts = diff.params_from_description(tdesc, 0, device="cpu")
        n = RES[0] * RES[1]
        target = np.full((n, 3), 0.3, np.float32)
        step = _jax_step(js, features)
        (_, jimg), _ = step(jp, jnp.ones(n), jnp.asarray(target))
        with torch.no_grad():
            timg = diff.render_linear(tp, ts, 1, prng_key(SEED), _cfg(RenderConfig, features))
        off = np.abs(timg.numpy() - np.asarray(jimg)).max(-1) > 1e-4
        weight = (~off).astype(np.float32)
        (jl, _), jg = step(jp, jnp.asarray(weight), jnp.asarray(target))
        out[case] = (float(jl), _flat(_jax_numpy(jg)), tp, ts, torch.from_numpy(target),
                     torch.from_numpy(weight), np.nonzero(off)[0])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_cases_agree_on_pixels(jax_cases, case):
    """The share of pixels on which the frameworks agree meets the case's
    bar (the others printed); on the image-textured scenes JAX's texel
    gradient is finite and nonzero."""
    _, want, _, _, _, weight, off = jax_cases[case]
    share = float(weight.mean())
    print(f"{case}: {share:.5f} of pixels agree within 1e-4; the others {off.tolist()}")
    assert share >= CASES[case][1]
    if case.startswith("textured_"):
        assert np.isfinite(want["textures.data"]).all()
        assert np.abs(want["textures.data"]).max() > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_loss_and_grad_matches_jax(jax_cases, case):
    """Each engine's setting against JAX, and against each other; the
    surface columns' leaves (and the atlas's texels, and a mesh's vertices)
    carry gradient."""
    features, _, _, engines = CASES[case]
    want_loss, want, tp, ts, target, weight, _ = jax_cases[case]
    finite = {k for k, v in want.items() if np.isfinite(v).all()}
    print(f"{case}: JAX's NaN leaves {sorted(set(want) - finite)}")
    gscale = max(float(np.abs(want[k]).max()) for k in finite)
    results = {}
    for engine in engines:
        cfg = _cfg(RenderConfig, features, **ENGINE_CFG[engine])
        loss, got = _port_loss_and_grad(tp, ts, target, weight, cfg)
        assert sorted(want) == sorted(got)
        worst = {k: float(np.abs(want[k] - got[k]).max()) for k in finite}
        k_worst = max(worst, key=worst.get)
        print(f"{case} {engine}: loss JAX {want_loss:.9g} port {loss:.9g}; worst finite leaf "
              f"{k_worst} {worst[k_worst]:.3g} of gscale {gscale:.4g}")
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
        for k in got:
            assert np.isfinite(got[k]).all(), k
        for k in finite:
            assert worst[k] <= 5e-4 * gscale, (k, worst[k], gscale)
        results[engine] = (loss, got)
    # the port's engines against each other, at JAX's fused-against-lean bar
    l0, g0 = results[engines[-1]]
    carriers = [f"materials.{k}" for k in CASES[case][2]]
    carriers += [k for k in g0 if k.startswith(("textures.", "mesh_verts."))]
    for k in carriers:
        assert np.abs(g0[k]).max() > 0, k
    pscale = max(max(float(np.abs(v).max()) for v in g0.values()), 1.0)
    for engine in engines[:-1]:
        l1, g1 = results[engine]
        assert abs(l1 - l0) <= 1e-6 * max(1.0, abs(l0))
        for k in g0:
            np.testing.assert_allclose(g1[k], g0[k], atol=5e-4 * pscale, err_msg=k)


def test_fused_engines_refuse_atlases():
    """The image-textured scenes take the lean engine on every setting (the
    full-depth and per-bounce engines themselves refuse an atlas, as JAX's
    ``fused_diff_eligible`` does); the atlas's texels are a leaf, its slot
    sizes static, and both cross ``scene/convert``."""
    text = _scene_text("textured_image")
    desc = dataclasses.replace(parse_scene_text(text, name="ti", scene_dir=SCENES),
                               resolution=(8, 8))
    params, static = diff.params_from_description(desc, 0, device="cpu")
    scene = diff.build_scene(params, static)
    cfg = _cfg(RenderConfig, ("texture",), grad_lean=True)
    assert not trace_grad.fused_diff_eligible(scene, cfg)
    assert params.leaves()["textures.data"] is params.textures.data
    assert "textures.hw" not in params.leaves()
    # the atlas crosses scene/convert with the other leaves
    back = params_from_numpy(params_to_numpy(params), device="cpu")
    assert torch.equal(back.textures.data, params.textures.data)
    assert torch.equal(back.textures.hw, params.textures.hw)


# case, leaf, material: the roughness entries of the lobes in view
FD_LEAVES = [("cooktorrance", "roughness", 2), ("ggx_ward", "roughness", 0),
             ("ggx_ward", "roughness_y", 0), ("ggx_ward", "roughness", 3)]


@pytest.mark.parametrize("case,leaf,mat", FD_LEAVES)
def test_roughness_gradient_matches_finite_differences(case, leaf, mat):
    """Where JAX's roughness gradient is NaN, the full-depth engine's (the
    plain versions of kernels 4s and 5s) against central differences of the
    port's own loss (the same seed, h = 1e-3): within 2% of itself plus
    3e-4, the float32 loss's rounding over 2h (measured: within 0.25% on
    the large entries, 2e-4 on ggx_ward's sphere's -0.0027)."""
    features = CASES[case][0]
    text = _scene_text(case)
    desc = dataclasses.replace(parse_scene_text(text, name=case, scene_dir=SCENES), resolution=RES)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    target = torch.full((RES[0] * RES[1], 3), 0.3)
    cfg = _cfg(RenderConfig, features)
    _, grads = diff.loss_and_grad(params, static, target, 1, prng_key(SEED), cfg, device="cpu")
    want = float(getattr(grads.materials, leaf)[mat])
    h, losses = 1e-3, []
    for sign in (1.0, -1.0):
        value = getattr(params.materials, leaf).clone()
        value[mat] += sign * h
        moved = dataclasses.replace(params, materials=dataclasses.replace(params.materials,
                                                                          **{leaf: value}))
        with torch.no_grad():
            losses.append(float(diff.l2_loss(moved, static, target, 1, prng_key(SEED), cfg)))
    fd = (losses[0] - losses[1]) / (2 * h)
    print(f"{case} {leaf}[{mat}]: gradient {want:.6g}, central difference {fd:.6g}")
    assert want != 0.0
    assert abs(fd - want) <= 0.02 * abs(want) + 3e-4


# textured.txt's own bump (scale 18, amplitude .35) on MINI_SCENE's checkered floor
BUMP18_MINI = MINI_SCENE.replace(FLOOR, FLOOR + "\nTEXTURE checker 2 .2 .8 .3\nBUMP 18 .35")
SPLIT = dict(fused=False, grad_lean=True, grad_fused=False)


def _image64(params, static, cfg, leaves=None):
    """One iteration of the split route (the lean engine's re-trace) in
    float64 (the transforms rounded to float32, as every engine takes
    them), on ``leaves`` (float64 copies of the params' leaves by default)."""
    if leaves is None:
        leaves = {k: v.detach().double() for k, v in params.leaves().items()}
    hw = None if params.textures is None else params.textures.hw
    scene = diff.build_scene(diff.SceneParams.from_leaves(leaves, hw), static)
    n = static.resolution[0] * static.resolution[1]
    return render_sample(scene, torch.arange(n), 0, key_to_seed(prng_key(SEED)), cfg,
                         tables=pack_tables(scene))[0]


def _grad64(params, static, cfg, loss_of):
    """``{leaf: gradient}`` of ``loss_of(image)`` through :func:`_image64`."""
    leaves = {k: v.detach().double().requires_grad_(True) for k, v in params.leaves().items()}
    with torch.enable_grad():
        loss = loss_of(_image64(params, static, cfg, leaves))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(x) if g is None else g for (k, x), g in zip(leaves.items(), grads)}


def _setup(text, res, features, depth):
    desc = dataclasses.replace(parse_scene_text(text, name="c", scene_dir=SCENES), resolution=res)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    kw = dict(wavefront=False, nee=True, max_depth=depth, auto_features=False, features=features)
    return params, static, kw


# case, leaf, entry, the engines' bar relative to the float64 derivative:
# 2e-4 (measured within 3e-5) off the bump; on BUMP18_MINI the float32
# forward's own rounding moves the derivative (phases of ~10^3 rad; the
# bump_scale entry is a sum whose terms cancel): measured 0.35% and 8.4%
F64_LEAVES = [("ward", "translations", 0, 2e-4), ("ward", "cam_view", 1, 2e-4),
              ("textured_image", "translations", 10, 2e-4),
              ("textured_image", "cam_view", 1, 2e-4),
              ("bump18", "materials.bump_amp", 1, 0.01),
              ("bump18", "materials.bump_scale", 1, 0.1)]


@pytest.mark.parametrize("case,leaf,entry,bar", F64_LEAVES)
def test_gradient_matches_float64_derivative(case, leaf, entry, bar):
    """Geometry, camera and bump leaves, where JAX's gradient is NaN or
    the bump's phases of ~10^3 rad make the float32 gradient ill-posed:
    each engine against the derivative of the same paths in float64 (the
    split route under float64 autograd, on the pixels whose float64 image
    agrees with the float32 one within 1e-4), which central differences of
    that float64 loss witness (h = 1e-4 and 1e-5 within 1% of each other,
    the derivative within 1% of them; measured within 0.7%)."""
    text = BUMP18_MINI if case == "bump18" else _scene_text(case)
    features = CASES["checker_bump" if case == "bump18" else case][0]
    engines = CASES["checker_bump" if case == "bump18" else case][3]
    params, static, kw = _setup(text, RES, features, DEPTH)
    split = RenderConfig(**kw, **SPLIT)
    n = RES[0] * RES[1]
    target = torch.full((n, 3), 0.3)
    with torch.no_grad():
        img32 = diff.render_linear(params, static, 1, prng_key(SEED), RenderConfig(**kw))
        img64 = _image64(params, static, split)
    weight = ((img64 - img32.double()).abs() <= 1e-4 * (1.0 + img64.abs())).all(-1).double()

    def loss64(img):
        return torch.mean(weight[:, None] * (img - target.double()) ** 2)

    def moved(h):
        leaves = {k: v.detach().double().clone() for k, v in params.leaves().items()}
        leaves[leaf].view(-1)[entry] += h
        with torch.no_grad():
            return float(loss64(_image64(params, static, split, leaves)))

    fd = {h: (moved(h) - moved(-h)) / (2 * h) for h in (1e-4, 1e-5)}
    want = float(_grad64(params, static, split, loss64)[leaf].view(-1)[entry])
    got = {}
    for engine in engines:
        cfg = RenderConfig(**kw, **ENGINE_CFG[engine])
        _, g = _port_loss_and_grad(params, static, target, weight.float(), cfg)
        got[engine] = float(g[leaf].reshape(-1)[entry])
    print(f"{case} {leaf}[{entry}] over {int(weight.sum())} of {n} pixels: central differences "
          f"{fd[1e-4]:.7g} (h 1e-4) {fd[1e-5]:.7g} (h 1e-5), float64 derivative {want:.7g}, "
          + ", ".join(f"{e} {v:.7g}" for e, v in got.items()))
    assert weight.mean() >= 0.95
    assert abs(fd[1e-4] - fd[1e-5]) <= 0.01 * abs(fd[1e-5])
    assert want != 0.0 and abs(want - fd[1e-5]) <= 0.01 * abs(fd[1e-5])
    for engine, v in got.items():
        assert abs(v - want) <= bar * abs(want), (engine, v, want)


ALBEDO_LEAVES = ("materials.color", "materials.specular_color", "materials.emittance",
                 "materials.texture_color2")


def test_textured_gradient_against_float64_paths(monkeypatch):
    """scenes/textured.txt at 32x32, depth 8, 1 spp (glass, a mirror and the
    bumped sphere, whose paths re-hit it): the full-depth and lean engines
    and the full-depth engine with its float64 adjoint (``tbwd_plain``'s
    ``dtype=torch.float64``, at the float32 forward's values) against the
    float64 derivative of the same paths (:func:`_grad64`), leaf by leaf,
    over the pixels whose float32 forward, float32 re-trace and float64
    re-trace agree within 1e-4.  The albedo leaves, linear in the radiance,
    within 5e-5 of their own largest float64 entry (measured 1.65e-5); the
    engines within 5e-4 of the largest gradient of each other.  The
    geometry, camera, bump and index leaves are printed, not held: on a few
    lanes (grazing and bumped re-hits) the float32 forward's last bits move
    their derivative (measured: 0.3% on bump_amp to 16% on cam_up of each
    leaf's largest entry), for every engine alike and with a float64
    adjoint too."""
    with open(os.path.join(SCENES, "textured.txt")) as f:
        text = f.read()
    res = (32, 32)
    params, static, kw = _setup(text, res, ("texture", "bump", "glossy", "microfacet"), 8)
    split = RenderConfig(**kw, **SPLIT)
    n = res[0] * res[1]
    pix, seed = torch.arange(n), key_to_seed(prng_key(SEED))
    target = torch.zeros((n, 3))
    with torch.no_grad():
        img32 = diff.render_linear(params, static, 1, prng_key(SEED), RenderConfig(**kw))
        scene = diff.build_scene(params, static)
        tables = pack_tables(scene)
        retrace32, _ = render_sample(scene, pix, 0, seed, split, tables=tables)
        img64 = _image64(params, static, split)
        rays = generate_camera_rays(scene.camera, pix, camera_uniforms(seed, pix))
        features = frozenset(kw["features"])
        _, _, resid = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction, pix,
                                            max_depth=8, nee=True, rr=False, rr_start=3,
                                            features=features)
    tail = trace_grad.tail_plane(features)
    bump_geom = tables[1][tables[0][:, 13].long(), 21] > 0
    gid, live = resid[:, tail + 2].long(), resid[:, tail + 1] > 0.5
    bumped = (live & (gid >= 0) & bump_geom[gid.clamp(min=0)]).any(0)

    def close(img):
        return ((img.double() - img32.double()).abs() <= 1e-4 * (1.0 + img32.abs())).all(-1)

    kept = close(retrace32) & close(img64)
    weight = kept.double()
    want = _grad64(params, static, split, lambda img: torch.mean(weight[:, None] * img ** 2))
    tbwd = trace_grad.tbwd_plain
    got = {}
    for engine in ("full-depth", "lean", "full-depth, float64 adjoint"):
        if engine.endswith("adjoint"):
            monkeypatch.setattr(trace_grad, "tbwd_plain", lambda *a, **k: tuple(
                g.float() for g in tbwd(*a, **dict(k, dtype=torch.float64))))
        cfg = RenderConfig(**kw, **ENGINE_CFG[engine.split(",")[0]])
        _, got[engine] = _port_loss_and_grad(params, static, target, weight.float(), cfg)
    print(f"textured 32x32: {int(kept.sum())} of {n} pixels kept, {int((kept & bumped).sum())} "
          f"of them meet the bump")
    for engine, g in got.items():
        err = {k: float((torch.from_numpy(g[k]).double() - w).abs().max() / w.abs().max())
               for k, w in want.items() if float(w.abs().max()) > 0}
        print(f"  {engine} against float64, each leaf's worst over its own largest entry: "
              + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))
        for k in ALBEDO_LEAVES:
            assert err[k] <= 5e-5, (engine, k, err[k])
        assert all(np.isfinite(v).all() for v in g.values()), engine
    gscale = max(float(np.abs(v).max()) for v in got["full-depth"].values())
    for k, v in got["lean"].items():
        np.testing.assert_allclose(v, got["full-depth"][k], atol=5e-4 * gscale, err_msg=k)
