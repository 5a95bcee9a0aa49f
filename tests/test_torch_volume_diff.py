"""Differentiable participating media of the PyTorch port vs the JAX package,
on the CPU.

The port's three gradient engines (the full-depth engine: the plain
versions of kernels 4v and 5v, ``ops/trace_grad.py``; the per-bounce engine:
those of 2r-v and 3v, ``ops/bounce_grad.py``; the lean engine,
``render/diff.LeanSample``) against JAX's lean ``loss_and_grad`` (its XLA
graph, ``grad_fused=False``), the same numbers on both sides
(``scene/convert.params_from_numpy``).  Their kernels' lanes are held to
these plain versions in ``tests/test_torch_kernel_host.py``.

Cases (16x16, 1 spp, NEE):

* ``vol_mini``: ``tests/test_bounce_grad.py:277-281``'s mini volumetric
  scene (MINI_SCENE's glass sphere a scattering medium, absorption 0.25
  0.12 0.05), with the sphere grown to enclose the area light, its
  scattering coefficient 0.5 and the camera raised to it, so that most
  pixels see the medium: at depth 2 with volumetric NEE, at depth 3 with
  it (enter, scatter, leave) and at depth 3 without it.  Without
  volumetric NEE a lane that scatters adds light only at a later light
  hit, so at depth 2 the scattering coefficient has no gradient; the case
  without it is at depth 3;
* ``sss`` (Henyey-Greenstein media) and ``fog_mesh``
  (``scene/variants.fog_mesh_scene``: fog's scattering cube around
  smooth_mesh's glass icosphere, media in a mesh scene), at depth 2: every
  engine setting takes the lean engine there, as in JAX.

The target is the port's render of the same scene with the media's
coefficients changed (absorption x3, scattering x0.4, phase g 0), the same
seed: an inverse-rendering step that fits the medium.  Pixels whose
paths meet no medium match their target, so the medium's leaves carry a
good share of the gradient; each case prints that share and asserts at
least 1% of gscale (the largest gradient entry of JAX's) for absorption,
scattering and, on sss, the phase g (measured: 7% to 87%).  A port that
detached the medium would give those leaves zeros.

Tolerances, with the reason: the loss within 1e-5 relative, every leaf
within 5e-4 * gscale of JAX's, the bar JAX holds between its own engines
(``tests/test_bounce_grad.py:302-306``), all finite.  The engines
differentiate the same float32 formulas in another order of sums (and the
lean engine's forward is the one-kernel trace's plain version, equal a.e.
to the lean scan the backward re-traces).
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
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from pathtracer_tpu_torch.scene.parser import parse_scene_text
from pathtracer_tpu_torch.scene.variants import fog_mesh_scene
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_mesh_diff import _jax_numpy

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
RES, SEED = (16, 16), 11

VOL_MINI = (
    MINI_SCENE.replace("REFRIOR 1.5\nSCATTER 0\nABSCOEFF 0 0 0\nRSCTCOEFF 0",
                       "REFRIOR 1.5\nSCATTER 1\nABSCOEFF 0.25 0.12 0.05\nRSCTCOEFF 0.5")
    .replace("TRANS 1.7 0.4 1\nROTAT 0 30 0\nSCALE 2 2 2",
             "TRANS 0 6.5 0\nROTAT 0 30 0\nSCALE 7 7 7")
    .replace("VIEW 0 -0.15 -1", "VIEW 0 0.1 -1")
)


def _flat(d: dict) -> dict:
    """``{leaf name: array}`` of a params dict of ``scene/convert``."""
    out = {k: v for k, v in d.items() if k not in ("materials", "mesh_verts")}
    out.update({f"materials.{k}": v for k, v in d["materials"].items()})
    out.update({f"mesh_verts.{i}": v for i, v in enumerate(d.get("mesh_verts", ()))})
    return out


def _scene_text(name: str) -> str:
    if name == "vol_mini":
        return VOL_MINI
    if name == "fog_mesh":
        return fog_mesh_scene(refractive=True)
    with open(os.path.join(SCENES, f"{name}.txt")) as f:
        return f.read()


ENGINE_CFG = {"full-depth": {}, "per-bounce": dict(grad_full_trace=False),
              "lean": dict(grad_fused=False)}
ENGINES = tuple(ENGINE_CFG)
MEDIUM = ("absorption_coefficient", "reduced_scatter_coefficient")
# case -> scene, depth, vol_nee, features, the media's materials, the leaves
# that must carry gradient
CASES = {
    "vol_mini_d2": ("vol_mini", 2, True, ("volumetric",), [3], MEDIUM),
    "vol_mini_d3": ("vol_mini", 3, True, ("volumetric",), [3], MEDIUM),
    "vol_mini_d3_no_vol_nee": ("vol_mini", 3, False, ("volumetric",), [3], MEDIUM),
    "sss": ("sss", 2, True, ("volumetric", "hg"), [1, 2], MEDIUM + ("phase_g",)),
    "fog_mesh": ("fog_mesh", 2, True, ("volumetric",), [1], MEDIUM),
}


def _cfg(cls, depth, vol_nee, features, **kw):
    return cls(wavefront=False, nee=True, vol_nee=vol_nee, max_depth=depth,
               auto_features=False, features=features, **kw)


def _target(params, static, media, depth, vol_nee, features):
    """The port's render with the media's coefficients changed, as numpy."""
    changed = {}
    for name, scale in (("absorption_coefficient", 3.0), ("reduced_scatter_coefficient", 0.4),
                        ("phase_g", 0.0)):
        v = getattr(params.materials, name).clone()
        v[media] = v[media] * scale
        changed[name] = v
    mats = dataclasses.replace(params.materials, **changed)
    with torch.no_grad():
        img = diff.render_linear(dataclasses.replace(params, materials=mats), static, 1,
                                 prng_key(SEED), _cfg(RenderConfig, depth, vol_nee, features))
    return img.numpy()


@pytest.fixture(scope="module")
def jax_cases():
    """JAX's lean ``loss_and_grad`` on each case, computed once: ``{case:
    (loss, flat grads, port params, port static, target)}``."""
    out = {}
    for case, (name, depth, vol_nee, features, media, _) in CASES.items():
        text = _scene_text(name)
        jdesc = dataclasses.replace(jax_parse(text, name=name, scene_dir=SCENES), resolution=RES)
        tdesc = dataclasses.replace(parse_scene_text(text, name=name, scene_dir=SCENES),
                                    resolution=RES)
        jp, js = jax_params(jdesc, 0)
        tp = params_from_numpy(_jax_numpy(jp), device="cpu")
        _, ts = diff.params_from_description(tdesc, 0, device="cpu")
        target = _target(tp, ts, media, depth, vol_nee, features)
        jl, jg = jax_loss_and_grad(jp, js, jnp.asarray(target), 1, jax.random.PRNGKey(SEED),
                                   _cfg(JaxConfig, depth, vol_nee, features, grad_fused=False))
        out[case] = (float(jl), _flat(_jax_numpy(jg)), tp, ts, torch.from_numpy(target))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_media_leaves_carry_gradient(jax_cases, case):
    """JAX's gradient of each medium leaf is at least 1% of gscale."""
    _, want, _, _, _ = jax_cases[case]
    gscale = max(float(np.abs(v).max()) for v in want.values())
    shares = {k: float(np.abs(want[f"materials.{k}"]).max()) / gscale for k in CASES[case][5]}
    print(f"{case}: gscale {gscale:.4g}; medium leaves' largest |grad| / gscale: "
          + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    assert all(v >= 0.01 for v in shares.values()), shares


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_media_loss_and_grad_matches_jax(jax_cases, case, engine):
    """Each engine's setting; on sss and fog_mesh (hg, meshes) every one
    takes the lean engine, as in JAX."""
    _, depth, vol_nee, features, _, _ = CASES[case]
    want_loss, want, tp, ts, target = jax_cases[case]
    cfg = _cfg(RenderConfig, depth, vol_nee, features, **ENGINE_CFG[engine])
    loss, grads = diff.loss_and_grad(tp, ts, target, 1, prng_key(SEED), cfg, device="cpu")
    got = _flat(params_to_numpy(grads))
    assert sorted(want) == sorted(got)
    gscale = max(float(np.abs(v).max()) for v in want.values())
    worst = {k: float(np.abs(want[k] - got[k]).max()) for k in want}
    k_worst = max(worst, key=worst.get)
    print(f"{case} {engine}: loss JAX {want_loss:.9g} port {float(loss):.9g}; worst leaf "
          f"{k_worst} {worst[k_worst]:.3g} of gscale {gscale:.4g}")
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for k in want:
        assert np.isfinite(got[k]).all(), k
        assert worst[k] <= 5e-4 * gscale, (k, worst[k], gscale)


def test_lane_events_follow_the_residuals():
    """``ops/trace_grad.lane_events``, the path the card checks print for
    a lane beyond their bar, on vol_mini at depth 3: one entry per live
    bounce; where the lane lives on, a ``scatter`` starts its next bounce
    at the scatter point o + free path * d, a ``cross`` or ``surface`` at
    its winner's surface (o + t d, within 1e-3: the surface offset); every
    kind occurs."""
    from pathtracer_tpu_torch.ops import trace_grad
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.intersect import winner_t_gid_plain
    from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes
    from pathtracer_tpu_torch.scene.structs import Rays

    desc = dataclasses.replace(parse_scene_text(VOL_MINI, name="vol_mini"), resolution=RES)
    scene = desc.scene_for_frame(0, device="cpu")
    tables = pack_tables(scene)
    n, seed, feats = RES[0] * RES[1], 4321, frozenset({"volumetric"})
    pixel = torch.arange(n)
    rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel))
    _, _, resid = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction, pixel,
                                        max_depth=3, nee=True, rr=False, rr_start=3,
                                        features=feats)
    tail = trace_grad.tail_plane(feats)
    kinds = set()
    for lane in range(n):
        events = trace_grad.lane_events(tables[0], seed, pixel, resid, lane, feats).split(", ")
        assert len(events) == int((resid[:, tail + 1, lane] > 0.5).sum())
        for ev in events:
            dep, kind = int(ev.split(":")[0]), ev.split(":")[1].split()[0]
            kinds.add(kind)
            if dep + 1 >= resid.shape[0] or float(resid[dep + 1, tail + 1, lane]) < 0.5:
                continue  # the last bounce, a miss or a light hit
            o, d, nxt = resid[dep, 0:3, lane], resid[dep, 3:6, lane], resid[dep + 1, 0:3, lane]
            if kind == "scatter":
                u8 = hash_uniforms_planes(seed, pixel[lane:lane + 1], dep, 11)[8]
                dist = float(-torch.log(torch.clamp(1.0 - u8, 1e-7, 1.0))
                             / resid[dep, trace_grad.R_SS, lane])
            else:
                dist = float(winner_t_gid_plain(Rays(o[None], d[None]), tables[0])[0])
            assert float((nxt - (o + dist * d)).abs().max()) <= 1e-3, (lane, ev)
    assert kinds == {"miss", "surface", "scatter", "cross"}, kinds
