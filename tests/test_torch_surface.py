"""The optional surface physics of the port's plain versions against the JAX
package, on the CPU: the Cook-Torrance GGX and Ward lobes, the checker /
stripes texture, the sinusoidal bump and image textures.

Inputs are made with numpy from a seed and handed to both packages; the
scenes cross with ``tests/test_torch_scene.port_scene_from_jax``.  The
scenes are ``scenes/ward.txt`` (Ward floor and sphere), its GGX copy
(``scene/variants.ggx_ward_scene``: the sphere Cook-Torrance), ``textured.txt``
with stripes on its red wall (``variants.striped_scene``; checker floor
and walls, a bumped sphere) and ``textured_image.txt`` (an image-textured cube and
sphere).  Tolerances, with reasons:

* ``ggx_sample`` / ``ward_sample`` and the microfacet ``sample_bsdf`` of
  the split route against JAX's on 4,096 seeded inputs: directions and
  weights within 2e-5 absolute (sin / cos / log / sqrt come from other
  libraries, and XLA's CPU reductions round the dot products apart;
  measured below 2e-6), the validity and lobe choices equal.
* ``bounce_physics`` (the kernels' plain version) against JAX's on 2,048
  random lanes with ``texture``, ``bump``, ``microfacet`` and ``microfacet``
  + ``ward``, NEE on: ``tests/test_torch_bounce.py``'s bar, floats within
  rtol 1e-5 / atol 1e-6 and booleans and emit states equal.  The bump's
  ``sin`` reaches arguments near 10^3 rad, where one ulp of the phase moves
  the perturbed normal by about 1e-4, and checker-cell edges flip whole
  lanes, so ``bump`` and ``texture`` may leave at most 0.5% of lanes
  outside the bar (measured 0 to 0.15%); the others none.
* The deferred texel's UV and slot (``tex_defer``) against JAX's: slot
  equal on every lane, UV within 1e-5 (the same polynomial atan2).
* ``compute_uv``, ``sample_atlas``, ``build_atlas`` and ``decode_srgb``
  against JAX's: the atlas and the decoded texels equal (the same float32
  arithmetic), the UV within 1e-6 (libm atan2 / asin), the texel within
  1e-6 (JAX's one-hot HIGHEST-precision fetch gives exact texels).
* ``ops/bounce_fused.bounce_fused`` on the CPU (the plain version with the
  deferred texel multiplied in) against JAX's ``bounce_fused(interpret=
  True)`` on textured_image: ``tests/test_torch_shade.py``'s bar.
* ``shade_bounce``, both routes, against JAX's split ``shade_bounce`` on
  1,024 random lanes of each scene: ``tests/test_torch_shade.py``'s bar
  (terminate, emit state and the russian-roulette uniform equal on every
  lane; contrib, continuation, multiplier and medium within rtol 2e-4 /
  atol 2e-5 on live lanes).  On textured the bump and the checker edges flip
  lanes as above: at most 0.5% of live lanes outside (measured below
  0.2%), emit states and terminate equal.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.ops import bounce_pallas as jb
from pathtracer_tpu.ops import bsdf as jbsdf
from pathtracer_tpu.ops import texture as jtex
from pathtracer_tpu.ops.rng import hash_uniforms as jax_hash_uniforms
from pathtracer_tpu.render.common import shade_bounce as jax_shade_bounce
from pathtracer_tpu.render.diff import resolve_features as jax_resolve_features
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse_scene_text
from pathtracer_tpu.scene.structs import Rays as JaxRays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce as tb
from pathtracer_tpu_torch.ops import bounce_fused, bsdf, texture
from pathtracer_tpu_torch.ops.intersect import T_MIN
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.scene.structs import Rays
from pathtracer_tpu_torch.scene.variants import ggx_ward_scene, striped_scene
from pathtracer_tpu_torch.utils.imageio import load_png
from tests.test_torch_scene import port_scene_from_jax
from tests.test_torch_shade import random_lanes
from tests.test_torch_volume import _tables

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENES = os.path.join(ROOT, "scenes")


STRIPED = striped_scene()

# scene -> the centre the random lanes start around
CENTRES = {"ward": (0.0, 2.0, 0.0), "ggx_ward": (0.0, 2.0, 0.0), "striped": (0.0, 4.0, -1.0),
           "textured_image": (0.0, 2.0, 0.0)}


def jax_scene(name):
    if name == "ggx_ward":
        return jax_parse_scene_text(ggx_ward_scene(), name=name).scene_for_frame(0)
    if name == "striped":
        return jax_parse_scene_text(STRIPED, name=name, scene_dir=SCENES).scene_for_frame(0)
    return jax_load_scene(os.path.join(SCENES, f"{name}.txt")).scene_for_frame(0)


def lanes_around(name, n, seed):
    lanes = random_lanes(n, seed=seed)
    lanes["origin"] = (lanes["origin"] * 0.8 + np.asarray(CENTRES[name])).astype(np.float32)
    return lanes


def _unit(rng, n):
    d = rng.standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_ggx_and_ward_lobes_match_jax():
    rng = np.random.default_rng(21)
    n = 4096
    nrm, d_in = _unit(rng, n), _unit(rng, n)
    flip = np.sum(nrm * d_in, -1) > 0  # the lobes take n against the incident ray
    nrm[flip] *= -1.0
    cos_i = np.abs(np.sum(nrm * d_in, -1)).astype(np.float32)
    rough = rng.uniform(0.0, 1.2, n).astype(np.float32)
    rough_y = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(0.0, 1.2, n)).astype(np.float32)
    spec = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    xi = rng.random((n, 2), dtype=np.float32)
    xi[:16, 0] = 0.0  # the clamped ends of the sampling
    xi[16:32, 0] = 1.0
    j = {k: jnp.asarray(v) for k, v in dict(n=nrm, d=d_in, c=cos_i, r=rough, ry=rough_y, s=spec,
                                             x=xi).items()}
    t = {k: torch.from_numpy(v) for k, v in dict(n=nrm, d=d_in, c=cos_i, r=rough, ry=rough_y,
                                                  s=spec, x=xi).items()}
    pairs = (
        (jbsdf.ggx_sample(j["n"], j["d"], j["c"], j["r"], j["s"], j["x"][:, 0], j["x"][:, 1]),
         bsdf.ggx_sample(t["n"], t["d"], t["c"], t["r"], t["s"], t["x"][:, 0], t["x"][:, 1])),
        (jbsdf.ward_sample(j["n"], j["d"], j["c"], j["r"], j["ry"], j["s"], j["x"][:, 0],
                           j["x"][:, 1]),
         bsdf.ward_sample(t["n"], t["d"], t["c"], t["r"], t["ry"], t["s"], t["x"][:, 0],
                          t["x"][:, 1])),
    )
    for lobe, ((jd, jw), (td, tw)) in zip(("ggx", "ward"), pairs):
        jd, jw = np.asarray(jd), np.asarray(jw)
        err = max(float(np.abs(td.numpy() - jd).max()), float(np.abs(tw.numpy() - jw).max()))
        valid = (jw != 0).any(-1)
        print(f"{lobe}: max abs difference {err:.3g}; valid samples {int(valid.sum())} of {n}")
        np.testing.assert_array_equal((tw.numpy() != 0).any(-1), valid, lobe)
        assert 0.2 < valid.mean() < 1.0 and err <= 2e-5


def _material_lanes(jscene, n, seed):
    """Random material ids of ``jscene``, normals, incident rays and
    uniforms, as numpy."""
    rng = np.random.default_rng(seed)
    mid = rng.integers(0, jscene.materials.count, n).astype(np.int32)
    return mid, _unit(rng, n), _unit(rng, n), rng.random((n, 3), dtype=np.float32)


@pytest.mark.parametrize("flags", [dict(microfacet=True, ward=False),
                                   dict(microfacet=True, ward=True)],
                         ids=["microfacet", "microfacet+ward"])
@pytest.mark.parametrize("name", ["ward", "ggx_ward"])
def test_sample_bsdf_microfacet_matches_jax(name, flags):
    jscene = jax_scene(name)
    tscene = port_scene_from_jax(jscene)
    n = 4096
    mid, nrm, d_in, u = _material_lanes(jscene, n, seed=5)
    pos = np.zeros((n, 3), np.float32)
    jmat = jbsdf.gather_materials(jscene.materials, jnp.asarray(mid))
    want = jbsdf.sample_bsdf(jmat, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(d_in),
                             jnp.asarray(u), **flags)
    tmat = bsdf.gather_materials(tb.pack_material_table(tscene.materials), torch.from_numpy(mid))
    got = bsdf.sample_bsdf(tmat, torch.from_numpy(pos), torch.from_numpy(nrm),
                           torch.from_numpy(d_in), torch.from_numpy(u), **flags)
    for f in ("is_specular", "transmitted", "entering"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    for f in ("direction", "origin", "throughput_mult"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=2e-5, err_msg=f)


def _run_physics(name, features, n, seed, tex_defer=False, nee=True):
    jscene = jax_scene(name)
    (gv, mv, lv, sv), port = _tables(jscene, port_scene_from_jax(jscene))
    lanes = lanes_around(name, n, seed)
    u = np.asarray(jax_hash_uniforms(jnp.uint32(5), jnp.asarray(lanes["sample"]),
                                     jnp.asarray(lanes["depth"]), 11))
    zeros = np.zeros((n, 3), np.float32)

    def jplanes(a):
        return tuple(jnp.asarray(a[:, k]) for k in range(a.shape[1]))

    def tplanes(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(a.shape[1]))

    jout = jb.bounce_physics(
        jplanes(lanes["origin"]), jplanes(lanes["direction"]), jplanes(lanes["throughput"]),
        jplanes(zeros), jnp.zeros(n), gv, mv, lv, sv, list(jplanes(u)),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]), nee=nee, t_min=T_MIN,
        features=features, tex_defer=tex_defer,
    )
    tout = tb.bounce_physics(
        tplanes(lanes["origin"]), tplanes(lanes["direction"]), tplanes(lanes["throughput"]),
        tplanes(zeros), torch.zeros(n), *port, list(tplanes(u)),
        torch.from_numpy(lanes["depth"]), torch.from_numpy(lanes["prev"]), nee=nee,
        t_min=T_MIN, features=features, tex_defer=tex_defer,
    )
    return jout, tout


def _lanes_outside(jout, tout, n):
    bad = np.zeros(n, bool)
    for k in ("contrib", "next_o", "next_d", "thr_mult"):
        want = np.stack([np.asarray(x) for x in jout[k]], -1)
        got = torch.stack(list(tout[k]), -1).numpy()
        bad |= ~np.isclose(got, want, rtol=1e-5, atol=1e-6).all(-1)
    for k in ("terminate", "wspec"):
        bad |= tout[k].numpy() != np.asarray(jout[k])
    np.testing.assert_array_equal(tout["rru"].numpy(), np.asarray(jout["rru"]))
    return bad


# feature set -> scene, the share of lanes the bar may miss
PHYSICS_CASES = {
    "texture": ("striped", frozenset({"texture"}), 0.005),
    "bump": ("striped", frozenset({"bump"}), 0.005),
    "texture+bump": ("striped", frozenset({"texture", "bump"}), 0.005),
    "microfacet": ("ggx_ward", frozenset({"microfacet"}), 0.0025),
    "microfacet+ward": ("ggx_ward", frozenset({"microfacet", "ward"}), 0.0025),
}


@pytest.mark.parametrize("case", sorted(PHYSICS_CASES))
def test_bounce_physics_surface_matches_jax(case):
    name, features, most = PHYSICS_CASES[case]
    n = 2048
    jout, tout = _run_physics(name, features, n, seed=4)
    bad = _lanes_outside(jout, tout, n)
    # the lanes the feature changes: the same bounce without it
    _, plain = _run_physics(name, frozenset(), n, seed=4)
    changed = np.zeros(n, bool)
    for k in ("contrib", "next_d", "thr_mult"):
        differ = torch.stack(list(tout[k]), -1) != torch.stack(list(plain[k]), -1)
        changed |= differ.any(-1).numpy()
    print(f"{case}: lanes outside the bar {int(bad.sum())} of {n}; lanes the feature changed "
          f"{int(changed.sum())}")
    assert bad.mean() <= most
    assert changed.sum() > 50


def test_deferred_texel_planes_match_jax():
    n = 2048
    jout, tout = _run_physics("textured_image", frozenset({"texture"}), n, seed=6,
                              tex_defer=True)
    assert _lanes_outside(jout, tout, n).sum() == 0
    jt, tt = jout["tex_out"], tout["tex_out"]
    slot = np.asarray(jt["slot"])
    np.testing.assert_array_equal(tt["slot"].numpy(), slot)
    for k in ("u", "v"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]), rtol=0, atol=1e-5, err_msg=k)
    print(f"image-textured surface events: {int((slot >= 0).sum())} of {n}")
    assert (slot >= 0).sum() > 100 and (slot < 0).sum() > 100


def test_texture_helpers_match_jax():
    rng = np.random.default_rng(3)
    img = load_png(os.path.join(SCENES, "assets", "quadrants.png"))
    other = rng.integers(0, 256, (24, 40, 4)).astype(np.uint8)  # RGBA, another size
    dec = [texture.decode_srgb(im) for im in (img, other)]
    for got, im in zip(dec, (img, other)):
        np.testing.assert_array_equal(got, jtex.decode_srgb(im))
    jatlas = jtex.build_atlas(dec)
    tatlas = texture.build_atlas(dec, device="cpu")
    np.testing.assert_array_equal(tatlas.data.numpy(), np.asarray(jatlas.data))
    np.testing.assert_array_equal(tatlas.hw.numpy(), np.asarray(jatlas.hw))
    assert tatlas.count == 2 and tuple(tatlas.data.shape) == (2, 64, 64, 3)

    n = 4096
    gtype = rng.integers(0, 3, n).astype(np.int32)
    p_obj = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    n_obj = _unit(rng, n)
    want = np.asarray(jtex.compute_uv(jnp.asarray(gtype), jnp.asarray(p_obj), jnp.asarray(n_obj)))
    got = texture.compute_uv(torch.from_numpy(gtype), torch.from_numpy(p_obj),
                             torch.from_numpy(n_obj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    tex_id = rng.integers(-1, 2, n).astype(np.float32)
    uv = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    want = np.asarray(jtex.sample_atlas(jatlas, jnp.asarray(tex_id), jnp.asarray(uv)))
    got = texture.sample_atlas(tatlas, torch.from_numpy(tex_id), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[tex_id < 0] == 1.0).all() and (got[tex_id >= 0] != 1.0).any()


def test_bounce_fused_deferred_texel_matches_jax():
    """The port's per-bounce step with the deferred texel (the plain version
    of kernel 2t and the wrapper's texel multiply) against JAX's
    ``bounce_fused`` run in interpret mode."""
    from pathtracer_tpu.ops.bounce_pallas import bounce_fused as jax_bounce_fused
    from tests.test_torch_shade import _compare_bounce

    jscene = jax_scene("textured_image")
    n = 1024
    lanes = lanes_around("textured_image", n, seed=8)
    key = jax.random.PRNGKey(7)
    cfg = JaxConfig(nee=True, features=("texture",))
    ref = jax_bounce_fused(
        jscene, jnp.asarray(lanes["origin"]), jnp.asarray(lanes["direction"]),
        jnp.asarray(lanes["throughput"]), jnp.asarray(lanes["sample"]),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]), jnp.zeros((n, 4), jnp.float32),
        key, cfg, interpret=True,
    )
    tscene = port_scene_from_jax(jscene)
    before = (bounce_fused.tex_launches, bounce_fused.surf_launches)
    got = bounce_fused.bounce_fused(
        tscene, torch.from_numpy(lanes["origin"]), torch.from_numpy(lanes["direction"]),
        torch.from_numpy(lanes["throughput"]), torch.from_numpy(lanes["sample"]).long(),
        torch.from_numpy(lanes["depth"]), torch.from_numpy(lanes["prev"]), None,
        key_to_seed(prng_key(7)), RenderConfig(nee=True, features=("texture",)),
    )
    assert (bounce_fused.tex_launches, bounce_fused.surf_launches) == before  # CPU: plain
    _compare_bounce(ref, got, "textured_image deferred texel")


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", ["ward", "ggx_ward", "striped", "textured_image"])
def test_shade_bounce_surface_both_routes_match_jax(name, nee):
    jscene = jax_scene(name)
    features = jax_resolve_features(JaxConfig(), jscene.materials).features
    n = 1024
    lanes = lanes_around(name, n, seed=11)
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
    most = 0.005 if name == "striped" else 0.0
    live = ~np.asarray(ref.terminate)
    assert 0.2 < live.mean() < 0.95
    for fused in (None, False):
        got = shade_bounce(*args, RenderConfig(nee=nee, fused=fused, features=features))
        np.testing.assert_array_equal(got.terminate.numpy(), np.asarray(ref.terminate))
        np.testing.assert_array_equal(got.was_specular.numpy(), np.asarray(ref.was_specular))
        np.testing.assert_array_equal(got.rr_uniform.numpy(), np.asarray(ref.rr_uniform))
        bad = np.zeros(n, bool)
        for f in ("contrib", "next_origin", "next_direction", "throughput_mult", "next_medium"):
            bad |= ~np.isclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                               rtol=2e-4, atol=2e-5).all(-1)
        print(f"{name} fused={fused} nee={nee} ({features}): live lanes outside the bar "
              f"{int((bad & live).sum())} of {int(live.sum())}")
        assert (bad & live).sum() <= most * live.sum()
