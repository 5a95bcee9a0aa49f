"""Participating media in the port's plain versions against the JAX package,
on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
scenes cross with ``tests/test_torch_scene.port_scene_from_jax``.  The media
scenes are ``scenes/sss.txt`` (Henyey-Greenstein and isotropic scattering
spheres), ``fog.txt`` (a lamp inside an index-matched scattering cube),
``glass_dof.txt`` (Beer-Lambert absorption in glass) and the fog with
smooth_mesh's icosphere inside, glass or opaque (``scene/variants.
fog_mesh_scene``).  Tolerances, with reasons:

* ``uniform_sphere`` / ``henyey_greenstein`` / ``hg_phase_value`` against
  JAX's on 4,096 seeded inputs: within 1e-6 absolute on the unit
  directions and 1e-6 relative on the phase value (sin / cos and sqrt
  come from different libraries; the arithmetic is the same).
* ``occlusion_split_t`` and ``mesh_occ_split`` against JAX's
  ``occlusion_split_t`` / ``mesh_occ_split_planes`` on 2,048 rays from
  around each scene: the BIG (no hit) pattern equal, ``t`` within rtol 1e-5
  with a 1e-6 floor (``tests/test_torch_mesh_render.py``'s bar; the
  in-kernel split culls per lane, JAX per group of lanes, which changes no
  result).
* ``bounce_physics`` against JAX's ``bounce_physics`` (a pure function of
  planes, called eagerly) on 2,048 random lanes of sss with seeded nonzero
  medium carries (sigma_a, sigma_s and the phase g on 60% of lanes), with
  ``volumetric`` and with ``volumetric`` + ``hg``, NEE on and off:
  ``tests/test_torch_bounce.py``'s bar, floats within rtol 1e-5 / atol 1e-6
  and booleans and emit states equal, with no lane outside; the scatter
  lanes, the emit state 2 of a counted volumetric NEE and the vol-NEE
  contributions must all occur.
* ``shade_bounce``, both routes, against JAX's split ``shade_bounce`` on
  1,024 random lanes with seeded medium carries (sss, fog), NEE on and
  off: ``tests/test_torch_shade.py``'s bar (terminate, emit state and the
  russian-roulette uniform equal on every lane; contrib, continuation,
  throughput multiplier and the medium within rtol 2e-4, atol 2e-5 on live
  lanes).
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
from pathtracer_tpu.ops.intersect import occlusion_split_t as jax_occlusion_split_t
from pathtracer_tpu.ops.intersect_pallas import _pack_gdata
from pathtracer_tpu.ops.rng import hash_uniforms as jax_hash_uniforms
from pathtracer_tpu.render.common import shade_bounce as jax_shade_bounce
from pathtracer_tpu.render.diff import resolve_features as jax_resolve_features
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse_scene_text
from pathtracer_tpu.scene.structs import Rays as JaxRays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce as tb
from pathtracer_tpu_torch.ops import bounce_fused, bsdf
from pathtracer_tpu_torch.ops.intersect import T_MIN, occlusion_split_t
from pathtracer_tpu_torch.ops.mesh_tables import mesh_occ_split
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.scene.structs import Rays
from pathtracer_tpu_torch.scene.variants import fog_mesh_scene
from tests.test_torch_scene import port_scene_from_jax
from tests.test_torch_shade import _compare_bounce, random_lanes

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCENES = os.path.join(ROOT, "scenes")


def jax_scene(name):
    """A media scene of the JAX package: a file of ``scenes/`` or
    ``fog_mesh_glass`` / ``fog_mesh_opaque``."""
    if name.startswith("fog_mesh"):
        text = fog_mesh_scene(refractive=name.endswith("glass"))
        return jax_parse_scene_text(text, name=name, scene_dir=SCENES).scene_for_frame(0)
    return jax_load_scene(os.path.join(SCENES, f"{name}.txt")).scene_for_frame(0)


def medium_carries(n: int, seed: int = 9):
    """Seeded numpy media: sigma_a rgb, sigma_s and the phase g, nonzero on
    about 60% of lanes each."""
    rng = np.random.default_rng(seed)
    sa = (rng.uniform(0.0, 0.3, (n, 3)) * (rng.random((n, 1)) < 0.6)).astype(np.float32)
    ss = (rng.uniform(0.0, 3.0, n) * (rng.random(n) < 0.6)).astype(np.float32)
    g = (rng.uniform(-0.9, 0.9, n) * (rng.random(n) < 0.6)).astype(np.float32)
    return sa, ss, g


def scene_rays(n: int, seed: int, centre=(0.0, 1.0, 0.0), spread=3.0):
    """Numpy rays from around a scene's centre, unit directions."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    o = rng.standard_normal((n, 3)) * spread + np.asarray(centre)
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_phase_functions_match_jax():
    rng = np.random.default_rng(2)
    n = 4096
    xi = rng.random((n, 2), dtype=np.float32)
    g = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    g[::7] = 0.0
    g[1::7] = rng.uniform(-1e-3, 1e-3, len(g[1::7]))  # the near-isotropic branch
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cos = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(xi=xi, g=g, d=d, cos=cos).items()}

    want = np.asarray(jbsdf.uniform_sphere(jnp.asarray(xi[:, 0]), jnp.asarray(xi[:, 1])))
    got = bsdf.uniform_sphere(t["xi"][:, 0], t["xi"][:, 1]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(jbsdf.henyey_greenstein(jnp.asarray(d), jnp.asarray(g),
                                              jnp.asarray(xi[:, 0]), jnp.asarray(xi[:, 1])))
    got = bsdf.henyey_greenstein(t["d"], t["g"], t["xi"][:, 0], t["xi"][:, 1]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    want = np.asarray(jbsdf.hg_phase_value(jnp.asarray(g), jnp.asarray(cos)))
    got = bsdf.hg_phase_value(t["g"], t["cos"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # g = 0 is isotropic
    np.testing.assert_allclose(got[g == 0.0], 1.0 / (4.0 * np.pi), rtol=1e-6)


OCC_SCENES = {"sss": (0.0, 1.2, 0.0), "glass_dof": (0.0, 1.4, 0.0), "fog": (0.0, 0.0, 0.0),
              "fog_mesh_glass": (-0.6, -0.4, 0.5), "fog_mesh_opaque": (-0.6, -0.4, 0.5)}


@pytest.mark.parametrize("name", sorted(OCC_SCENES))
def test_occlusion_split_matches_jax(name):
    jscene = jax_scene(name)
    tscene = port_scene_from_jax(jscene)
    o, d = scene_rays(2048, seed=5, centre=OCC_SCENES[name], spread=1.5)
    want_op, want_re = (np.asarray(t) for t in jax_occlusion_split_t(
        JaxRays(origin=jnp.asarray(o), direction=jnp.asarray(d)), jscene.geoms,
        jscene.materials, jscene.meshes))
    gtab, mtab = tb.pack_tables(tscene)[:2]
    got_op, got_re = (t.numpy() for t in occlusion_split_t(
        Rays(torch.from_numpy(o), torch.from_numpy(d)), gtab, mtab, tscene.meshes))
    print(f"{name}: opaque hits {int((want_op < 1e29).sum())}, refractive "
          f"{int((want_re < 1e29).sum())} of 2048")
    assert (want_re < 1e29).sum() > 100  # a refractive boundary on many rays
    for got, want in ((got_op, want_op), (got_re, want_re)):
        np.testing.assert_array_equal(got < 1e29, want < 1e29)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("refractive", [True, False])
def test_mesh_occ_split_matches_jax(refractive):
    name = "fog_mesh_glass" if refractive else "fog_mesh_opaque"
    jscene = jax_scene(name)
    tscene = port_scene_from_jax(jscene)
    o, d = scene_rays(2048, seed=8, centre=OCC_SCENES[name], spread=1.5)
    descs, tabs = jb.pack_mesh_tables(jscene.meshes)
    gd = _pack_gdata(jscene.geoms)
    gvals = jb.read_gvals(gd, jscene.geoms.count)
    mvals = jb.read_mvals(jb.pack_material_table(jscene.materials), jscene.materials.count)
    want = jb.mesh_occ_split_planes(descs, tabs, gvals, mvals, tuple(jnp.asarray(o[:, k]) for k in range(3)),
                                    tuple(jnp.asarray(d[:, k]) for k in range(3)), T_MIN)
    gtab, mtab = tb.pack_tables(tscene)[:2]
    got = mesh_occ_split(tscene.mesh_tables, gtab, mtab, torch.from_numpy(o).unbind(-1),
                         torch.from_numpy(d).unbind(-1))
    hits = [int((np.asarray(w) < 1e29).sum()) for w in want]
    print(f"{name}: mesh hits opaque / refractive {hits}")
    assert hits[1 if refractive else 0] > 100 and hits[0 if refractive else 1] == 0
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy() < 1e29, w < 1e29)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def _tables(jscene, tscene):
    jt = (_pack_gdata(jscene.geoms), jb.pack_material_table(jscene.materials),
          jb.pack_light_table(jscene.geoms, jscene.materials), jb.pack_scalars(jscene))
    port = tb.pack_tables(tscene)
    for want, got in zip(jt, port):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = [[[jnp.float32(v) for v in row] for row in np.asarray(t).tolist()] for t in jt[:3]]
    return (*vals, [jnp.float32(v) for v in np.asarray(jt[3])]), port


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("hg", [False, True])
def test_bounce_physics_media_matches_jax(hg, nee):
    jscene = jax_scene("sss")
    (gv, mv, lv, sv), port = _tables(jscene, port_scene_from_jax(jscene))
    feats = frozenset({"volumetric", "hg"} if hg else {"volumetric"})
    n = 2048
    lanes = random_lanes(n, seed=4)
    sa, ss, g = medium_carries(n)
    u = np.asarray(jax_hash_uniforms(jnp.uint32(5), jnp.asarray(lanes["sample"]),
                                     jnp.asarray(lanes["depth"]), 11))

    def jplanes(a):
        return tuple(jnp.asarray(a[:, k]) for k in range(a.shape[1]))

    def tplanes(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(a.shape[1]))

    jout = jb.bounce_physics(
        jplanes(lanes["origin"]), jplanes(lanes["direction"]), jplanes(lanes["throughput"]),
        jplanes(sa), jnp.asarray(ss), gv, mv, lv, sv, list(jplanes(u)),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]),
        medium_g=jnp.asarray(g) if hg else None, nee=nee, t_min=T_MIN, features=feats,
    )
    tout = tb.bounce_physics(
        tplanes(lanes["origin"]), tplanes(lanes["direction"]), tplanes(lanes["throughput"]),
        tplanes(sa), torch.from_numpy(ss), *port, list(tplanes(u)),
        torch.from_numpy(lanes["depth"]), torch.from_numpy(lanes["prev"]), nee=nee, t_min=T_MIN,
        features=feats, medium_g=torch.from_numpy(g) if hg else None,
    )
    bad = np.zeros(n, bool)
    for k in ("contrib", "next_o", "next_d", "thr_mult", "out_ma"):
        want = np.stack([np.asarray(x) for x in jout[k]], -1)
        got = torch.stack(list(tout[k]), -1).numpy()
        bad |= ~np.isclose(got, want, rtol=1e-5, atol=1e-6).all(-1)
    bad |= ~np.isclose(tout["out_ms"].numpy(), np.asarray(jout["out_ms"]), rtol=1e-5, atol=1e-6)
    if hg:
        bad |= tout["out_mg"].numpy() != np.asarray(jout["out_mg"])
    for k in ("terminate", "wspec"):
        bad |= tout[k].numpy() != np.asarray(jout[k])
    np.testing.assert_array_equal(tout["rru"].numpy(), np.asarray(jout["rru"]))
    # the lanes the media blocks own: in-medium scatter (the continuation
    # leaves from the free path's end), counted volumetric NEE (state 2)
    free_path = -np.log(np.clip(1.0 - u[:, 8], 1e-7, 1.0)) / np.maximum(ss, 1e-12)
    moved = np.linalg.norm(np.stack([np.asarray(x) for x in jout["next_o"]], -1)
                           - lanes["origin"], axis=-1)
    scatter = (ss > 0) & np.isclose(moved, free_path, rtol=1e-4)
    state2 = np.asarray(jout["wspec"]) == 2.0
    print(f"hg={hg} nee={nee}: lanes outside the bar {int(bad.sum())}; in-medium scatter "
          f"{int(scatter.sum())}, counted vol-NEE (state 2) {int(state2.sum())}")
    assert int(bad.sum()) == 0
    assert int(scatter.sum()) > 100
    if nee:
        assert int(state2.sum()) > 20
    # prev states 2 (post-scatter chains) are among the inputs
    assert (lanes["prev"] == 2.0).any()


SHADE_SCENES = {"sss": (0.0, 1.2, 0.0), "fog": (0.0, 0.0, 0.0)}


@pytest.mark.parametrize("nee", [True, False])
@pytest.mark.parametrize("name", sorted(SHADE_SCENES))
def test_shade_bounce_media_both_routes_match_jax(name, nee):
    jscene = jax_scene(name)
    features = jax_resolve_features(JaxConfig(), jscene.materials).features
    assert "volumetric" in features and (("hg" in features) == (name == "sss"))
    n = 1024
    lanes = random_lanes(n, seed=11)
    lanes["origin"] = (lanes["origin"] * 0.5 + np.asarray(SHADE_SCENES[name])).astype(np.float32)
    sa, ss, g = medium_carries(n, seed=3)
    width = 5 if "hg" in features else 4
    medium = np.concatenate([sa, ss[:, None], g[:, None]], -1)[:, :width]
    key = jax.random.PRNGKey(7)
    jrays = JaxRays(origin=jnp.asarray(lanes["origin"]), direction=jnp.asarray(lanes["direction"]))
    ref = jax_shade_bounce(
        jscene, jrays, jnp.asarray(lanes["throughput"]), jnp.asarray(lanes["sample"]),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]), key,
        JaxConfig(nee=nee, pallas=False, fused=False, features=features),
        medium_sigma=jnp.asarray(medium),
    )
    tscene = port_scene_from_jax(jscene)
    rays = Rays(origin=torch.from_numpy(lanes["origin"]),
                direction=torch.from_numpy(lanes["direction"]))
    args = (tscene, rays, torch.from_numpy(lanes["throughput"]),
            torch.from_numpy(lanes["sample"]).long(), torch.from_numpy(lanes["depth"]),
            torch.from_numpy(lanes["prev"]), key_to_seed(prng_key(7)))
    before = (bounce_fused.launches, bounce_fused.vol_launches, bounce_fused.hg_launches)
    for fused in (None, False):
        cfg = RenderConfig(nee=nee, fused=fused, features=features)
        got = shade_bounce(*args, cfg, medium_sigma=torch.from_numpy(medium))
        _compare_bounce(ref, got, f"{name}, fused={fused}, nee={nee}")
        assert got.next_medium.shape == (n, width)
    assert (bounce_fused.launches, bounce_fused.vol_launches,
            bounce_fused.hg_launches) == before  # CPU tensors take the plain versions
    state = np.asarray(ref.was_specular)
    print(f"{name} nee={nee}: emit states {[int((state == v).sum()) for v in (0, 1, 2)]}")
    if nee:
        assert (state == 2.0).any()
