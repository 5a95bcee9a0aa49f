"""Meshes above the in-kernel cap (kernel 2's mesh-merge variant, 2mm) and
image textures on meshes (the box map, authored ``vt``, kernel 2m's UV
sweep) in the port against the JAX package, on the CPU.

The scenes are ``scene/variants.bigmesh_scene`` (``scenes/displace_demo.txt``
subdivided to 5,120 triangles), and ``variants.textured_mesh_scene`` with
a mesh the tests write: ``variants.grid_obj`` (a rippled grid with
authored ``vt``; 65 cells, 8,450 triangles, for the merge variant; 24
cells, 1,152 triangles, for the in-kernel sweep) or ``variants.quad_obj``,
turned and scaled unevenly in front of the back wall.  Inputs are made with
numpy from a seed and handed to both packages; the scenes cross with
``tests/test_torch_scene.port_scene_from_jax``.  Tolerances, with reasons:

* ``bounce_physics(mesh_in=...)`` (2mm's plain version) against JAX's on
  2,048 random lanes with the same mesh winner (JAX's ``mesh_only_hit``):
  ``tests/test_torch_surface.py``'s bar (floats within rtol 1e-5 / atol
  1e-6, booleans and emit states equal), the deferred shadow ray's planes
  within the same bar and its candidate bit equal, the deferred texel's
  slot equal and UV within 1e-5.  With ``bump`` and ``texture`` at most
  0.5% of lanes may miss (the bump's ``sin`` near 10^3 rad, checker-cell
  edges; measured printed).
* ``ops/bounce_fused.bounce_fused`` on the CPU (plain 2mm, the triangles'
  occlusion of the deferred shadow ray, the texel) against JAX's
  ``bounce_fused(interpret=True)``, and kernel 2mt's plain version against
  JAX's in-kernel branch: ``tests/test_torch_shade.py``'s bar.
* The plain UV sweep (``mesh_sweep(want_uv=True)``) against JAX's
  ``mesh_sweep_planes(want_uv=True)``: ``tests/test_torch_mesh_render.py``'s
  sweep bars, the UV within 1e-5, on at least 99.9% of lanes.
* The split route with image textures on meshes against JAX's split
  ``shade_bounce``: ``tests/test_torch_shade.py``'s bar.
* Renders of the 5,120-triangle scene at 16x16, depth 3, NEE, 2 spp on the
  megakernel route (the per-bounce scan on 2mm), the split route and both
  wavefront engines against JAX's CPU render:
  ``tests/test_torch_mesh_render.py::test_renders_match_jax``'s bars (equal
  ray counts, 99.5% of entries within 2e-4, sums within 2e-5).

The box map (ROADMAP queue 3): JAX's kernels (2m and 2mm) take a mesh
lane's object-space normal through the forward transform of the lane's
analytic winner behind the mesh (geom 0 on an analytic miss), where JAX's
split route takes the mesh geom's own; on a turned, unevenly scaled mesh the
two differ.  The port follows each route as it is, and
:func:`test_box_map_routes_differ_as_in_jax` pins the difference.
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
from pathtracer_tpu.ops import bounce_pallas as jb
from pathtracer_tpu.ops import texture as jtex
from pathtracer_tpu.ops.intersect import intersect_scene as jax_intersect_scene
from pathtracer_tpu.ops.intersect import mesh_only_hit as jax_mesh_only_hit
from pathtracer_tpu.ops.intersect_pallas import _pack_gdata
from pathtracer_tpu.ops.rng import hash_uniforms as jax_hash_uniforms
from pathtracer_tpu.render.common import shade_bounce as jax_shade_bounce
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse_scene_text
from pathtracer_tpu.scene.structs import Rays as JaxRays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce as tb
from pathtracer_tpu_torch.ops import bounce_fused, mesh, trace
from pathtracer_tpu_torch.ops.intersect import T_MIN
from pathtracer_tpu_torch.ops.mesh_tables import MESH_INKERNEL_MAX_TRIS, mesh_sweep
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.structs import Rays
from pathtracer_tpu_torch.scene.variants import (bigmesh_scene, grid_obj, quad_obj,
                                                 textured_mesh_scene)
from tests.test_torch_scene import port_scene_from_jax
from tests.test_torch_shade import _compare_bounce, random_lanes
from tests.test_torch_volume import _tables

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
BIG_CENTRE = (0.0, 1.8, 0.0)  # the displaced icosahedron's centre
MESH_CENTRE = (0.3, 2.4, 2.5)  # textured_mesh_scene's mesh


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    """The OBJ files the scenes name: paths by name."""
    d = tmp_path_factory.mktemp("bigmesh_objs")
    out = {}
    for name, text in (("grid65", grid_obj(65)), ("grid24", grid_obj(24)),
                       ("quad_vt", quad_obj(True)), ("quad", quad_obj(False))):
        out[name] = str(d / f"{name}.obj")
        with open(out[name], "w") as f:
            f.write(text)
    return out


def scene_text(name, objs):
    if name == "big":
        return bigmesh_scene(4)
    obj, bump = {"grid_bump": ("grid65", True), "grid": ("grid65", False),
                 "grid_small": ("grid24", False), "quad_vt": ("quad_vt", False),
                 "quad": ("quad", False)}[name]
    return textured_mesh_scene(objs[obj], bump=bump)


def both(name, objs):
    """``(jax scene, port scene)`` of a named scene, the same numbers."""
    jscene = jax_parse_scene_text(scene_text(name, objs), name=name,
                                  scene_dir=SCENES).scene_for_frame(0)
    return jscene, port_scene_from_jax(jscene)


def lanes_near(centre, n, seed, spread=0.8):
    lanes = random_lanes(n, seed=seed)
    lanes["origin"] = (lanes["origin"] * spread + np.asarray(centre)).astype(np.float32)
    return lanes


def aimed_lanes(centre, n, seed):
    """:func:`tests.test_torch_shade.random_lanes` with origins about 3 away
    from ``centre`` and directions towards a point within about 1 of it, so
    most rays meet the mesh (or the walls behind it)."""
    lanes = random_lanes(n, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    c = np.asarray(centre)
    o = c + lanes["direction"] * rng.uniform(2.0, 4.0, (n, 1))
    d = c + rng.standard_normal((n, 3)) * 0.6 - o
    lanes["origin"] = o.astype(np.float32)
    lanes["direction"] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return lanes


def jax_mesh_in(jscene, lanes, with_uv):
    """JAX's mesh winner of the lanes (``mesh_only_hit(with_attrs=True)``):
    JAX's ``mesh_in`` dict and the port's planes ``[8, N]`` / ``[3, N]``."""
    rays = JaxRays(origin=jnp.asarray(lanes["origin"]), direction=jnp.asarray(lanes["direction"]))
    et, epo, en, emid, _, muv, muvv = jax_mesh_only_hit(rays, jscene.geoms, jscene.meshes,
                                                        with_attrs=True)
    jin = dict(et=et, epo=tuple(epo[:, k] for k in range(3)),
               en=tuple(en[:, k] for k in range(3)), emid=emid)
    planes = np.concatenate([np.asarray(et)[None], np.asarray(epo).T, np.asarray(en).T,
                             np.asarray(emid, np.float32)[None]]).astype(np.float32)
    uv = None
    if with_uv:
        jin.update(muv_u=muv[:, 0], muv_v=muv[:, 1], muvv=jnp.where(muvv, 1.0, 0.0))
        uv = np.concatenate([np.asarray(muv).T, np.asarray(muvv, np.float32)[None]])
    return jin, torch.from_numpy(planes), None if uv is None else torch.from_numpy(uv)


def _compare_bounce_share(ref, got, tag, least):
    """``tests/test_torch_shade.py``'s bar on at least ``least`` of the live
    lanes, terminate, emit state and russian-roulette uniform on every lane:
    an image texture's sharp edges turn a last-ulp difference of the UV
    into a texel difference of a few 1e-5."""
    np.testing.assert_array_equal(got.terminate.numpy(), np.asarray(ref.terminate), tag)
    np.testing.assert_array_equal(got.was_specular.numpy(), np.asarray(ref.was_specular), tag)
    np.testing.assert_array_equal(got.rr_uniform.numpy(), np.asarray(ref.rr_uniform), tag)
    live = ~np.asarray(ref.terminate)
    ok = np.ones(live.shape, bool)
    for f in ("contrib", "next_origin", "next_direction", "throughput_mult", "next_medium"):
        ok &= np.isclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), rtol=2e-4,
                         atol=2e-5).all(-1)
    print(f"{tag}: live lanes within the bar {int(ok[live].sum())} of {int(live.sum())}")
    assert 0.2 < live.mean() < 0.95 and ok[live].mean() >= least


# case -> scene, features, NEE, the deferred texel, least share of lanes within the bar
PHYSICS_CASES = {
    "glossy_nee": ("big", frozenset({"glossy"}), True, False, 1.0),
    "glossy": ("big", frozenset({"glossy"}), False, False, 1.0),
    "texture_bump_glossy_nee": ("grid_bump", frozenset({"texture", "bump", "glossy"}), True, True,
                                0.995),
    "texture_bump_glossy": ("grid_bump", frozenset({"texture", "bump", "glossy"}), False, True,
                            0.995),
}


@pytest.mark.parametrize("case", sorted(PHYSICS_CASES))
def test_bounce_physics_mesh_in_matches_jax(objs, case):
    name, features, nee, tex_defer, least = PHYSICS_CASES[case]
    jscene, tscene = both(name, objs)
    assert sum(m.tri_verts.shape[0] for m in tscene.meshes) > MESH_INKERNEL_MAX_TRIS
    (gv, mv, lv, sv), port = _tables(jscene, tscene)
    n = 2048
    lanes = (lanes_near(BIG_CENTRE, n, seed=4) if name == "big"
             else aimed_lanes(MESH_CENTRE, n, seed=4))
    u = np.asarray(jax_hash_uniforms(jnp.uint32(5), jnp.asarray(lanes["sample"]),
                                     jnp.asarray(lanes["depth"]), 11))
    jin, planes, uv = jax_mesh_in(jscene, lanes, with_uv=tex_defer)
    on_mesh = planes[0].numpy() < 1e29
    zeros = np.zeros((n, 3), np.float32)

    def jp(a):
        return tuple(jnp.asarray(a[:, k]) for k in range(a.shape[1]))

    def tp(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(a.shape[1]))

    jout = jb.bounce_physics(
        jp(lanes["origin"]), jp(lanes["direction"]), jp(lanes["throughput"]), jp(zeros),
        jnp.zeros(n), gv, mv, lv, sv, list(jp(u)), jnp.asarray(lanes["depth"]),
        jnp.asarray(lanes["prev"]), jin, nee=nee, t_min=T_MIN, features=features,
        tex_defer=tex_defer,
    )
    tout = tb.bounce_physics(
        tp(lanes["origin"]), tp(lanes["direction"]), tp(lanes["throughput"]), tp(zeros),
        torch.zeros(n), *port, list(tp(u)), torch.from_numpy(lanes["depth"]),
        torch.from_numpy(lanes["prev"]), nee=nee, t_min=T_MIN, features=features,
        tex_defer=tex_defer, mesh_in=bounce_fused._mesh_in_dict(planes, uv),
    )
    ok = np.ones(n, bool)
    for k in ("contrib", "next_o", "next_d", "thr_mult"):
        want = np.stack([np.asarray(x) for x in jout[k]], -1)
        got = torch.stack(list(tout[k]), -1).numpy()
        ok &= np.isclose(got, want, rtol=1e-5, atol=1e-6).all(-1)
    for k in ("terminate", "wspec"):
        ok &= tout[k].numpy() == np.asarray(jout[k])
    np.testing.assert_array_equal(tout["rru"].numpy(), np.asarray(jout["rru"]))
    assert ("nee_deferred" in tout) == nee and (jout["nee_deferred"] is not None) == nee
    cand = 0
    if nee:
        jd, td = jout["nee_deferred"], tout["nee_deferred"]
        for k in ("x", "wi", "nee_rgb"):
            want = np.stack([np.asarray(x) for x in jd[k]], -1)
            ok &= np.isclose(torch.stack(list(td[k]), -1).numpy(), want, rtol=1e-5,
                             atol=1e-6).all(-1)
        ok &= np.isclose(td["dist"].numpy(), np.asarray(jd["dist"]), rtol=1e-5, atol=1e-6)
        ok &= td["cand_vis"].numpy() == np.asarray(jd["cand_vis"])
        cand = int(np.asarray(jd["cand_vis"]).sum())
    slots = 0
    if tex_defer:
        jt, tt = jout["tex_out"], tout["tex_out"]
        ok &= tt["slot"].numpy() == np.asarray(jt["slot"])
        for k in ("u", "v"):
            ok &= np.isclose(tt[k].numpy(), np.asarray(jt[k]), rtol=0, atol=1e-5)
        slots = int((np.asarray(jt["slot"]) >= 0).sum())
    print(f"{case}: {int(on_mesh.sum())} lanes on the mesh, {cand} deferred candidates, {slots} "
          f"image-textured events; lanes within the bar {ok.mean():.5f}")
    assert on_mesh.sum() > 200 and ok.mean() >= least
    assert (not nee or cand > 50) and (not tex_defer or slots > 100)


@pytest.mark.parametrize("case", [("big", True), ("big", False), ("grid", True)],
                         ids=["big_nee", "big", "grid_textured_nee"])
def test_bounce_fused_merge_matches_jax(objs, case):
    """The port's per-bounce step on a scene above the in-kernel cap (plain
    2mm, the deferred shadow ray's triangle occlusion and, with image
    textures, the texel and the authored UV) against JAX's ``bounce_fused``
    run in interpret mode."""
    name, nee = case
    jscene, tscene = both(name, objs)
    n = 384
    lanes = lanes_near(BIG_CENTRE if name == "big" else MESH_CENTRE, n, seed=8)
    features = ("glossy", "texture") if tscene.textures is not None else ("glossy",)
    key = jax.random.PRNGKey(7)
    ref = jb.bounce_fused(
        jscene, jnp.asarray(lanes["origin"]), jnp.asarray(lanes["direction"]),
        jnp.asarray(lanes["throughput"]), jnp.asarray(lanes["sample"]),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]), jnp.zeros((n, 4), jnp.float32),
        key, JaxConfig(nee=nee, features=features), interpret=True,
    )
    before = (bounce_fused.merge_launches, mesh.nearest_launches, mesh.min_launches)
    got = bounce_fused.bounce_fused(
        tscene, torch.from_numpy(lanes["origin"]), torch.from_numpy(lanes["direction"]),
        torch.from_numpy(lanes["throughput"]), torch.from_numpy(lanes["sample"]).long(),
        torch.from_numpy(lanes["depth"]), torch.from_numpy(lanes["prev"]), None,
        key_to_seed(prng_key(7)), RenderConfig(nee=nee, features=features),
    )
    assert (bounce_fused.merge_launches, mesh.nearest_launches, mesh.min_launches) == before
    _compare_bounce(ref, got, f"{name} nee={nee}")


def test_uv_sweep_matches_jax(objs):
    """The in-kernel sweep's plain version with ``want_uv`` against JAX's
    ``mesh_sweep_planes(want_uv=True)`` on a 1,152-triangle grid with
    authored ``vt``, on 2,048 rays around it."""
    jscene, tscene = both("grid_small", objs)
    assert tscene.mesh_tables is not None and tscene.mesh_tables.has_uv
    lanes = aimed_lanes(MESH_CENTRE, 2048, seed=14)
    o, d = (jnp.asarray(lanes[k]) for k in ("origin", "direction"))
    descs, tabs = jb.pack_mesh_tables(jscene.meshes)
    gvals = jb.read_gvals(_pack_gdata(jscene.geoms), jscene.geoms.count)
    want = jb.mesh_sweep_planes(descs, tabs, gvals, tuple(o[:, k] for k in range(3)),
                                tuple(d[:, k] for k in range(3)), T_MIN, True)
    gtab = tb.pack_tables(tscene)[0]
    got = mesh_sweep(tscene.mesh_tables, gtab, torch.from_numpy(lanes["origin"]).unbind(-1),
                     torch.from_numpy(lanes["direction"]).unbind(-1), want_uv=True)
    jet = np.asarray(want["et"])
    hit = jet < 1e29
    et = got["et"].numpy()
    ok = ((et < 1e29) == hit) & np.isclose(et, jet, rtol=1e-5, atol=1e-6)
    ok &= got["muvv"].numpy() == np.asarray(want["muvv"])
    for k in ("muv_u", "muv_v"):
        ok &= ~hit | np.isclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)
    for k, tol in (("en", 1e-5), ("epo", 1e-4)):
        g = np.stack([c.numpy() for c in got[k]], -1)
        w = np.stack([np.asarray(c) for c in want[k]], -1)
        ok &= ~hit | np.isclose(g, w, rtol=tol, atol=tol).all(-1)
    print(f"UV sweep: {int(hit.sum())} mesh hits; lanes within the bars {ok.mean():.6f}")
    assert hit.sum() > 200 and ok.mean() >= 0.999
    assert (np.asarray(want["muvv"])[hit] == 1.0).all()


@pytest.mark.parametrize("nee", [True, False])
def test_bounce_fused_mesh_tex_matches_jax(objs, nee):
    """Kernel 2mt's plain version (the deferred texel with the in-kernel
    sweep's authored UV) through ``bounce_fused`` against JAX's in-kernel
    branch in interpret mode."""
    jscene, tscene = both("grid_small", objs)
    n = 512
    lanes = aimed_lanes(MESH_CENTRE, n, seed=9)
    key = jax.random.PRNGKey(5)
    cfg = dict(nee=nee, features=("glossy", "texture"))
    ref = jb.bounce_fused(
        jscene, *(jnp.asarray(lanes[k]) for k in ("origin", "direction", "throughput", "sample",
                                                   "depth", "prev")),
        jnp.zeros((n, 4), jnp.float32), key, JaxConfig(**cfg), interpret=True,
    )
    before = bounce_fused.mesh_tex_launches
    got = bounce_fused.bounce_fused(
        tscene, *(torch.from_numpy(lanes[k]) for k in ("origin", "direction", "throughput")),
        torch.from_numpy(lanes["sample"]).long(), torch.from_numpy(lanes["depth"]),
        torch.from_numpy(lanes["prev"]), None, key_to_seed(prng_key(5)), RenderConfig(**cfg),
    )
    assert bounce_fused.mesh_tex_launches == before  # CPU: the plain version
    _compare_bounce_share(ref, got, f"2mt nee={nee}", 0.995)


@pytest.mark.parametrize("name", ["quad_vt", "quad", "grid"])
def test_split_route_mesh_textures_match_jax(objs, name):
    """``shade_bounce(fused=False)`` with an image texture on a mesh (the
    box map of ``M^T n_world``, or the authored ``vt``; kernels 9 and 10 or
    the LBVH around the split route) against JAX's split route."""
    jscene, tscene = both(name, objs)
    n = 1024
    lanes = aimed_lanes(MESH_CENTRE, n, seed=12)
    key = jax.random.PRNGKey(3)
    features = ("glossy", "texture")
    jrays = JaxRays(origin=jnp.asarray(lanes["origin"]), direction=jnp.asarray(lanes["direction"]))
    ref = jax_shade_bounce(
        jscene, jrays, *(jnp.asarray(lanes[k]) for k in ("throughput", "sample", "depth", "prev")),
        key, JaxConfig(nee=True, pallas=False, fused=False, features=features),
        medium_sigma=jnp.zeros((n, 4), jnp.float32),
    )
    got = shade_bounce(
        tscene, Rays(torch.from_numpy(lanes["origin"]), torch.from_numpy(lanes["direction"])),
        torch.from_numpy(lanes["throughput"]), torch.from_numpy(lanes["sample"]).long(),
        torch.from_numpy(lanes["depth"]), torch.from_numpy(lanes["prev"]),
        key_to_seed(prng_key(3)), RenderConfig(nee=True, fused=False, features=features),
    )
    _compare_bounce(ref, got, f"{name} split")


def test_box_map_routes_differ_as_in_jax(objs):
    """The check of the box map on mesh lanes.  On the unevenly scaled,
    turned quad (no ``vt``; geom 5, the back wall behind it), JAX's kernel
    route (``bounce_physics`` with the mesh winner merged) maps a mesh lane
    by the analytic winner's forward transform, JAX's split route by the
    mesh geom's own: the two UVs differ on some mesh lanes.  The port's
    plain 2mm gives the kernel route's UV, and its split route the split
    route's hit frame."""
    jscene, tscene = both("quad", objs)
    (gv, mv, lv, sv), port = _tables(jscene, tscene)
    n = 2048
    lanes = lanes_near(MESH_CENTRE, n, seed=21, spread=0.3)
    lanes["origin"] = (lanes["origin"] + np.array([0.0, 0.0, 4.0])).astype(np.float32)
    d = lanes["direction"] * 0.3 + np.array([0.0, 0.0, -1.0])
    lanes["direction"] = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    u = np.asarray(jax_hash_uniforms(jnp.uint32(5), jnp.asarray(lanes["sample"]),
                                     jnp.asarray(lanes["depth"]), 11))
    jin, planes, _ = jax_mesh_in(jscene, lanes, with_uv=False)
    mb = planes[0].numpy() < 1e29

    def jp(a):
        return tuple(jnp.asarray(a[:, k]) for k in range(a.shape[1]))

    def tp(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(a.shape[1]))

    zeros = np.zeros((n, 3), np.float32)
    common = dict(nee=False, t_min=T_MIN, features=frozenset({"texture"}), tex_defer=True)
    jout = jb.bounce_physics(
        jp(lanes["origin"]), jp(lanes["direction"]), jp(lanes["throughput"]), jp(zeros),
        jnp.zeros(n), gv, mv, lv, sv, list(jp(u)), jnp.asarray(lanes["depth"]),
        jnp.asarray(lanes["prev"]), jin, **common)
    tout = tb.bounce_physics(
        tp(lanes["origin"]), tp(lanes["direction"]), tp(lanes["throughput"]), tp(zeros),
        torch.zeros(n), *port, list(tp(u)), torch.from_numpy(lanes["depth"]),
        torch.from_numpy(lanes["prev"]), mesh_in=bounce_fused._mesh_in_dict(planes, None),
        **common)
    kernel_uv = np.stack([np.asarray(jout["tex_out"][k]) for k in ("u", "v")], -1)
    np.testing.assert_allclose(np.stack([tout["tex_out"][k].numpy() for k in ("u", "v")], -1),
                               kernel_uv, rtol=0, atol=1e-5)
    # JAX's split route: the hit's own geom, compute_uv of M^T n_world
    hit = jax_intersect_scene(JaxRays(jnp.asarray(lanes["origin"]),
                                      jnp.asarray(lanes["direction"])),
                              jscene.geoms, jscene.meshes)
    gid = np.asarray(hit.geom_id)
    assert (gid[mb] == 5).all()
    m3 = np.asarray(jscene.geoms.transform)[gid][:, :3, :3]
    n_obj = np.einsum("nij,ni->nj", m3, np.asarray(hit.normal))
    split_uv = np.asarray(jtex.compute_uv(jscene.geoms.type[gid], hit.position_obj,
                                          jnp.asarray(n_obj)))
    scale = np.asarray(jscene.materials.texture_scale)[1]
    # JAX's kernel route: the box map of the mesh normal through the
    # analytic winner's forward rows (and that winner's sphere flag)
    rays = JaxRays(jnp.asarray(lanes["origin"]), jnp.asarray(lanes["direction"]))
    behind = jax_intersect_scene(rays, jscene.geoms, ())
    agid = np.asarray(behind.geom_id)
    fwd = np.asarray(jscene.geoms.transform)[agid][:, :3, :3]
    n_k = np.einsum("nij,ni->nj", fwd, planes[4:7].numpy().T)
    sph = np.asarray(behind.hit) & (np.asarray(jscene.geoms.type)[agid] == 0)
    kernel_map = np.asarray(jtex.compute_uv(jnp.asarray(np.where(sph, 0, 2)),
                                            jnp.asarray(planes[1:4].numpy().T),
                                            jnp.asarray(n_k))) * scale
    as_kernel = np.isclose(kernel_uv, kernel_map, rtol=0, atol=1e-4).all(-1)
    differ = mb & ~np.isclose(kernel_uv, split_uv * scale, rtol=0, atol=1e-4).all(-1)
    print(f"mesh lanes {int(mb.sum())}: JAX's kernel UV is the analytic winner's box map on "
          f"{int(as_kernel[mb].sum())}; it differs from the split route's on {int(differ.sum())}; "
          f"analytic winners behind them {sorted(set(agid[mb].tolist()))}")
    assert mb.sum() > 200 and as_kernel[mb].mean() >= 0.999
    assert differ.sum() >= 0.1 * mb.sum()
    # the port's split route takes the split route's frame
    from pathtracer_tpu_torch.ops.intersect_cuda import nearest_hit
    th = nearest_hit(Rays(torch.from_numpy(lanes["origin"]), torch.from_numpy(lanes["direction"])),
                     port[0], tscene.meshes)
    np.testing.assert_array_equal(th.geom_id.numpy()[mb], gid[mb])
    np.testing.assert_allclose(th.normal.numpy()[mb], np.asarray(hit.normal)[mb], rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def big_render(objs):
    jscene, tscene = both("big", objs)
    jscene = dataclasses.replace(jscene, camera=dataclasses.replace(jscene.camera,
                                                                    resolution=(16, 16)))
    _, jacc, jst = jax_render(jscene, 2, JaxConfig(wavefront=False, nee=True, max_depth=3,
                                                   iters_per_launch=2))
    tscene = port_scene_from_jax(jscene)
    return tscene, np.asarray(jacc), int(jst["rays_traced"])


ENGINES = {"megakernel": dict(), "split": dict(fused=False), "pinned": dict(wavefront=True),
           "queue": dict(wavefront=True, wavefront_pinned=False)}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_big_mesh_renders_match_jax(big_render, engine):
    tscene, jacc, jrays = big_render
    assert not trace.fused_trace_eligible(tscene, RenderConfig())
    before = (trace.launches, trace.mesh_launches, bounce_fused.merge_launches)
    _, acc, st = render(tscene, 2, RenderConfig(nee=True, max_depth=3, iters_per_launch=2,
                                                **ENGINES[engine]), device="cpu")
    assert (trace.launches, trace.mesh_launches, bounce_fused.merge_launches) == before
    acc = acc.numpy()
    share = np.isclose(acc, jacc, rtol=2e-4, atol=2e-4).mean()
    sum_rel = abs(float(acc.sum()) - float(jacc.sum())) / float(jacc.sum())
    print(f"{engine}: {share:.5f} of entries within 2e-4, sums within {sum_rel:.3g}")
    assert st["rays_traced"] == jrays
    assert share >= 0.995 and sum_rel <= 2e-5
