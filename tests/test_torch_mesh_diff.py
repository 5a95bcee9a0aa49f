"""Differentiable meshes on the port's lean engine against the JAX package, on
the CPU: ``SceneParams.mesh_verts`` leaves, the LBVH cache and
``ops/accel.refresh_accel``, and ``intersect_scene_lean`` with meshes.

Inputs cross as numpy (``scene/convert.params_from_numpy`` with
``mesh_verts``).  Tolerances, with reasons:

* ``loss_and_grad`` against JAX's lean ``loss_and_grad`` (``grad_fused=
  False``; JAX runs the lean graph both ways on the CPU) on smooth_mesh
  (320 triangles: with its LBVH the winner search runs kernel 9's plain
  version in the LBVH's scan order, without it in file order) and on the
  displaced icosahedron of ``scene/variants.bigmesh_scene(5)`` (20,480
  triangles: the LBVH traversal), at 12x12, depth 2, NEE, 1 spp: the loss
  within 1e-6 relative (the forward is the port's fast forward, kernel
  1m's or the scan on 2mm's plain version, which rounds apart from JAX's
  lean graph in the last ulps) and every leaf within 5e-4 of the largest
  gradient, ``tests/test_torch_diff.py``'s bar.
* Central finite differences of the mesh's translation and of a rigid shift
  of its vertices against the gradients, on ``scenes/mesh_demo.txt`` at
  20x20 as ``tests/test_grad.py:188-260`` (rtol 0.5: float32 losses of a
  2-spp render, FD step 2e-3).
* A vertex optimization with large steps, as ``tests/test_grad.py:446``:
  the loss and vertex gradients with the LBVH (rebound to the moved
  vertices every step) equal those without it within rtol 1e-5 / 1e-4
  (atol 1e-7 / 1e-6), after the vertices have moved more than 0.05.
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
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse_scene_text
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import accel, mesh
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from pathtracer_tpu_torch.scene.displace import displace_mesh
from pathtracer_tpu_torch.scene.obj import load_obj_full
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from pathtracer_tpu_torch.scene.structs import MATERIAL_FIELDS
from pathtracer_tpu_torch.scene.variants import bigmesh_scene

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _scene_text(name):
    if name == "ico_20480":
        return bigmesh_scene(5)
    with open(os.path.join(SCENES, f"{name}.txt")) as f:
        return f.read()


def _jax_numpy(p) -> dict:
    d = {k: np.asarray(getattr(p, k)) for k in (
        "translations", "rotations", "scales", "cam_position", "cam_view", "cam_up",
        "cam_fov", "cam_aperture", "cam_focal")}
    d["materials"] = {k: np.asarray(getattr(p.materials, k)) for k in MATERIAL_FIELDS}
    d["mesh_verts"] = [np.asarray(v) for v in p.mesh_verts]
    return d


def _flat(d: dict) -> dict:
    out = {k: v for k, v in d.items() if k not in ("materials", "mesh_verts")}
    out.update({f"materials.{k}": v for k, v in d["materials"].items()})
    out.update({f"mesh_verts.{i}": v for i, v in enumerate(d["mesh_verts"])})
    return out


# case -> scene, accel
LEAN_CASES = {"smooth_mesh": ("smooth_mesh", True), "smooth_mesh_file_order": ("smooth_mesh", False),
              "ico_20480_lbvh": ("ico_20480", True)}


@pytest.mark.parametrize("case", sorted(LEAN_CASES))
def test_lean_mesh_loss_and_grad_matches_jax(case):
    name, use_accel = LEAN_CASES[case]
    text = _scene_text(name)
    jdesc = dataclasses.replace(jax_parse_scene_text(text, name=name, scene_dir=SCENES),
                                resolution=(12, 12))
    tdesc = dataclasses.replace(parse_scene_text(text, name=name, scene_dir=SCENES),
                                resolution=(12, 12))
    jp, js = jax_params(jdesc, 0, accel=use_accel)
    _, ts = diff.params_from_description(tdesc, 0, device="cpu", accel=use_accel)
    assert ts.mesh_geom_indices == js.mesh_geom_indices
    assert (ts.mesh_accel_keys[0] is not None) == use_accel
    n = 144
    kw = dict(nee=True, max_depth=2)
    jl, jg = jax_loss_and_grad(jp, js, jnp.zeros((n, 3), jnp.float32), 1, jax.random.PRNGKey(5),
                               JaxConfig(wavefront=False, grad_fused=False, **kw))
    tp = params_from_numpy(_jax_numpy(jp), device="cpu")
    before = (mesh.nearest_launches, mesh.min_launches)
    tl, tg, rays = diff.loss_and_grad_rays(tp, ts, torch.zeros((n, 3)), 1, prng_key(5),
                                           RenderConfig(wavefront=False, **kw), device="cpu")
    assert (mesh.nearest_launches, mesh.min_launches) == before  # CPU: the plain versions
    jl, tl = float(jl), float(tl)
    want, got = _flat(_jax_numpy(jg)), _flat(params_to_numpy(tg))
    assert sorted(want) == sorted(got)
    gscale = max(float(np.abs(v).max()) for v in want.values())
    worst = {k: float(np.abs(want[k] - got[k]).max()) for k in want}
    k_worst = max(worst, key=worst.get)
    print(f"{case}: loss JAX {jl:.9g} port {tl:.9g} (rel {abs(tl - jl) / jl:.3g}); rays "
          f"{int(rays)}; worst leaf {k_worst} {worst[k_worst]:.3g} of gscale {gscale:.4g}; "
          f"vertex gradient max {float(np.abs(want['mesh_verts.0']).max()):.4g}")
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    assert float(np.abs(want["mesh_verts.0"]).max()) > 0
    for k in want:
        assert worst[k] <= 5e-4 * max(gscale, 1.0), (k, worst[k], gscale)


def _fd(loss_fn, h, params, shift):
    return (loss_fn(shift(params, h)) - loss_fn(shift(params, -h))) / (2.0 * h)


def test_mesh_gradients_match_finite_differences():
    """``tests/test_grad.py:188-260`` for the port: the mesh instance's y
    translation and a rigid +y shift of every vertex, AD against FD."""
    desc = dataclasses.replace(load_scene(os.path.join(SCENES, "mesh_demo.txt")),
                               resolution=(20, 20))
    params, static = diff.params_from_description(desc, 0, device="cpu")
    assert len(params.mesh_verts) == 1 and static.mesh_geom_indices == (1,)
    mats = params.materials
    refl, spec = mats.has_reflective.clone(), mats.specular_exponent.clone()
    refl[1], spec[1] = 0.0, 0.0  # a diffuse mesh: specular lobes add FD noise only
    params = dataclasses.replace(params, materials=dataclasses.replace(
        mats, has_reflective=refl, specular_exponent=spec))
    cfg = RenderConfig(max_depth=3, jitter=True, wavefront=False)
    key = prng_key(11)
    target = diff.render_linear(params, static, 2, key, cfg).detach()
    trans = params.translations.clone()
    trans[1, 1] += 0.15
    verts = params.mesh_verts[0].clone()
    verts[0, 0, 1] += 0.05
    params = dataclasses.replace(params, translations=trans, mesh_verts=(verts,))

    def loss_fn(p):
        return float(diff.l2_loss(p, static, target, 2, key, cfg))

    loss, grads = diff.loss_and_grad(params, static, target, 2, key, cfg, device="cpu")
    assert float(loss) > 0

    def move(p, h):
        t = p.translations.clone()
        t[1, 1] += h
        return dataclasses.replace(p, translations=t)

    def shift(p, h):
        v = p.mesh_verts[0].clone()
        v[:, :, 1] += h
        return dataclasses.replace(p, mesh_verts=(v,))

    for what, ad, fd in (("translations[1, 1]", float(grads.translations[1, 1]),
                          _fd(loss_fn, 2e-3, params, move)),
                         ("mesh_verts[0][:, :, 1] rigid shift",
                          float(grads.mesh_verts[0][:, :, 1].sum()), _fd(loss_fn, 2e-3, params,
                                                                          shift))):
        scale = max(abs(ad), abs(fd))
        print(f"{what}: AD {ad:.6g} FD {fd:.6g}")
        assert scale > 1e-7 and abs(ad - fd) <= 0.5 * scale, (what, ad, fd)


VERTEX_SCENE = """MATERIAL 0
RGB .8 .75 .7
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
SCATTER 0
ABSCOEFF 0 0 0
RSCTCOEFF 0
EMITTANCE 0

MATERIAL 1
RGB 1 1 1
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
SCATTER 0
ABSCOEFF 0 0 0
RSCTCOEFF 0
EMITTANCE 6

CAMERA
RES 20 20
FOVY 35
ITERATIONS 1
FILE out.bmp
frame 0
EYE 0 0 4
VIEW 0 0 -1
UP 0 1 0

OBJECT 0
{obj}
material 0
frame 0
TRANS 0 0 0
ROTAT 0 0 0
SCALE 2 2 2

OBJECT 1
cube
material 1
frame 0
TRANS 0 3 2
ROTAT 0 0 0
SCALE 3 .2 3
"""


def test_vertex_optimization_accel_never_stale(tmp_path):
    """``tests/test_grad.py:446`` for the port: gradient steps of 0.5 on the
    vertices of a 1,280-triangle icosphere (with an LBVH), the LBVH rebound
    to the live vertices by every ``build_scene``; every 10 steps the loss
    and vertex gradients equal those of the same vertices without the LBVH
    (kernel 9 in file order), and the vertices end far from where the LBVH's
    grouping was built.  Then a vertex moved 2 units out is hit through the
    rebound LBVH exactly where the file-order search hits it."""
    ico = load_obj_full(os.path.join(SCENES, "assets", "ico.obj")).verts
    tris = displace_mesh(ico, 0.0, 3, "sin", 1.0)
    assert len(tris) == 1280
    obj = tmp_path / "mesh.obj"
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in tris.reshape(-1, 3))
                   + "".join(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n" for i in range(len(tris))))
    desc = parse_scene_text(VERTEX_SCENE.format(obj=obj), name="vertex")
    pa, sa = diff.params_from_description(desc, 0, device="cpu", accel=True)
    _, sd = diff.params_from_description(desc, 0, device="cpu", accel=False)
    assert sa.mesh_accel_keys[0] is not None and sd.mesh_accel_keys == (None,)
    target = torch.zeros((400, 3))
    cfg = RenderConfig(wavefront=False, nee=True, max_depth=2)
    start = pa.mesh_verts[0].clone()
    p = pa
    for step in range(21):
        key = prng_key(step)
        la, ga = diff.loss_and_grad(p, sa, target, 1, key, cfg, device="cpu")
        if step % 10 == 0:
            ld, gd = diff.loss_and_grad(p, sd, target, 1, key, cfg, device="cpu")
            print(f"step {step}: loss {float(la):.7g} (without the LBVH {float(ld):.7g})")
            np.testing.assert_allclose(float(la), float(ld), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ga.mesh_verts[0].numpy(), gd.mesh_verts[0].numpy(),
                                       rtol=1e-4, atol=1e-6)
        p = dataclasses.replace(p, mesh_verts=(p.mesh_verts[0] - 0.5 * ga.mesh_verts[0],))
    drift = float((p.mesh_verts[0] - start).abs().max())
    print(f"largest vertex drift {drift:.4g}")
    assert drift > 0.05

    # one vertex far out: the rebound LBVH still finds the stretched triangle
    verts = start.clone()
    verts[7, 0] = verts[7, 0] * 5.0
    scene_a = diff.build_scene(dataclasses.replace(pa, mesh_verts=(verts,)), sa)
    scene_d = diff.build_scene(dataclasses.replace(pa, mesh_verts=(verts,)), sd)
    assert scene_a.meshes[0].accel is not None and scene_d.meshes[0].accel is None
    rng = np.random.default_rng(3)
    o = torch.from_numpy(np.tile(verts[7, 0].numpy() * 1.3, (256, 1)).astype(np.float32))
    aim = verts[7].mean(0).numpy() + rng.standard_normal((256, 3)) * 0.05
    d = torch.from_numpy(aim.astype(np.float32)) - o
    d = d / d.norm(dim=-1, keepdim=True)
    t_a, _, i_a = mesh.mesh_query(scene_a.meshes[0], o, d, with_index=True)
    t_d, _, i_d = mesh.mesh_query(scene_d.meshes[0], o, d, with_index=True)
    perm = scene_a.meshes[0].accel.scan_to_file.long()
    hit = t_d < mesh.BIG
    assert int(hit.sum()) > 100 and torch.equal(t_a < mesh.BIG, hit)
    assert torch.equal(t_a[hit], t_d[hit]) and torch.equal(perm[i_a.long()][hit], i_d.long()[hit])
    assert float(accel.refresh_accel(scene_a.meshes[0].accel, verts).root_hi.max()) >= float(
        verts[7, 0].max())
