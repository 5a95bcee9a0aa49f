"""Mesh scenes through the port's intersection, shading and render against
the JAX package, on the CPU, and the ``smooth_mesh_96`` golden.

Inputs are made with numpy from a seed (or are a scene's camera rays) and
handed to both packages; the scenes cross with
``tests/test_torch_scene.port_scene_from_jax``.  Tolerances, with reasons:

* The split route's nearest hit and occlusion with meshes
  (``ops/intersect_cuda.nearest_hit`` / ``occlusion_t``: kernels 6, 8, 9
  and 10's plain versions and the mesh merge) against JAX's
  ``intersect_scene`` / ``occlusion_t``, and ``ops/mesh.mesh_only_hit``
  against JAX's ``mesh_only_hit(with_attrs=True)``, on smooth_mesh's camera
  rays and the rays of their next bounce: hit flags, geom and material ids
  equal; ``t`` within rtol 1e-5 with a 1e-6 floor (a second-bounce ray can
  meet the mesh again a few thousandths from its origin, where float32
  rounding is a larger share: measured 7.4e-8 at t = 2.6e-3); the world
  hit point and the smooth normal
  within 1e-5 (last ulps: XLA contracts multiply-adds on the CPU), the
  object-space point within 1e-4 (``tests/test_pallas.py``'s bar).
* The in-kernel sweep's plain version (``ops/mesh_tables.mesh_sweep`` /
  ``mesh_occ``, culled per lane) against JAX's ``mesh_sweep_planes`` /
  ``mesh_occ_planes`` (culled per group of lanes) on the same rays:
  distance within rtol 1e-5 (floor 1e-6) with the miss pattern and
  material equal, the
  normal within 1e-5 and the point within 1e-4, on at least 99.9% of lanes
  (a hit a rounding below its chunk box's entry may be culled by one and
  kept by the other; measured on every lane).
* ``shade_bounce``, both routes, against JAX's split ``shade_bounce`` on
  1,024 random lanes around the mesh: ``tests/test_torch_shade.py``'s bars.
* Renders of smooth_mesh at 32x32, depth 4, 2 spp (the megakernel's plain
  version, the split route, both wavefront engines) against JAX's CPU
  ``render`` (its split XLA path): equal ray counts, at least 99.5% of
  accumulator entries within rtol = atol = 2e-4, sums within 2e-5
  relative; the shares are printed.
* The port's ``smooth_mesh_96`` (96x96, 16 spp, depth 8, NEE: the golden's
  configuration) against ``tests/golden/smooth_mesh_96.png``: mean absolute
  difference at most 0.8/255, ``tests/test_golden.py``'s mean bar; the
  largest is printed.
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
from pathtracer_tpu.ops.bounce_pallas import mesh_occ_planes, mesh_sweep_planes, read_gvals
from pathtracer_tpu.ops.bounce_pallas import pack_mesh_tables as jax_pack_mesh_tables
from pathtracer_tpu.ops.camera import generate_camera_rays as jax_camera_rays
from pathtracer_tpu.ops.intersect import intersect_scene as jax_intersect_scene
from pathtracer_tpu.ops.intersect import mesh_only_hit as jax_mesh_only_hit
from pathtracer_tpu.ops.intersect import occlusion_t as jax_occlusion_t
from pathtracer_tpu.ops.intersect_pallas import _pack_gdata
from pathtracer_tpu.render.common import camera_uniforms as jax_camera_uniforms
from pathtracer_tpu.render.common import shade_bounce as jax_shade_bounce
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.structs import Rays as JaxRays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import intersect_cuda, mesh, trace, trace_grad
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.mesh_tables import mesh_occ, mesh_sweep
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.scene.structs import Rays
from pathtracer_tpu_torch.utils.imageio import load_png
from tests.test_torch_scene import port_scene_from_jax
from tests.test_torch_shade import _compare_bounce, random_lanes

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOOTH = os.path.join(ROOT, "scenes", "smooth_mesh.txt")


@pytest.fixture(scope="module")
def smooth():
    """smooth_mesh at 32x32 in both packages, JAX's camera rays of it and the
    rays of their next bounce (from JAX's split shade_bounce)."""
    jscene = dataclasses.replace(jax_load_scene(SMOOTH), resolution=(32, 32)).scene_for_frame(0)
    n = 32 * 32
    key = jax.random.PRNGKey(3)
    pix = jnp.arange(n, dtype=jnp.int32)
    primary = jax_camera_rays(jscene.camera, pix, None, jitter=True,
                              per_ray_uniforms=jax_camera_uniforms(key, pix, True))
    res = jax_shade_bounce(jscene, primary, jnp.ones((n, 3)), pix, 0, jnp.zeros(n), key,
                           JaxConfig(pallas=False, fused=False, features=("glossy",)),
                           medium_sigma=jnp.zeros((n, 4)))
    second = JaxRays(origin=res.next_origin, direction=res.next_direction)
    return jscene, port_scene_from_jax(jscene), {"primary": primary, "second": second}


def _port_rays(r):
    return Rays(origin=torch.from_numpy(np.array(r.origin)),
                direction=torch.from_numpy(np.array(r.direction)))


@pytest.mark.parametrize("which", ["primary", "second"])
def test_split_route_intersection_matches_jax(smooth, which):
    jscene, tscene, rays = smooth
    jr, tr = rays[which], _port_rays(rays[which])
    want = jax_intersect_scene(jr, jscene.geoms, jscene.meshes)
    want_occ = np.asarray(jax_occlusion_t(jr, jscene.geoms, jscene.meshes))
    gtab = pack_tables(tscene)[0]
    before = (mesh.nearest_launches, mesh.min_launches)
    got = intersect_cuda.nearest_hit(tr, gtab, tscene.meshes)
    got_occ = intersect_cuda.occlusion_t(tr, gtab, tscene.meshes).numpy()
    assert (mesh.nearest_launches, mesh.min_launches) == before  # CPU: plain versions
    on_mesh = got.geom_id.numpy() == 1
    print(f"{which}: {int(got.hit.sum())} hits, {int(on_mesh.sum())} on the mesh")
    assert on_mesh.sum() > 50
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.geom_id.numpy()[hit], np.asarray(want.geom_id)[hit])
    np.testing.assert_array_equal(got.material_id.numpy()[hit], np.asarray(want.material_id)[hit])
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=1e-6)
    for f, tol in (("position", 1e-5), ("position_obj", 1e-4), ("normal", 1e-5)):
        np.testing.assert_allclose(getattr(got, f).numpy()[hit], np.asarray(getattr(want, f))[hit],
                                   rtol=tol, atol=tol, err_msg=f)
    np.testing.assert_allclose(got_occ, want_occ, rtol=1e-5, atol=1e-6)
    # the mesh winner alone, with the authored smooth normal
    jt, jpo, jn, jmid, jgid, _, _ = jax_mesh_only_hit(jr, jscene.geoms, jscene.meshes,
                                                      with_attrs=True)
    mt, mpo, mn, mmid, mgid, _, _ = mesh.mesh_only_hit(tr, gtab, tscene.meshes)
    mhit = np.asarray(jt) < 1e29
    np.testing.assert_array_equal(mt.numpy() < 1e29, mhit)
    np.testing.assert_allclose(mt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(mmid.numpy(), np.asarray(jmid))
    np.testing.assert_array_equal(mgid.numpy(), np.asarray(jgid))
    np.testing.assert_allclose(mn.numpy()[mhit], np.asarray(jn)[mhit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mpo.numpy()[mhit], np.asarray(jpo)[mhit], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("which", ["primary", "second"])
def test_in_kernel_sweep_plain_matches_jax(smooth, which):
    jscene, tscene, rays = smooth
    jr, tr = rays[which], _port_rays(rays[which])
    descs, tabs = jax_pack_mesh_tables(jscene.meshes)
    gvals = read_gvals(_pack_gdata(jscene.geoms), jscene.geoms.count)
    o = tuple(jr.origin[:, i] for i in range(3))
    d = tuple(jr.direction[:, i] for i in range(3))
    want = mesh_sweep_planes(descs, tabs, gvals, o, d, 1e-4, False)
    want_occ = np.asarray(mesh_occ_planes(descs, tabs, gvals, o, d, 1e-4))
    gtab = pack_tables(tscene)[0]
    o_t, d_t = tr.origin.unbind(-1), tr.direction.unbind(-1)
    got = mesh_sweep(tscene.mesh_tables, gtab, o_t, d_t)
    got_occ = mesh_occ(tscene.mesh_tables, gtab, o_t, d_t).numpy()
    et, jet = got["et"].numpy(), np.asarray(want["et"])
    hit = jet < 1e29
    assert hit.sum() > 50
    reached = got["reached"].numpy()  # a lane hits only inside a chunk it reached
    assert (reached[hit] >= 1).all() and (reached <= tscene.mesh_tables.aabb.numel() // 6).all()
    ok =((et < 1e29) == hit) & np.isclose(et, jet, rtol=1e-5, atol=1e-6)
    ok &= got["emid"].numpy() == np.asarray(want["emid"])
    for k, tol in (("en", 1e-5), ("epo", 1e-4)):
        g = np.stack([c.numpy() for c in got[k]], -1)
        w = np.stack([np.asarray(c) for c in want[k]], -1)
        ok &= ~hit | np.isclose(g, w, rtol=tol, atol=tol).all(-1)
    ok &= np.isclose(got_occ, want_occ, rtol=1e-5, atol=1e-6)
    print(f"{which}: {hit.sum()} mesh hits; lanes within the bars {ok.mean():.6f}")
    assert ok.mean() >= 0.999


@pytest.mark.parametrize("nee", [True, False])
def test_shade_bounce_with_meshes_matches_jax_split(smooth, nee):
    jscene, tscene, _ = smooth
    n = 1024
    lanes = random_lanes(n, seed=13)
    lanes["origin"] = (lanes["origin"] * 0.7 + np.array([0.0, 1.8, 0.0])).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jrays = JaxRays(origin=jnp.asarray(lanes["origin"]), direction=jnp.asarray(lanes["direction"]))
    ref = jax_shade_bounce(
        jscene, jrays, jnp.asarray(lanes["throughput"]), jnp.asarray(lanes["sample"]),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]), key,
        JaxConfig(nee=nee, pallas=False, fused=False, features=("glossy",)),
        medium_sigma=jnp.zeros((n, 4), jnp.float32),
    )
    rays = Rays(origin=torch.from_numpy(lanes["origin"]),
                direction=torch.from_numpy(lanes["direction"]))
    args = (tscene, rays, torch.from_numpy(lanes["throughput"]),
            torch.from_numpy(lanes["sample"]).long(), torch.from_numpy(lanes["depth"]),
            torch.from_numpy(lanes["prev"]), key_to_seed(prng_key(7)))
    for fused in (None, False):
        cfg = RenderConfig(nee=nee, fused=fused, features=("glossy",))
        _compare_bounce(ref, shade_bounce(*args, cfg), f"fused={fused}, nee={nee}")
    # the lean route (a mesh winner shades with its face normal, as JAX's)
    lean = jax_shade_bounce(
        jscene, jrays, jnp.asarray(lanes["throughput"]), jnp.asarray(lanes["sample"]),
        jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"]), key,
        JaxConfig(nee=nee, pallas=False, fused=False, grad_lean=True, features=("glossy",)),
        medium_sigma=jnp.zeros((n, 4), jnp.float32),
    )
    _compare_bounce(lean, shade_bounce(*args, RenderConfig(nee=nee, features=("glossy",),
                                                           grad_lean=True)),
                    f"grad_lean, nee={nee}")


@pytest.mark.parametrize("grad", [dict(), dict(grad_full_trace=True),
                                  dict(grad_full_trace=False), dict(grad_fused=False)])
def test_differentiable_engines_refuse_meshes(smooth, grad):
    """A mesh scene takes the lean engine whatever the gradient options say
    (the name is from when every engine refused meshes): none of them is in
    the fused scope, as in JAX, so each gives the lean engine's loss and
    gradients bit for bit, and ``render`` under ``grad_lean`` runs the lean
    scan."""
    _, tscene, _ = smooth
    cfg = RenderConfig(grad_lean=True, max_depth=2, features=("glossy",), **grad)
    assert not trace_grad.fused_diff_eligible(tscene, cfg)
    _, acc, st = render(tscene, 1, cfg, device="cpu")
    assert bool(torch.isfinite(acc).all()) and st["rays_traced"] > 0
    desc = dataclasses.replace(load_scene(SMOOTH), resolution=(8, 8))
    params, static = diff.params_from_description(desc, 0, device="cpu")
    target = torch.zeros((64, 3))
    loss, grads = diff.loss_and_grad(params, static, target, 1, prng_key(2),
                                     RenderConfig(max_depth=2, **grad), device="cpu")
    lean_loss, lean = diff.loss_and_grad(params, static, target, 1, prng_key(2),
                                         RenderConfig(max_depth=2, grad_fused=False),
                                         device="cpu")
    assert float(loss) == float(lean_loss) > 0
    for k, v in grads.leaves().items():
        assert torch.equal(v, lean.leaves()[k]), k
    assert float(grads.mesh_verts[0].abs().max()) > 0


def test_renders_match_jax(smooth):
    jscene, tscene, _ = smooth
    _, jacc, jst = jax_render(jscene, 2, JaxConfig(wavefront=False, nee=True, max_depth=4,
                                                  iters_per_launch=2))
    jacc = np.asarray(jacc)
    base = dict(nee=True, max_depth=4, iters_per_launch=2)
    for name, cfg in (("megakernel", RenderConfig(**base)),
                      ("split route", RenderConfig(fused=False, **base)),
                      ("pinned wavefront", RenderConfig(wavefront=True, **base)),
                      ("queue wavefront", RenderConfig(wavefront=True, wavefront_pinned=False,
                                                       **base))):
        before = (trace.launches, trace.mesh_launches)
        _, acc, st = render(tscene, 2, cfg, device="cpu")
        assert (trace.launches, trace.mesh_launches) == before  # CPU: the plain versions
        acc = acc.numpy()
        share = np.isclose(acc, jacc, rtol=2e-4, atol=2e-4).mean()
        sum_rel = abs(float(acc.sum()) - float(jacc.sum())) / float(jacc.sum())
        print(f"{name}: {share:.5f} of entries within 2e-4, sums within {sum_rel:.3g}")
        assert st["rays_traced"] == int(jst["rays_traced"])
        assert share >= 0.995 and sum_rel <= 2e-5


def test_smooth_mesh_96_golden():
    desc = dataclasses.replace(load_scene(SMOOTH), resolution=(96, 96))
    img, _, _ = render(desc.scene_for_frame(0, device="cpu"), 16,
                       RenderConfig(nee=True, max_depth=8, iters_per_launch=8), device="cpu")
    golden = load_png(os.path.join(ROOT, "tests", "golden", "smooth_mesh_96.png"))
    diff = np.abs(img.numpy() - golden.astype(np.float32) / 255.0)
    print(f"smooth_mesh_96: mean abs {diff.mean() * 255:.4f}/255, max {diff.max() * 255:.4f}/255")
    assert diff.mean() <= 0.8 / 255
