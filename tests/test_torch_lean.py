"""The lean differentiable engine of the PyTorch port vs the JAX package, on
the CPU.

On CPU tensors the port runs the plain versions of its kernels: kernel 7's
winner search (``ops/intersect.winner_t_gid_plain``), kernel 8's shadow ray
and kernel 1's forward trace; their lanes are held to the kernels' in
``tests/test_torch_kernel_host.py``.  The JAX side runs as its own CPU
tests run it: ``winner_t_gid_planes`` in interpret mode,
``intersect_scene_lean`` and ``loss_and_grad(grad_fused=False)`` on XLA.
Inputs are made with numpy from a seed.

Tolerances, with the reason:

* ``winner_t_gid_plain`` against ``winner_t_gid_planes(interpret=True)``
  on 2,048 random lanes: geom ids equal on every lane; t within 1e-6
  relative on at least 99.5% of lanes and within 1e-4 on every lane.  XLA's
  CPU sweep fuses multiply-adds that torch rounds one by one; where t is
  ill-conditioned the last ulps grow: measured, 8 Cornell lanes past 1e-6
  (worst 8.1e-5), six of them spheres hit at t below 0.05 from just outside
  (the quadratic's -b - sqrt(disc) cancels), and one MINI_SCENE lane
  (2.5e-6).  Ties (two geoms' t within 1e-6) are counted and printed under
  ``pytest -s``: none on these lanes;
* ``intersect_scene_lean`` against JAX's and ``jax.vjp``: hit flags, geom
  and material ids equal; t, the world point and the normal within 1e-5,
  the object-space point within 1e-4 (``tests/test_torch_shade.py``'s bars
  for the nearest hit, whose values these are); the cotangents of the
  origin, direction and inverse transforms within 1e-4 relative with a
  floor of 1e-5 of each tensor's largest (a gather where JAX multiplies by
  a one-hot matrix, so the table sums run in another order).  Measured:
  worst 1.9e-4 on a d_direction component of 731 and 2.7e-4 on an
  inverse-transform entry of 190 (printed under ``pytest -s``);
* ``loss_and_grad(grad_fused=False)`` against JAX's lean
  ``loss_and_grad`` on ``tests/test_torch_diff.py``'s two CASES: the loss
  within 1e-5 relative, every leaf within 5e-4 * max(gscale, 1), the bar
  JAX holds between its own engines (``tests/test_bounce_grad.py:169-176``).
  The port's forward is the forward with residuals' plain version (kernel
  4's), its backward the lean scan replaying the forward's winners, NEE
  bits and rays; JAX runs the lean graph both ways on the CPU.
* the lean backward re-runs no detached search: the winner search runs
  once per bounce and sample, exactly, the shadow ray not at all (its bit
  is replayed), while the shading runs twice (forward and checkpoint
  recompute).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops.intersect import intersect_scene_lean as jax_intersect_scene_lean
from pathtracer_tpu.ops.intersect_pallas import winner_t_gid_planes
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu.scene.structs import Rays as JaxRays
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import intersect_cuda, trace, trace_grad
from pathtracer_tpu_torch.ops.intersect import (
    T_MIN,
    geom_t,
    intersect_scene_lean,
    pack_geom_table,
    winner_t_gid_plain,
)
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render import diff, megakernel
from pathtracer_tpu_torch.scene.parser import parse_scene_text
from pathtracer_tpu_torch.scene.structs import Rays
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_bounce_grad import CORNELL, _check_loss_and_grad, jax_losses  # noqa: F401
from tests.test_torch_diff import CASES
from tests.test_torch_scene import port_scene_from_jax
from tests.test_torch_shade import random_lanes


def _jax_scene(name):
    if name == "mini":
        return jax_parse(MINI_SCENE, name="mini").scene_for_frame(0)
    return jax_load_scene(CORNELL).scene_for_frame(0)


@pytest.mark.parametrize("name", ["cornell", "mini"])
def test_winner_plain_matches_jax_kernel(name):
    jscene = _jax_scene(name)
    lanes = random_lanes(2048, seed=12)
    jrays = JaxRays(origin=jnp.asarray(lanes["origin"]), direction=jnp.asarray(lanes["direction"]))
    want_t, want_gid = (np.asarray(x) for x in winner_t_gid_planes(jrays, jscene.geoms,
                                                                    interpret=True))
    gtab = pack_geom_table(port_scene_from_jax(jscene).geoms)
    rays = Rays(torch.from_numpy(lanes["origin"]), torch.from_numpy(lanes["direction"]))
    t, gid = winner_t_gid_plain(rays, gtab)
    assert t.dtype == torch.float32 and gid.dtype == torch.int32
    # the dispatch takes the plain version for CPU tensors, without a launch
    before = intersect_cuda.winner_launches
    via = intersect_cuda.winner_t_gid(rays, gtab)
    assert intersect_cuda.winner_launches == before
    assert torch.equal(via[0], t) and torch.equal(via[1], gid)

    hit = want_t < 1e30
    assert 0.2 < hit.mean() < 1.0
    # lanes whose two nearest geoms are within 1e-6 relative: a tie could
    # go either way between two sweeps
    o, d = rays.origin.unbind(-1), rays.direction.unbind(-1)
    ts = torch.stack([geom_t(row, *o, *d, T_MIN, row[12].item())[0] for row in gtab])
    top2 = ts.topk(2, dim=0, largest=False).values
    ties = int(((top2[1] - top2[0]) <= 1e-6 * top2[0]).logical_and(top2[0] < 1e30).sum())
    print(f"{name}: {int(hit.sum())} hits of {hit.size}, {ties} ties within 1e-6")
    np.testing.assert_array_equal(gid.numpy(), want_gid)
    rel = np.abs(t.numpy() - want_t) / np.abs(want_t)
    print(f"{name}: t within 1e-6 relative on {float((rel <= 1e-6).mean()):.5f} of lanes, "
          f"worst {rel.max():.3g}")
    assert (rel <= 1e-6).mean() >= 0.995 and (rel <= 1e-4).all()
    assert ties == 0


@pytest.mark.parametrize("name", ["cornell", "mini"])
def test_intersect_scene_lean_matches_jax(name):
    jscene = _jax_scene(name)
    n = 1024
    lanes = random_lanes(n, seed=13)
    r = np.random.default_rng(14)
    cots = {k: r.standard_normal((n, 3)).astype(np.float32)
            for k in ("position", "position_obj", "normal")}
    cot_t = r.standard_normal(n).astype(np.float32)
    geoms = jscene.geoms

    def f(origin, direction, inv):
        hit = jax_intersect_scene_lean(JaxRays(origin, direction),
                                       dataclasses.replace(geoms, inv_transform=inv))
        return hit.t, hit.position, hit.position_obj, hit.normal, hit

    want_hit = f(jnp.asarray(lanes["origin"]), jnp.asarray(lanes["direction"]),
                 geoms.inv_transform)[4]
    _, vjp = jax.vjp(lambda *a: f(*a)[:4], jnp.asarray(lanes["origin"]),
                     jnp.asarray(lanes["direction"]), geoms.inv_transform)
    hit_t = np.asarray(want_hit.hit)
    # miss lanes carry a BIG t: their cotangent would swamp float32 sums
    want = vjp((jnp.asarray(np.where(hit_t, cot_t, 0.0).astype(np.float32)),
                *(jnp.asarray(cots[k]) for k in ("position", "position_obj", "normal"))))

    tgeoms = port_scene_from_jax(jscene).geoms
    inv = tgeoms.inv_transform.clone().requires_grad_()
    o = torch.from_numpy(lanes["origin"]).requires_grad_()
    d = torch.from_numpy(lanes["direction"]).requires_grad_()
    gtab = pack_geom_table(dataclasses.replace(tgeoms, inv_transform=inv))
    got = intersect_scene_lean(Rays(o, d), gtab)
    np.testing.assert_array_equal(got.hit.numpy(), hit_t)
    assert 0.2 < hit_t.mean() < 1.0
    np.testing.assert_array_equal(got.geom_id.numpy(), np.asarray(want_hit.geom_id))
    np.testing.assert_array_equal(got.material_id.numpy(), np.asarray(want_hit.material_id))
    np.testing.assert_allclose(got.t.detach().numpy(), np.asarray(want_hit.t), rtol=1e-5, atol=0)
    for f_, tol in (("position", 1e-5), ("position_obj", 1e-4), ("normal", 1e-5)):
        np.testing.assert_allclose(getattr(got, f_).detach().numpy(),
                                   np.asarray(getattr(want_hit, f_)), rtol=tol, atol=tol,
                                   err_msg=f_)

    outs = [got.t, got.position, got.position_obj, got.normal]
    grads = torch.autograd.grad(
        outs, [o, d, inv],
        [torch.from_numpy(np.where(hit_t, cot_t, 0.0).astype(np.float32)),
         *(torch.from_numpy(cots[k]) for k in ("position", "position_obj", "normal"))])
    for label, g, w in zip(("d_origin", "d_direction", "d_inv_transform"), grads, want):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        scale = float(np.abs(w).max())
        err = np.abs(g - w)
        print(f"{name} {label}: worst {err.max():.3g} of max {scale:.4g}, worst relative "
              f"{float((err / (np.abs(w) + 1e-5 * scale)).max()):.3g}")
        assert np.isfinite(g).all()
        assert (err <= 1e-4 * np.abs(w) + 1e-5 * scale).all(), label


@pytest.mark.parametrize("case", sorted(CASES))
def test_lean_loss_and_grad_matches_jax(case, jax_losses):  # noqa: F811
    want_loss, want, tp, ts, target, spp, seed, kw = jax_losses[case]
    cfg = RenderConfig(wavefront=False, grad_fused=False, **kw)
    counts = (trace.launches, trace_grad.fwd_launches, trace_grad.bwd_launches,
              intersect_cuda.winner_launches, intersect_cuda.occlusion_launches)
    loss, grads, rays = diff.loss_and_grad_rays(tp, ts, target, spp, prng_key(seed), cfg,
                                                device="cpu")
    assert counts == (trace.launches, trace_grad.fwd_launches, trace_grad.bwd_launches,
                      intersect_cuda.winner_launches, intersect_cuda.occlusion_launches)
    assert rays.dtype == torch.int64 and int(rays) >= spp * target.shape[0]
    _check_loss_and_grad(case, want_loss, want, float(loss), grads)


def test_lean_backward_reruns_no_sweep(monkeypatch):
    """One lean gradient step at depth 3, 2 spp, NEE: the winner search
    runs 6 times (once per bounce and sample: the checkpoint recompute
    takes its kept output), the shading 12 times (forward and recompute),
    the forward is the forward with residuals' plain version (the scene is
    in the fused scope), and no shadow ray runs: the re-trace replays the
    forward's NEE bits."""
    calls = {"winner": 0, "occlusion": 0, "shade": 0, "trace": 0, "forward": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(intersect_cuda, "winner_t_gid_plain",
                        counting("winner", intersect_cuda.winner_t_gid_plain))
    monkeypatch.setattr(intersect_cuda, "occlusion_t_plain",
                        counting("occlusion", intersect_cuda.occlusion_t_plain))
    monkeypatch.setattr(megakernel, "shade_bounce", counting("shade", megakernel.shade_bounce))
    monkeypatch.setattr(trace, "trace_plain", counting("trace", trace.trace_plain))
    monkeypatch.setattr(trace_grad, "tfwd_plain", counting("forward", trace_grad.tfwd_plain))
    desc = dataclasses.replace(parse_scene_text(MINI_SCENE, name="mini"), resolution=(12, 10))
    params, static = diff.params_from_description(desc, 0, device="cpu")
    cfg = RenderConfig(max_depth=3, nee=True, grad_fused=False)
    loss, grads = diff.loss_and_grad(params, static, torch.zeros(120, 3), 2, prng_key(1), cfg,
                                     device="cpu")
    assert calls == {"winner": 6, "occlusion": 0, "shade": 12, "trace": 0, "forward": 2}, calls
    assert float(loss) > 0
    leaves = grads.leaves()
    assert all(bool(torch.isfinite(v).all()) for v in leaves.values())
    assert float(leaves["translations"].abs().max()) > 0
