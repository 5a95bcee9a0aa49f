"""The lean engine's replay of its forward's paths, on the CPU.

On a scene of the fused scope the lean engine's forward is the forward with
residuals (``ops/trace_grad.trace_replay``: kernel 4 on the card, its plain
version here), which keeps each bounce's winner geom, surface NEE bit and
entering ray; its backward re-traces the lean scan (``render/common.
shade_bounce`` on the lean split route) replaying them, so it
differentiates the paths the forward counted at the forward's values
(``render/diff.LeanSample``).  Inputs are made from seeds.

Tolerances, with the reason:

* a replay changed on one lane (its bounce-0 winner moved to a geom behind
  the one its own search takes, and a NEE bit flipped) is followed: the
  lean gradient equals ``torch.autograd.grad`` of the lean scan run
  directly with that forced replay, at the forward's cotangent, within
  1e-6 of each leaf's largest entry (the same operations; the checkpoint's
  recompute is exact), and differs from the unforced gradient;
* with the replay untouched, the lean loss equals the unreplayed lean
  engine's (its forward is the trace's plain version, its re-trace runs its
  own searches) and every leaf is within 1e-6 of the leaf's largest entry
  (the replayed rays are the forward's values, the unreplayed re-trace's
  its own: they differ in the last bits),
  over the pixels where neither re-trace parts from its forward (the count
  is printed: none on these scenes); and on MINI_SCENE the replaying lean
  engine meets JAX's lean ``loss_and_grad`` at the bars of
  ``tests/test_torch_lean.py::test_lean_loss_and_grad_matches_jax`` (the
  loss within 1e-5 relative, every leaf within 5e-4 * max(gscale, 1));
* the lean step against the full-depth step on ward and milky at 24x24,
  with no pixel mask: the losses equal (one forward), every leaf within
  5e-4 of that leaf's largest full-depth entry (of the largest gradient,
  for a leaf the full-depth step gives none), the bar ``chip_smoke.py``
  ``[grad:surf]`` holds on the card.
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
from pathtracer_tpu_torch.ops.intersect import BIG, geom_t
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.render.integrator import camera_sample, render_sample
from pathtracer_tpu_torch.scene.convert import params_from_numpy
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_bounce_grad import _check_loss_and_grad, _flat, _jax_params_numpy
from tests.test_torch_surface_diff import WARD_MINI

ROOT = os.path.join(os.path.dirname(__file__), "..")
RES = (24, 24)
LEAN = dict(wavefront=False, nee=True, grad_fused=False)


def _mini(text, name, depth=3):
    desc = dataclasses.replace(parse_scene_text(text, name=name), resolution=RES)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    return params, static, RenderConfig(max_depth=depth, **LEAN)


def _grads(params, static, cfg, spp, seed, weight=None, target=None):
    """``(loss, {leaf: gradient})`` of the mean squared error against
    ``target`` (zeros by default) over the pixels ``weight`` keeps (all by
    default), through ``render_linear`` as ``loss_and_grad`` runs it."""
    names, values = zip(*params.leaves().items())
    leaves = [v.detach().requires_grad_(True) for v in values]
    p = diff.SceneParams.from_leaves(dict(zip(names, leaves)))
    n = static.resolution[0] * static.resolution[1]
    weight = torch.ones(n) if weight is None else weight
    target = torch.zeros((n, 3)) if target is None else target
    with torch.enable_grad():
        img = diff.render_linear(p, static, spp, prng_key(seed), cfg)
        loss = torch.mean(weight[:, None] * (img - target) ** 2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(x) if g is None else g
                                  for k, g, x in zip(names, grads, leaves)}


def _within(got, want, rel):
    """Each leaf's worst |got - want| over ``rel`` of its largest |want|
    entry (of the largest gradient, for a leaf ``want`` gives none)."""
    gscale = max(float(v.abs().max()) for v in want.values())
    return {k: float((got[k] - w).abs().max()) / (rel * (float(w.abs().max()) or gscale))
            for k, w in want.items()}


def _forced_lane(scene, cfg_fwd, seed):
    """A lane of iteration 0 whose primary ray hits a geom and also crosses
    another farther on, and the index of that other geom."""
    pix = torch.arange(RES[0] * RES[1])
    rays, _ = camera_sample(scene, pix, 0, seed, cfg_fwd)
    gtab = diff.pack_tables(scene)[0].detach()
    o, d = rays.origin.unbind(-1), rays.direction.unbind(-1)
    types = gtab[:, 12].tolist()
    t = torch.stack([geom_t(gtab[g], *o, *d, 1e-4, types[g])[0] for g in range(len(types))])
    near = torch.argmin(t, dim=0)
    crossed = (t < BIG).sum(0)
    lane = int(torch.nonzero(crossed >= 2)[len(torch.nonzero(crossed >= 2)) // 2, 0])
    t_lane = t[:, lane].clone()
    t_lane[near[lane]] = BIG
    return lane, int(near[lane]), int(torch.argmin(t_lane))


def test_retrace_follows_the_replay(monkeypatch):
    params, static, cfg = _mini(WARD_MINI, "ward_mini")
    cfg_fwd, cfg_bwd = diff.lean_cfgs(cfg, params.materials)
    scene = diff.build_scene(params, static)
    seed = key_to_seed(prng_key(3))
    lane, own, other = _forced_lane(scene, cfg_fwd, seed)
    pix = torch.arange(RES[0] * RES[1])
    fwd, _, (gid, nee, ray) = diff.lean_forward(scene, pix, 0, seed, cfg_fwd)
    assert int(gid[0, lane]) == own != other
    bounce = int(torch.nonzero(gid[1:, lane] >= 0)[-1, 0]) + 1  # a later bounce it lives
    forced = (gid.clone(), nee.clone(), ray)
    forced[0][0, lane] = other  # a winner behind the one its search takes
    forced[1][bounce, lane] = not bool(nee[bounce, lane])  # the NEE bit flipped
    print(f"lane {lane}: bounce 0 winner {own} replayed as {other}, bounce {bounce} NEE "
          f"{bool(nee[bounce, lane])} replayed as {bool(forced[1][bounce, lane])}")

    target = torch.full((RES[0] * RES[1], 3), 0.25)  # a cotangent on every lane
    real_forward = diff.lean_forward
    monkeypatch.setattr(diff, "lean_forward", lambda *a, **k: (*real_forward(*a, **k)[:2],
                                                               forced))
    _, lean = _grads(params, static, cfg, 1, 3, target=target)
    monkeypatch.setattr(diff, "lean_forward", real_forward)
    _, unforced = _grads(params, static, cfg, 1, 3, target=target)

    # the reference: the lean scan with the forced path, differentiated
    # directly at the forward's cotangent
    names, values = zip(*params.leaves().items())
    leaves = [v.detach().requires_grad_(True) for v in values]
    with torch.enable_grad():
        sc = diff.build_scene(diff.SceneParams.from_leaves(dict(zip(names, leaves))), static)
        img, _ = render_sample(sc, pix, 0, seed, cfg_bwd, replay=forced)
        g_img = 2.0 * (fwd - target) / fwd.numel()
        ref = dict(zip(names, torch.autograd.grad(img, leaves, g_img, allow_unused=True)))
        with torch.no_grad():
            own_img, _ = render_sample(sc, pix, 0, seed, cfg_bwd, replay=(gid, nee, ray))
    ref = {k: torch.zeros_like(lean[k]) if g is None else g for k, g in ref.items()}
    assert not torch.allclose(img[lane], own_img[lane])  # the forced path is another path
    err = _within(lean, ref, 1e-6)
    moved = _within(unforced, ref, 1e-6)
    print(f"forced lean against the forced re-trace: worst {max(err.values()):.3g} of 1e-6 "
          f"bars; the unforced gradient moves {max(moved, key=moved.get)} by "
          f"{max(moved.values()):.3g} of its bar")
    assert max(err.values()) <= 1.0
    assert max(moved.values()) > 1.0


@pytest.mark.parametrize("name", ["mini", "ward_mini"])
def test_untouched_replay_matches_the_unreplayed_lean_engine(monkeypatch, name):
    params, static, cfg = _mini(MINI_SCENE if name == "mini" else WARD_MINI, name)
    spp, seed = 2, 5
    parted = torch.zeros(RES[0] * RES[1], dtype=torch.bool)
    for it in range(spp):
        parted |= diff.lean_parted(params, static, it, prng_key(seed), cfg)[0]
    monkeypatch.setattr(diff, "replay_scope", lambda *a: False)
    for it in range(spp):
        parted |= diff.lean_parted(params, static, it, prng_key(seed), cfg)[0]
    weight = (~parted).float()
    loss_old, old = _grads(params, static, cfg, spp, seed, weight)
    monkeypatch.undo()
    loss_new, new = _grads(params, static, cfg, spp, seed, weight)
    err = _within(new, old, 1e-6)
    print(f"{name}: {int(parted.sum())} pixels part; loss {loss_new:.9g} vs {loss_old:.9g}; "
          f"worst leaf {max(err, key=err.get)} at {max(err.values()):.3g} of its 1e-6 bar")
    assert loss_new == loss_old
    assert max(err.values()) <= 1.0


def test_untouched_replay_matches_jax():
    jdesc = dataclasses.replace(jax_parse(MINI_SCENE, name="mini"), resolution=RES)
    jp, js = jax_params(jdesc, 0)
    n, spp, seed, kw = RES[0] * RES[1], 1, 7, dict(nee=True, max_depth=3)
    jl, jg = jax_loss_and_grad(jp, js, jnp.full((n, 3), 0.25, jnp.float32), spp,
                               jax.random.PRNGKey(seed),
                               JaxConfig(wavefront=False, grad_fused=False, **kw))
    tp = params_from_numpy(_jax_params_numpy(jp), device="cpu")
    ts = diff.SceneStatic(js.geom_type, js.geom_material, js.resolution)
    loss, grads = diff.loss_and_grad(tp, ts, torch.full((n, 3), 0.25), spp, prng_key(seed),
                                     RenderConfig(max_depth=3, **LEAN), device="cpu")
    _check_loss_and_grad("mini 24x24", float(jl), _flat(_jax_params_numpy(jg)), float(loss),
                         grads)


@pytest.mark.parametrize("name", ["ward", "milky"])
def test_lean_matches_full_depth_without_a_mask(name):
    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", f"{name}.txt")),
                               resolution=RES)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    cfg = RenderConfig(max_depth=4, wavefront=False, nee=True)
    loss_full, full = _grads(params, static, cfg, 2, 0)
    loss_lean, lean = _grads(params, static, dataclasses.replace(cfg, grad_fused=False), 2, 0)
    err = _within(lean, full, 5e-4)
    worst = max(err, key=err.get)
    print(f"{name}: loss lean {loss_lean:.9g} full-depth {loss_full:.9g}; worst leaf {worst} "
          f"at {err[worst]:.3g} of its bar")
    assert loss_lean == loss_full
    assert all(bool(torch.isfinite(v).all()) for v in lean.values())
    assert err[worst] <= 1.0
