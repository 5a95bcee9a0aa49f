"""The per-bounce differentiable engine of the PyTorch port vs the JAX
package, on the CPU.

On CPU tensors the port runs the plain versions of kernel 2's replay
variant (``ops/bounce_fused.bounce_fused_plain(emit_replay=True)``) and of
kernel 3 (``ops/bounce_grad.bounce_bwd_plain``); their lanes are held to
the kernels' in ``tests/test_torch_kernel_host.py``.  The JAX side runs as
its own CPU tests run it: ``bounce_physics`` called eagerly, and
``loss_and_grad`` on its lean XLA backward (``grad_fused=False``, equal to
kernel 3's a.e.), never the interpret-mode kernel 3.  Inputs are made with
numpy from a seed.

Tolerances, with the reason:

* replay planes (winner geom, NEE bit) against JAX's
  ``bounce_physics(emit_replay=True)``: equal on every lane, misses and
  light hits included (both are comparisons of the same float32 values);
* ``bounce_bwd_plain`` against ``jax.vjp`` of JAX's
  ``bounce_physics(replay=...)`` on 512 random lanes with random
  cotangents on every lane (the mask-free contract): every component of
  d_origin / d_direction / d_throughput within rtol = atol = 1e-5 on every
  lane, each table cotangent within 1e-5 of the largest magnitude of its
  table (the same float32 formulas; XLA's CPU rsqrt and libm round the
  last ulps differently, and the table sums run in another order).
  Measured: worst 1.5e-5 on a d_direction component of 204, tables within
  2.1e-7 of their largest (printed under ``pytest -s``);
* ``loss_and_grad(grad_full_trace=False)`` against JAX's lean
  ``loss_and_grad`` on ``tests/test_torch_diff.py``'s two CASES: the loss
  within 1e-5 relative, every leaf within 5e-4 * max(gscale, 1), the bar
  JAX holds between its own engines (``tests/test_bounce_grad.py:169-176``);
  and against the port's full-depth engine at the same bars.  Measured:
  the loss within 7.5e-8 of JAX's and equal to the full-depth engine's,
  every leaf within 3.3e-5 of gscale against JAX and 2.7e-5 against the
  full-depth engine (float32 autograd sums the same terms in another
  order).
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
from pathtracer_tpu.ops.intersect_pallas import _pack_gdata
from pathtracer_tpu.ops.rng import hash_uniforms as jax_hash_uniforms
from pathtracer_tpu.render.diff import loss_and_grad as jax_loss_and_grad
from pathtracer_tpu.render.diff import params_from_description as jax_params
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce_fused, bounce_grad, trace_grad
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.intersect import T_MIN
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_bounce import _jax_values
from tests.test_torch_diff import CASES, _flat, _jax_params_numpy
from tests.test_torch_scene import port_scene_from_jax
from tests.test_torch_shade import random_lanes

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "scenes", "cornell.txt")
N, SEED = 512, 99


@pytest.fixture(scope="module")
def jax_losses():
    """JAX's lean ``loss_and_grad`` on each case, computed once:
    ``{case: (loss, flat grads, port params, static, target, port kwargs)}``."""
    cornell = jax_load_scene(CORNELL)
    out = {}
    for case, (name, res, spp, seed, target_val, kw) in CASES.items():
        jdesc = jax_parse(MINI_SCENE, name="mini") if name == "mini" else cornell
        if res is not None:
            jdesc = dataclasses.replace(jdesc, resolution=res)
        jp, js = jax_params(jdesc, 0)
        n = js.resolution[0] * js.resolution[1]
        jl, jg = jax_loss_and_grad(jp, js, jnp.full((n, 3), target_val, jnp.float32), spp,
                                   jax.random.PRNGKey(seed),
                                   JaxConfig(wavefront=False, grad_fused=False, **kw))
        tp = params_from_numpy(_jax_params_numpy(jp), device="cpu")
        ts = diff.SceneStatic(js.geom_type, js.geom_material, js.resolution)
        out[case] = (float(jl), _flat(_jax_params_numpy(jg)), tp, ts,
                     torch.full((n, 3), target_val), spp, seed, kw)
    return out


def _check_loss_and_grad(case, want_loss, want, loss, grads):
    got = _flat(params_to_numpy(grads))
    assert sorted(want) == sorted(got)
    print(f"{case}: loss want {want_loss:.9g} port {loss:.9g}")
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    gscale = max(float(np.abs(v).max()) for v in want.values())
    assert gscale > 0
    worst = max(float(np.abs(want[k] - got[k]).max()) for k in want)
    print(f"  worst leaf {worst:.3g} of gscale {gscale:.4g}")
    for k in want:
        d = float(np.abs(want[k] - got[k]).max())
        assert d <= 5e-4 * max(gscale, 1.0), (k, d, gscale)
        assert np.isfinite(got[k]).all(), k


def _scenes(name):
    if name == "mini":
        jscene = jax_parse(MINI_SCENE, name="mini").scene_for_frame(0)
    else:
        jscene = jax_load_scene(CORNELL).scene_for_frame(0)
    tscene = port_scene_from_jax(jscene)
    jt = (_pack_gdata(jscene.geoms), jb.pack_material_table(jscene.materials),
          jb.pack_light_table(jscene.geoms, jscene.materials), jb.pack_scalars(jscene))
    jvals = (*(_jax_values(t) for t in jt[:3]), [jnp.float32(v) for v in np.asarray(jt[3])])
    return jvals, pack_tables(tscene)


def _jplanes(a):
    return tuple(jnp.asarray(a[:, k]) for k in range(3))


@pytest.mark.parametrize("nee", [True, False], ids=["nee", "no_nee"])
@pytest.mark.parametrize("name", ["cornell", "mini"])
def test_replay_and_bounce_bwd_plain_match_jax(name, nee):
    (gv, mv, lv, sv), tables = _scenes(name)
    lanes = random_lanes(N, seed=3)
    u = np.asarray(jax_hash_uniforms(jnp.uint32(SEED), jnp.asarray(lanes["sample"]),
                                     jnp.asarray(lanes["depth"]), 11))
    ju = [jnp.asarray(u[:, k]) for k in range(11)]
    zero = (jnp.zeros(N, jnp.float32),) * 3
    kw = dict(nee=nee, t_min=T_MIN, features=frozenset())
    carries = (_jplanes(lanes["origin"]), _jplanes(lanes["direction"]),
               _jplanes(lanes["throughput"]))
    jdepth, jprev = jnp.asarray(lanes["depth"]), jnp.asarray(lanes["prev"])
    jout = jb.bounce_physics(*carries, zero, zero[0], gv, mv, lv, sv, ju, jdepth, jprev,
                             emit_replay=True, **kw)

    t = {k: torch.from_numpy(v) for k, v in lanes.items()}
    args = (tables, t["origin"], t["direction"], t["throughput"], t["sample"].long(),
            t["depth"], t["prev"])
    res, rgid, rnee = bounce_fused.bounce_fused_plain(*args, torch.zeros(N, 4), SEED, nee=nee,
                                                      emit_replay=True)
    np.testing.assert_array_equal(rgid.numpy(), np.asarray(jout["replay_gid"]))
    np.testing.assert_array_equal(rnee.numpy(), np.asarray(jout["replay_nee_add"]))
    miss = rgid < 0
    assert 0 < int(miss.sum()) < N and int((res.terminate & ~miss).sum()) > 0
    assert int(rnee.sum()) > 0 if nee else int(rnee.sum()) == 0

    replay = {"gid": jout["replay_gid"], "nee_add": jout["replay_nee_add"]}

    def f(o, d, thr, gv, mv, lv, sv):
        out = jb.bounce_physics(o, d, thr, zero, zero[0], gv, mv, lv, sv, ju, jdepth, jprev,
                                replay=replay, **kw)
        return out["contrib"], out["next_o"], out["next_d"], out["thr_mult"]

    r = np.random.default_rng(5)
    cots = [r.standard_normal((N, 3)).astype(np.float32) for _ in range(4)]
    _, vjp = jax.vjp(f, *carries, gv, mv, lv, sv)
    want = vjp(tuple(_jplanes(c) for c in cots))
    got = bounce_grad.bounce_bwd_plain(*args, rgid, rnee, *(torch.from_numpy(c) for c in cots),
                                       SEED, nee=nee)
    for i, label in enumerate(("d_origin", "d_direction", "d_throughput")):
        w = np.stack([np.asarray(x) for x in want[i]], -1)
        g = got[4 + i].numpy()
        print(f"{name} nee={nee} {label}: worst {np.abs(g - w).max():.3g} of max "
              f"{np.abs(w).max():.4g}")
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=label)
    for i, label in enumerate(("gtab", "mtab", "ltab", "scal")):
        w = np.asarray(want[3 + i], np.float64).reshape(got[i].shape)
        err = float(np.abs(got[i].numpy() - w).max())
        print(f"{name} nee={nee} {label}: worst {err:.3g} of max {np.abs(w).max():.4g}")
        assert err <= 1e-5 * max(float(np.abs(w).max()), 1e-30), label


def test_bounce_diff_dispatch_on_device():
    """CPU tensors take the plain versions under autograd, with no launch;
    the kernel wrappers refuse CPU tensors (nothing falls back); zero
    cotangents give exact zeros on every lane; the float64 reference takes
    only float32 or float64."""
    (_, tables) = _scenes("mini")
    lanes = {k: torch.from_numpy(v) for k, v in random_lanes(64, seed=8).items()}
    o = lanes["origin"].clone().requires_grad_()
    before = (bounce_fused.launches, bounce_fused.replay_launches, bounce_grad.launches)
    scene = port_scene_from_jax(jax_parse(MINI_SCENE, name="mini").scene_for_frame(0))
    cfg = RenderConfig(grad_lean=True, features=())
    res = bounce_grad.bounce_fused_diff(scene, o, lanes["direction"], lanes["throughput"],
                                        lanes["sample"].long(), 2, lanes["prev"], None, SEED, cfg,
                                        tables=tables)
    (res.contrib.sum() + res.next_origin.sum()).backward()
    assert o.grad is not None and bool(torch.isfinite(o.grad).all())
    assert (bounce_fused.launches, bounce_fused.replay_launches, bounce_grad.launches) == before
    assert not res.terminate.requires_grad and not res.rr_uniform.requires_grad

    args = (tables, lanes["origin"], lanes["direction"], lanes["throughput"],
            lanes["sample"].long(), lanes["depth"], lanes["prev"])
    _, rgid, rnee = bounce_fused.bounce_fused_plain(*args, torch.zeros(64, 4), SEED, nee=True,
                                                    emit_replay=True)
    zero = torch.zeros(64, 3)
    for dtype in (torch.float32, torch.float64):
        grads = bounce_grad.bounce_bwd_plain(*args, rgid, rnee, zero, zero, zero, zero, SEED,
                                             nee=True, dtype=dtype)
        assert not any(bool(g.any()) for g in grads)
    with pytest.raises(ValueError, match="float32 or float64"):
        bounce_grad.bounce_bwd_plain(*args, rgid, rnee, zero, zero, zero, zero, SEED, nee=True,
                                     dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        bounce_grad.bounce_bwd_cuda(*args, rgid, rnee, zero, zero, zero, zero, SEED, nee=True)
    with pytest.raises(ValueError, match="CUDA"):
        bounce_fused.bounce_fused_cuda(*args, torch.zeros(64, 4), SEED, nee=True,
                                       emit_replay=True)
    with pytest.raises(NotImplementedError, match="fast_rng=False"):
        bounce_grad.bounce_fused_diff(scene, o, lanes["direction"], lanes["throughput"],
                                      lanes["sample"].long(), 2, lanes["prev"], None, SEED,
                                      dataclasses.replace(cfg, fast_rng=False), tables=tables)


@pytest.mark.parametrize("case", sorted(CASES))
def test_perbounce_loss_and_grad_matches_jax_and_full_trace(case, jax_losses):
    want_loss, want, tp, ts, target, spp, seed, kw = jax_losses[case]
    cfg = RenderConfig(wavefront=False, grad_full_trace=False, **kw)
    counts = (trace_grad.fwd_launches, trace_grad.bwd_launches, bounce_grad.launches)
    loss, grads, rays = diff.loss_and_grad_rays(tp, ts, target, spp, prng_key(seed), cfg,
                                                device="cpu")
    assert counts == (trace_grad.fwd_launches, trace_grad.bwd_launches, bounce_grad.launches)
    assert rays.dtype == torch.int64 and int(rays) >= spp * target.shape[0]
    _check_loss_and_grad(case, want_loss, want, float(loss), grads)

    full_loss, full, full_rays = diff.loss_and_grad_rays(
        tp, ts, target, spp, prng_key(seed), dataclasses.replace(cfg, grad_full_trace=None),
        device="cpu")
    assert int(full_rays) == int(rays)
    _check_loss_and_grad(f"{case} vs the full-depth engine", float(full_loss),
                         _flat(params_to_numpy(full)), float(loss), grads)


@pytest.mark.parametrize("engine", [{}, dict(grad_full_trace=False)], ids=["full", "perbounce"])
def test_checkpoint_per_iteration_above_8_spp(monkeypatch, engine):
    """Above 8 spp each iteration of a fused-scope engine runs under a
    checkpoint (``diff.py:288-298``): the loss and gradients equal the same
    step run without it, bit for bit, and the backward recomputes each
    iteration's forward once."""
    from pathtracer_tpu_torch.ops import bounce as bounce_ops
    from pathtracer_tpu_torch.scene.parser import parse_scene_text

    desc = dataclasses.replace(parse_scene_text(MINI_SCENE, name="mini"), resolution=(6, 5))
    params, static = diff.params_from_description(desc, 0, device="cpu")
    cfg = RenderConfig(max_depth=2, **engine)
    target = torch.full((30, 3), 0.2)
    calls = {"bounce": 0}
    physics = bounce_ops.bounce_physics

    def counting(*a, **k):
        calls["bounce"] += 1
        return physics(*a, **k)

    for mod in (trace_grad, bounce_fused):
        monkeypatch.setattr(mod, "bounce_physics", counting)
    loss, grads = diff.loss_and_grad(params, static, target, 9, prng_key(2), cfg, device="cpu")
    with_checkpoint = calls["bounce"]
    monkeypatch.setattr(diff, "checkpoint",
                        lambda fn, *a, use_reentrant, preserve_rng_state, **k: fn(*a, **k))
    calls["bounce"] = 0
    loss2, grads2 = diff.loss_and_grad(params, static, target, 9, prng_key(2), cfg, device="cpu")
    assert float(loss) == float(loss2)
    for k, v in grads.leaves().items():
        assert torch.equal(v, grads2.leaves()[k]), k
    # the forward's bounces run twice with the checkpoint: 9 iterations x 2 bounces
    assert with_checkpoint - calls["bounce"] == 9 * 2
