"""Differentiable render of the PyTorch port vs the JAX package on the CPU.

The port's table builders, winner replay, reverse trace loop and
``render/diff.loss_and_grad`` against JAX's on the same numbers (inputs
and cotangents drawn from seeded numpy).  On CPU tensors the port runs the
plain versions of its two CUDA kernels (``ops/trace_grad.py:tfwd_plain``
and ``tbwd_plain``); JAX takes its lean XLA backward, because
``fused_diff_eligible`` is false off the TPU.

Tolerances, with the reason:

* table builders (``build_transform``, ``generate_camera_rays``,
  ``pack_tables``) against ``jax.vjp``: rtol 1e-5 with an absolute floor
  of 1e-5 of the largest cotangent of the tensor: the same formulas in
  float32, summed in another order;
* winner replay against the sweep: outputs equal bit for bit (the replay
  recomputes the winner with the sweep's arithmetic); gradients within
  1e-5 of the largest of each tensor (the table cotangents gather rows
  where the sweep selects them, so the sums run in another order);
* ``tbwd_plain`` against autograd straight through ``trace_plain``: table
  cotangents within 1e-5 of the largest entry of each table, ``d_origin``
  and ``d_direction`` within rtol = atol = 1e-5 on every lane.  Measured
  (printed under ``pytest -s``): below 1e-6 relative;
* ``tbwd_plain``'s float64 reference: the replayed bounce's outputs equal
  the float32 bounce's bit for bit, and its gradients meet the previous
  item's bar against the float32 loop on MINI_SCENE;
* ``loss_and_grad`` against JAX's: the loss within 1e-5 relative, every
  leaf within 5e-4 * max(gscale, 1), the bar JAX holds between its own
  engines (``tests/test_bounce_grad.py:169-176``).  Measured: the loss
  within 1e-7 and the leaves within 3.3e-5 of gscale (printed).
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
from pathtracer_tpu.ops.bounce_pallas import pack_light_table as jax_pack_light
from pathtracer_tpu.ops.bounce_pallas import pack_material_table as jax_pack_material
from pathtracer_tpu.ops.bounce_pallas import pack_scalars as jax_pack_scalars
from pathtracer_tpu.ops.camera import generate_camera_rays as jax_camera_rays
from pathtracer_tpu.ops.intersect_pallas import _pack_gdata as jax_pack_gdata
from pathtracer_tpu.ops.transforms import build_transform as jax_build_transform
from pathtracer_tpu.render.diff import loss_and_grad as jax_loss_and_grad
from pathtracer_tpu.render.diff import params_from_description as jax_params
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu.scene.parser import parse_scene_text as jax_parse
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import trace, trace_grad
from pathtracer_tpu_torch.ops.bounce import bounce_physics, pack_tables
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.ops.intersect import T_MIN
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes, prng_key
from pathtracer_tpu_torch.ops.transforms import build_transform
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.render.megakernel import trace_paths
from pathtracer_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from pathtracer_tpu_torch.scene.structs import MATERIAL_FIELDS, Rays
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "scenes", "cornell.txt")


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rel=1e-5, name=""):
    """``got`` within ``rel`` of ``want`` entry-wise, with an absolute
    floor of ``rel`` times the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = np.abs(got - want)
    assert (err <= rel * (np.abs(want) + scale)).all(), (
        f"{name}: worst {err.max():.3g} against scale {scale:.3g}"
    )


@pytest.fixture(scope="module")
def mini_desc():
    return parse_scene_text(MINI_SCENE, name="mini")


@pytest.fixture(scope="module")
def jax_cornell():
    return jax_load_scene(CORNELL)


# ---------------------------------------------------------------------------
# (a) the table builders carry JAX's cotangents
# ---------------------------------------------------------------------------

def test_build_transform_vjp_matches_jax():
    r = _rng(1)
    trs = [r.uniform(-2, 2, (5, 3)), r.uniform(-180, 180, (5, 3)), r.uniform(0.3, 3, (5, 3))]
    trs = [x.astype(np.float32) for x in trs]
    cts = [r.standard_normal((5, 4, 4)).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(jax_build_transform, *[jnp.asarray(x) for x in trs])
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    leaves = [torch.from_numpy(x).requires_grad_() for x in trs]
    m, minv = build_transform(*leaves)
    got = torch.autograd.grad([m, minv], leaves, [torch.from_numpy(c) for c in cts])
    for name, g, w in zip(("translation", "rotation", "scale"), got, want):
        _close(g.numpy(), np.asarray(w), name=name)


@pytest.mark.parametrize("scene_name", ["cornell", "glass_dof"])
def test_camera_rays_vjp_matches_jax(scene_name):
    jscene = dataclasses.replace(
        jax_load_scene(os.path.join(ROOT, "scenes", f"{scene_name}.txt")), resolution=(11, 7)
    ).scene_for_frame(0)
    tscene = port_scene_from_jax(jscene)
    n = 77
    r = _rng(2)
    u4 = r.uniform(0, 1, (n, 4)).astype(np.float32)
    cts = [r.standard_normal((n, 3)).astype(np.float32) for _ in range(2)]
    fields = ("position", "view", "up", "fov", "aperture", "focal_distance")

    def jfn(*vals):
        cam = dataclasses.replace(jscene.camera, **dict(zip(fields, vals)))
        rays = jax_camera_rays(cam, jnp.arange(n, dtype=jnp.int32), None, jitter=True,
                               per_ray_uniforms=jnp.asarray(u4))
        return rays.origin, rays.direction

    _, vjp = jax.vjp(jfn, *[getattr(jscene.camera, f) for f in fields])
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    leaves = [getattr(tscene.camera, f).clone().requires_grad_() for f in fields]
    cam = dataclasses.replace(tscene.camera, **dict(zip(fields, leaves)))
    rays = generate_camera_rays(cam, torch.arange(n), torch.from_numpy(u4))
    got = torch.autograd.grad(
        [rays.origin, rays.direction], leaves, [torch.from_numpy(c) for c in cts],
        allow_unused=True,
    )
    for f, g, w in zip(fields, got, want):
        g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
        _close(g, np.asarray(w), name=f)


def test_pack_tables_vjp_matches_jax(jax_cornell):
    jscene = jax_cornell.scene_for_frame(0)
    tscene = port_scene_from_jax(jscene)
    r = _rng(3)
    g, m = jscene.geoms.count, jscene.materials.count
    cts = [r.standard_normal(s).astype(np.float32) for s in ((g, 14), (m, 28), (g, 19), (2,))]
    mat_fields = MATERIAL_FIELDS

    def jfn(transform, inv_transform, *mvals):
        geoms = dataclasses.replace(jscene.geoms, transform=transform, inv_transform=inv_transform)
        mats = dataclasses.replace(jscene.materials, **dict(zip(mat_fields, mvals)))
        scene = dataclasses.replace(jscene, geoms=geoms, materials=mats)
        return (jax_pack_gdata(geoms), jax_pack_material(mats), jax_pack_light(geoms, mats),
                jax_pack_scalars(scene))

    prims = [jscene.geoms.transform, jscene.geoms.inv_transform,
             *[getattr(jscene.materials, f) for f in mat_fields]]
    _, vjp = jax.vjp(jfn, *prims)
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    leaves = [tscene.geoms.transform.clone().requires_grad_(),
              tscene.geoms.inv_transform.clone().requires_grad_(),
              *[getattr(tscene.materials, f).clone().requires_grad_() for f in mat_fields]]
    geoms = dataclasses.replace(tscene.geoms, transform=leaves[0], inv_transform=leaves[1])
    mats = dataclasses.replace(tscene.materials, **dict(zip(mat_fields, leaves[2:])))
    tables = pack_tables(dataclasses.replace(tscene, geoms=geoms, materials=mats))
    got = torch.autograd.grad(tables, leaves, [torch.from_numpy(c) for c in cts],
                              allow_unused=True)
    for name, gt, w in zip(("transform", "inv_transform", *mat_fields), got, want):
        gt = np.zeros(np.shape(w), np.float32) if gt is None else gt.numpy()
        _close(gt, np.asarray(w), name=name)


# ---------------------------------------------------------------------------
# (b) winner replay == the sweep
# ---------------------------------------------------------------------------

def test_winner_replay_matches_sweep(mini_desc):
    scene = dataclasses.replace(mini_desc, resolution=(37, 23)).scene_for_frame(0, device="cpu")
    n = 37 * 23
    pix = torch.arange(n)
    seed = 11
    rays = generate_camera_rays(scene.camera, pix, camera_uniforms(seed, pix))
    tables = [t.detach() for t in pack_tables(scene)]
    zero = torch.zeros(n)
    state = dict(o=tuple(rays.origin.unbind(-1)), d=tuple(rays.direction.unbind(-1)),
                 thr=(torch.ones(n),) * 3, prev=zero)
    r = _rng(4)
    outs = ("contrib", "next_o", "next_d", "thr_mult")
    cts = [torch.from_numpy(r.standard_normal((3, n)).astype(np.float32)) for _ in outs]
    for dep in range(2):  # primary rays, then their continuations
        u = hash_uniforms_planes(seed, pix, dep, 11)
        kw = dict(nee=True, t_min=T_MIN, features=frozenset({"glossy"}))

        def run(replay):
            o = [c.clone().requires_grad_() for c in state["o"]]
            d = [c.clone().requires_grad_() for c in state["d"]]
            thr = [c.clone().requires_grad_() for c in state["thr"]]
            tabs = [t.clone().requires_grad_() for t in tables]
            out = bounce_physics(tuple(o), tuple(d), tuple(thr), (zero,) * 3, zero, *tabs, u,
                                 dep, state["prev"], emit_replay=replay is None,
                                 replay=replay, **kw)
            ys = [c for k in outs for c in out[k]]
            grads = torch.autograd.grad(ys, [*o, *d, *thr, *tabs],
                                        [c for ct in cts for c in ct], allow_unused=True)
            return out, grads

        sweep, g_sweep = run(None)
        hit = sweep["replay_gid"] >= 0
        assert 0 < int(hit.sum()) < n
        replay, g_replay = run({"gid": sweep["replay_gid"], "nee_add": sweep["replay_nee_add"]})
        for k in outs:
            for a, b in zip(sweep[k], replay[k]):
                assert torch.equal(a[hit], b[hit]), k
        assert torch.equal(sweep["terminate"], replay["terminate"])
        for i, (a, b) in enumerate(zip(g_sweep, g_replay)):
            a = torch.zeros_like(b) if a is None else a
            b = torch.zeros_like(a) if b is None else b
            _close(b.detach().numpy(), a.detach().numpy(), name=f"grad {i}")
        state = dict(o=tuple(c.detach() for c in sweep["next_o"]),
                     d=tuple(c.detach() for c in sweep["next_d"]),
                     thr=tuple(c.detach() for c in sweep["thr_mult"]), prev=sweep["wspec"])


# ---------------------------------------------------------------------------
# (c) the reverse loop == autograd through the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nee", [True, False], ids=["nee", "no_nee"])
def test_tbwd_plain_matches_autograd_through_trace_plain(mini_desc, nee):
    res = (37, 23)  # 851 lanes: no multiple of a block or a warp
    scene = dataclasses.replace(mini_desc, resolution=res).scene_for_frame(0, device="cpu")
    n = res[0] * res[1]
    pix = torch.arange(n)
    seed = 1234
    sample = 3 * n + pix
    rays = generate_camera_rays(scene.camera, pix, camera_uniforms(seed, sample))
    kw = dict(max_depth=3, nee=nee, rr=True, rr_start=1)
    g_rad = torch.from_numpy(_rng(5).standard_normal((n, 3)).astype(np.float32))

    tabs = [t.detach().requires_grad_() for t in pack_tables(scene)]
    o = rays.origin.detach().requires_grad_()
    d = rays.direction.detach().requires_grad_()
    rad, nrays = trace.trace_plain(*tabs, seed, o, d, sample, **kw)
    want = torch.autograd.grad((rad * g_rad).sum(), [*tabs, o, d], allow_unused=True)
    want = [torch.zeros_like(x) if w is None else w for w, x in zip(want, [*tabs, o, d])]

    plain = [t.detach() for t in tabs]
    rad2, nrays2, resid = trace_grad.tfwd_plain(*plain, seed, rays.origin, rays.direction,
                                                sample, **kw)
    assert torch.equal(rad2, rad.detach()) and int(nrays2) == int(nrays)
    assert resid.shape == (3, trace_grad.N_RESID, n)
    got = trace_grad.tbwd_plain(*plain, seed, sample, resid, g_rad, **kw)
    for name, g, w in zip(("gtab", "mtab", "ltab", "scal"), got[:4], want[:4]):
        scale = float(w.abs().max())
        print(f"{name}: max {scale:.4g}, worst {float((g - w).abs().max()):.3g}")
        assert float((g - w).abs().max()) <= 1e-5 * max(scale, 1e-30), name
    for name, g, w in zip(("d_origin", "d_direction"), got[4:], want[4:]):
        assert torch.isclose(g, w, rtol=1e-5, atol=1e-5).all(), name
        assert bool(torch.isfinite(g).all())
    if nee:
        assert float(want[0].abs().max()) > 0 and float(want[4].abs().max()) > 0


def test_tbwd_plain_float64_reference_keeps_float32_values(mini_desc):
    """``tbwd_plain(dtype=torch.float64)``, the reference the reverse kernel
    is held to, recomputes each bounce in float64 with the float32
    bounce's values: every output of the replayed bounce equals the float32
    one bit for bit.  On MINI_SCENE, whose paths have no ill-conditioned
    lanes, its gradients agree with the float32 loop within the element-wise
    bar of (c)."""
    res = (37, 23)
    scene = dataclasses.replace(mini_desc, resolution=res).scene_for_frame(0, device="cpu")
    n = res[0] * res[1]
    pix = torch.arange(n)
    seed = 1234
    sample = 3 * n + pix
    rays = generate_camera_rays(scene.camera, pix, camera_uniforms(seed, sample))
    tables = pack_tables(scene)
    kw = dict(max_depth=3, nee=True, rr=True, rr_start=1)
    _, _, resid = trace_grad.tfwd_plain(*tables, seed, rays.origin, rays.direction, sample, **kw)

    r = resid[1]
    tail = trace_grad.tail_plane(())
    u = hash_uniforms_planes(seed, sample, 1, 11)

    def bounce(r, tabs):
        zero = torch.zeros_like(r[0])
        return bounce_physics(
            tuple(r[0:3]), tuple(r[3:6]), tuple(r[6:9]), (zero,) * 3, zero, *tabs, u, 1,
            r[tail], nee=True, t_min=T_MIN, replay={"gid": r[tail + 2], "nee_add": r[tail + 3]},
        )

    want = bounce(r, tables)
    with trace_grad._Float32Values():
        got = bounce(r.double(), [t.double() for t in tables])
    for key, w in want.items():
        for gv, wv in zip(got[key] if isinstance(w, tuple) else (got[key],),
                          w if isinstance(w, tuple) else (w,)):
            assert torch.equal(gv.to(wv.dtype), wv), key
    assert all(c.dtype == torch.float64 for c in (*got["contrib"], *got["next_d"]))

    g_rad = torch.from_numpy(_rng(5).standard_normal((n, 3)).astype(np.float32))
    ref = trace_grad.tbwd_plain(*tables, seed, sample, resid, g_rad, dtype=torch.float64, **kw)
    f32 = trace_grad.tbwd_plain(*tables, seed, sample, resid, g_rad, **kw)
    assert all(t.dtype == torch.float64 for t in ref)
    for g, w in zip(f32[:4], ref[:4]):
        assert float((g.double() - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)
    for g, w in zip(f32[4:], ref[4:]):
        assert torch.isclose(g.double(), w, rtol=1e-5, atol=1e-5).all()
    with pytest.raises(ValueError, match="float32 or float64"):
        trace_grad.tbwd_plain(*tables, seed, sample, resid, g_rad, dtype=torch.float16, **kw)


def test_trace_diff_dispatch_on_device(mini_desc):
    """CPU rays take the plain versions under autograd; the kernel wrappers
    refuse CPU tensors (nothing falls back); the per-bounce engine
    (``grad_full_trace=False``) runs and gives the full-depth trace's
    radiance and origin cotangents; ``fast_rng=False`` waits for its
    slice."""
    scene = dataclasses.replace(mini_desc, resolution=(5, 4)).scene_for_frame(0, device="cpu")
    tables = pack_tables(scene)
    pix = torch.arange(20)
    rays = generate_camera_rays(scene.camera, pix, camera_uniforms(3, pix))
    o = rays.origin.clone().requires_grad_()
    cfg = RenderConfig(max_depth=2, grad_lean=True, features=())
    before = (trace.launches, trace_grad.fwd_launches, trace_grad.bwd_launches)
    rad, nrays = trace_paths(scene, Rays(o, rays.direction), pix, 3, cfg, tables=tables)
    rad.sum().backward()
    assert o.grad is not None and o.grad.shape == (20, 3)
    assert not nrays.requires_grad
    assert (trace.launches, trace_grad.fwd_launches, trace_grad.bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        trace_grad.tfwd_cuda(*tables, 3, rays.origin, rays.direction, pix,
                             max_depth=2, nee=True, rr=False, rr_start=3)
    with pytest.raises(ValueError, match="CUDA"):
        trace_grad.tbwd_cuda(*tables, 3, pix, torch.zeros(2, trace_grad.N_RESID, 20),
                             torch.zeros(20, 3),
                             max_depth=2, nee=True, rr=False, rr_start=3)
    o2 = rays.origin.clone().requires_grad_()
    rad2, nrays2 = trace_paths(scene, Rays(o2, rays.direction), pix, 3,
                               dataclasses.replace(cfg, grad_full_trace=False), tables=tables)
    rad2.sum().backward()
    assert torch.equal(rad2.detach(), rad.detach()) and int(nrays2) == int(nrays)
    assert torch.allclose(o2.grad, o.grad, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="later slice"):
        trace_paths(scene, rays, pix, 3, dataclasses.replace(cfg, fast_rng=False))


# ---------------------------------------------------------------------------
# (d) loss_and_grad == JAX's
# ---------------------------------------------------------------------------

def _jax_params_numpy(p) -> dict:
    d = {k: np.asarray(getattr(p, k)) for k in (
        "translations", "rotations", "scales", "cam_position", "cam_view", "cam_up",
        "cam_fov", "cam_aperture", "cam_focal")}
    d["materials"] = {k: np.asarray(getattr(p.materials, k)) for k in MATERIAL_FIELDS}
    return d


def _flat(d: dict) -> dict:
    out = {k: v for k, v in d.items() if k != "materials"}
    out.update({f"materials.{k}": v for k, v in d["materials"].items()})
    return out


CASES = {
    # test_bounce_grad.py:143-176: MINI_SCENE 40x40, d3, spp 1, glossy, RR off
    "mini_d3_glossy": ("mini", None, 1, 7, 0.25,
                       dict(nee=True, max_depth=3, auto_features=False, features=("glossy",))),
    # test_grad.py:27-39: Cornell 24x24, d4, spp 4
    "cornell_24_d4": ("cornell", (24, 24), 4, 7, 0.0, dict(max_depth=4, jitter=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grad_matches_jax(case, jax_cornell):
    name, res, spp, seed, target_val, kw = CASES[case]
    jdesc = jax_parse(MINI_SCENE, name="mini") if name == "mini" else jax_cornell
    if res is not None:
        jdesc = dataclasses.replace(jdesc, resolution=res)
    jp, js = jax_params(jdesc, 0)
    n = js.resolution[0] * js.resolution[1]
    jcfg = JaxConfig(wavefront=False, **kw)
    assert jcfg.grad_fused is None  # JAX takes its lean XLA backward on the CPU
    jl, jg = jax_loss_and_grad(jp, js, jnp.full((n, 3), target_val, jnp.float32), spp,
                               jax.random.PRNGKey(seed), jcfg)

    tp = params_from_numpy(_jax_params_numpy(jp), device="cpu")
    ts = diff.SceneStatic(js.geom_type, js.geom_material, js.resolution)
    tl, tg, rays = diff.loss_and_grad_rays(
        tp, ts, torch.full((n, 3), target_val), spp, prng_key(seed),
        RenderConfig(wavefront=False, **kw), device="cpu",
    )
    assert rays.dtype == torch.int64 and int(rays) >= spp * n
    jl, tl = float(jl), float(tl)
    print(f"{case}: loss JAX {jl:.9g} port {tl:.9g}")
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    want, got = _flat(_jax_params_numpy(jg)), _flat(params_to_numpy(tg))
    assert sorted(want) == sorted(got)
    gscale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        d = float(np.abs(want[k] - got[k]).max())
        print(f"  {k}: max {float(np.abs(want[k]).max()):.4g}, worst {d:.3g}")
        assert d <= 5e-4 * max(gscale, 1.0), (k, d, gscale)
    assert gscale > 0


# ---------------------------------------------------------------------------
# (e) inverse rendering recovers the wall colour
# ---------------------------------------------------------------------------

def test_inverse_rendering_recovers_wall_color():
    """``test_grad.py:139-165`` for the port: the example's Adam loop on the
    red wall at 24x24, depth 4, spp 4."""
    from pathtracer_tpu_torch.examples import inverse_rendering

    out = inverse_rendering.main(
        ["--device", "cpu", "--res", "24", "--depth", "4", "--steps", "16"]
    )
    assert out["loss_last"] < 0.3 * out["loss_first"], out
    assert out["err_end"] < 0.2 < out["err_start"], out


# ---------------------------------------------------------------------------
# (f) entry points need CUDA unless asked for the CPU
# ---------------------------------------------------------------------------

def test_diff_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    desc = dataclasses.replace(load_scene(CORNELL), resolution=(6, 5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diff.params_from_description(desc, 0)
    params, static = diff.params_from_description(desc, 0, device="cpu")
    target = torch.zeros((30, 3))
    cfg = RenderConfig(max_depth=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diff.loss_and_grad(params, static, target, 1, prng_key(0), cfg)
    loss, grads = diff.loss_and_grad(params, static, target, 1, prng_key(0), cfg, device="cpu")
    assert float(loss) > 0
    assert isinstance(grads, diff.SceneParams)
    assert grads.materials.emittance.shape == params.materials.emittance.shape
    assert float(grads.materials.emittance.abs().max()) > 0
    assert float(grads.materials.texture_scale.abs().max()) == 0  # no path to the loss
    # an image atlas is a leaf: its texels, not its slot sizes
    from pathtracer_tpu_torch.ops.texture import build_atlas

    atlas = build_atlas([np.ones((2, 3, 3), np.float32)], device="cpu")
    leaves = dataclasses.replace(params, textures=atlas).leaves()
    assert leaves["textures.data"] is atlas.data and "textures.hw" not in leaves
    back = diff.SceneParams.from_leaves(leaves, atlas.hw)
    assert back.textures.data is atlas.data and back.textures.hw is atlas.hw
    verts = dataclasses.replace(params, mesh_verts=[torch.zeros(1, 3, 3)]).mesh_verts
    assert isinstance(verts, tuple) and len(verts) == 1  # mesh vertices are leaves


def test_gather_rows_sums_each_row_in_float64():
    """``ops/bsdf.gather_rows``, the lean engine's per-lane gather of table
    rows: its forward equals ``index_select``; its backward is each row's
    float64 sum of the lane cotangents rounded once to float32, so it does
    not depend on the order of the adds (a float32 sum of 200,000 lanes
    into four rows does)."""
    from pathtracer_tpu_torch.ops.bsdf import gather_rows

    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((4, 4, 4)).astype(np.float32))
    table.requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 4, 200_000))
    cot = torch.from_numpy((rng.standard_normal((200_000, 4, 4)) * 1e3 + 1).astype(np.float32))
    rows = gather_rows(table, idx)
    assert torch.equal(rows, torch.index_select(table, 0, idx))
    (got,) = torch.autograd.grad(rows, table, cot)
    want = torch.zeros((4, 4, 4), dtype=torch.float64).index_add_(0, idx, cot.double()).float()
    assert torch.equal(got, want)
    perm = torch.from_numpy(rng.permutation(200_000))
    (again,) = torch.autograd.grad(gather_rows(table, idx[perm]), table, cot[perm])
    assert torch.equal(again, got)
