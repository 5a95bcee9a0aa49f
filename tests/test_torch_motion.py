"""Motion blur (``render/motion.py``) and the CLI's ``--all-frames`` and
``--motion-blur`` in the port, on the CPU.

Mirrors ``tests/test_motion.py``: static frames reduce to the plain render
(here exactly: ``torch.equal``, the same samples, transforms and order of
adds), the sliding sphere smears, one frame is refused.  Against JAX's
``render_motion`` at 32x32, depth 4, 4 spp on ``animation.txt`` (rigid
motion, camera dolly) and ``deform_demo.txt`` (lerped vertices, no LBVH):
the shutter times bit-equal, ray counts equal, at least 95% of accumulator
entries within rtol = atol = 1e-5 and the sums within 2e-5 relative
(ROADMAP's golden bar; measured 99.9% / 100% of entries, sums equal).

A deforming mesh above ``ops/mesh.MESH_KERNEL_MAX_TRIS`` triangles takes
an LBVH rebound to the lerped vertices (where JAX sweeps densely): its
nearest hits equal the dense sweep's over the lerped triangles.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render.motion import render_motion as jax_render_motion
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import trace
from pathtracer_tpu_torch.ops.mesh import (
    MESH_KERNEL_MAX_TRIS,
    mesh_nearest_plain,
    mesh_query,
    pack_tri_table,
)
from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key
from pathtracer_tpu_torch.render.diff import build_scene
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.render.motion import (
    lerp_params,
    motion_params,
    render_motion,
    shutter_time,
)
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.imageio import load_png

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CFG = RenderConfig(max_depth=4, iters_per_launch=8)


def _desc(name, res=(32, 32), loader=load_scene):
    return dataclasses.replace(loader(os.path.join(SCENES, f"{name}.txt")), resolution=res)


@pytest.fixture(scope="module")
def anim():
    return _desc("animation")


def test_static_frames_reduce_to_plain_render(anim):
    frozen = dataclasses.replace(
        anim, **{k: np.repeat(getattr(anim, k)[:1], 2, 0)
                 for k in ("eye", "view", "up", "translations", "rotations", "scales")})
    _, a_static, s_static = render(frozen.scene_for_frame(0, device="cpu"), 8, CFG, device="cpu")
    _, a_motion, s_motion = render_motion(frozen, 0, 8, CFG, device="cpu")
    assert torch.equal(a_static, a_motion)
    assert s_static["rays_traced"] == s_motion["rays_traced"]


def test_motion_blur_spreads_the_moving_object(anim):
    _, a0, _ = render(anim.scene_for_frame(0, device="cpu"), 24, CFG, device="cpu")
    _, am, _ = render_motion(anim, 0, 24, CFG, device="cpu")
    a0 = a0.numpy().reshape(32, 32, 3) / 24.0
    am = am.numpy().reshape(32, 32, 3) / 24.0
    assert np.isfinite(am).all()
    assert np.abs(a0 - am).mean() > 0.005
    assert abs(am.mean() - a0.mean()) < 0.25 * a0.mean()


def test_motion_requires_two_frames(anim):
    with pytest.raises(ValueError, match="frames 0 and 1"):
        render_motion(dataclasses.replace(anim, frames=1), 0, 4, CFG, device="cpu")


@pytest.mark.parametrize("name", ["animation", "deform_demo"])
def test_render_motion_matches_jax(name):
    spp = 4
    jcfg = JaxConfig(max_depth=4, iters_per_launch=spp)
    _, want, jstats = jax_render_motion(_desc(name, loader=jax_load_scene), 0, spp, jcfg)
    seen = []
    _, got, stats = render_motion(
        _desc(name), 0, spp, RenderConfig(max_depth=4, iters_per_launch=spp),
        progress_fn=lambda done, acc: seen.append(done), device="cpu")
    assert seen == [spp]
    want, got = np.asarray(want), got.numpy()
    share = float(np.isclose(got, want, rtol=1e-5, atol=1e-5).mean())
    sum_rel = abs(float(got.sum()) - float(want.sum())) / abs(float(want.sum()))
    print(f"{name}: {share:.5f} of entries within 1e-5 of JAX, sums within {sum_rel:.3g}")
    assert stats["rays_traced"] == int(jstats["rays_traced"])
    assert share >= 0.95 and sum_rel <= 2e-5
    key, seed = jax.random.PRNGKey(0), KeyedSeed(prng_key(0))
    for it in range(spp):
        jt = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, it), 0x7FFF7777))
        assert shutter_time(seed, it).numpy().view(np.uint32) == np.asarray(jt).view(np.uint32)


def _grid_tris(cells: int, bump: float) -> np.ndarray:
    """``2 cells^2`` triangles of a grid over the unit square, its height
    ``bump`` times a ripple."""
    c = np.linspace(-0.5, 0.5, cells + 1)
    x, y = np.meshgrid(c, c, indexing="xy")
    v = np.stack([x, y, bump * np.sin(6.0 * x) * np.cos(6.0 * y)], -1).astype(np.float32)
    a, b, d, e = v[:-1, :-1], v[:-1, 1:], v[1:, :-1], v[1:, 1:]
    tris = np.concatenate([np.stack([a, b, e], -2), np.stack([a, e, d], -2)], 0)
    return tris.reshape(-1, 3, 3)


def test_deforming_mesh_above_the_cap_takes_a_rebound_lbvh():
    demo = _desc("deform_demo", res=(8, 8))
    p0, _, static = motion_params(demo, 0, "cpu")
    assert static.mesh_accel_keys == (None,)  # below the cap: no LBVH, as in JAX
    frames = (_grid_tris(65, 0.05), _grid_tris(65, -0.2))
    assert len(frames[0]) > MESH_KERNEL_MAX_TRIS
    g = next(i for i, t in enumerate(demo.mesh_tris) if t is not None)
    objs = [None] * len(demo.mesh_tris)
    big = dataclasses.replace(
        demo, mesh_tris=tuple(frames[0] if i == g else t for i, t in enumerate(demo.mesh_tris)),
        mesh_tris_frames=tuple(frames if i == g else None for i in range(len(objs))),
        mesh_attrs=tuple(objs))
    p0, p1, static = motion_params(big, 0, "cpu")
    assert static.mesh_accel_keys[0] is not None
    t = shutter_time(KeyedSeed(prng_key(0)), 3)
    mesh = build_scene(lerp_params(p0, p1, t), static).meshes[0]
    rs = np.random.default_rng(0)
    n = 512
    o = torch.from_numpy(np.concatenate([rs.uniform(-0.4, 0.4, (n, 2)), np.ones((n, 1))], 1)
                         .astype(np.float32))
    d = torch.from_numpy(np.concatenate([rs.uniform(-0.05, 0.05, (n, 2)), -np.ones((n, 1))], 1)
                         .astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t_lbvh, _, row = mesh_query(mesh, o, d, with_index=True)
    t_dense, idx = mesh_nearest_plain(pack_tri_table(mesh.tri_verts.detach()), None, o, d)
    assert bool((t_dense < 1e10).all())  # every ray hits the grid
    assert torch.equal(t_lbvh, t_dense)
    assert torch.equal(mesh.accel.scan_to_file[row].long(), idx.long())
    _, acc, stats = render_motion(big, 0, 1, RenderConfig(max_depth=2), device="cpu")
    assert bool(torch.isfinite(acc).all()) and stats["rays_traced"] > 0


def test_cli_all_frames_and_motion_blur(tmp_path, capsys):
    text = open(os.path.join(SCENES, "animation.txt")).read().replace("RES         400 400",
                                                                     "RES         16 12")
    scene_file = tmp_path / "anim.txt"
    scene_file.write_text(text)
    common = [f"scene={scene_file}", "--spp", "2", "--depth", "3", "--device", "cpu"]
    assert cli.main(common + ["--all-frames", "--out", str(tmp_path / "all.png")]) == 0
    frames = [load_png(str(tmp_path / f"all.{f}.png")) for f in (0, 1)]
    assert all(f.shape == (12, 16, 3) for f in frames)
    assert not np.array_equal(frames[0], frames[1])  # the camera dollied back
    before = trace.launches
    assert cli.main(common + ["--motion-blur", "--out", str(tmp_path / "mb.png")]) == 0
    assert trace.launches == before  # the plain versions ran
    blurred = load_png(str(tmp_path / "mb.0.png"))
    assert not (tmp_path / "mb.1.png").exists()
    img, _, _ = render_motion(load_scene(str(scene_file)), 0, 2,
                              RenderConfig(max_depth=3, wavefront=True), device="cpu")
    want = np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8)
    assert np.array_equal(blurred, want)
    printed = capsys.readouterr().out
    assert printed.count("engine=wavefront") == 3 and "(motion blur)" in printed
