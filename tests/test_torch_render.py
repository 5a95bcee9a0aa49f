"""End to end: the PyTorch port's render on the CPU, and its guards.

Golden: the port's ``render(device="cpu")`` of the ``cornell_96``
configuration (``tests/golden/generate.py``: 96x96, 16 spp, depth 8, NEE,
8 iterations per chunk, seed 0), parsed by the port's own parser, against
the JAX package's fp32 accumulator ``tests/golden/cornell_96.npy``.

The strict bar of ``tests/test_golden.py`` (every entry within 1e-5
relative) cannot hold across frameworks: a path of 8 bounces magnifies a
last-ulp difference (XLA's CPU rsqrt and fused multiply-adds against
torch's op-by-op float32) through glass refraction and grazing geometry,
and now and then turns it into a different path.  The JAX package does not
hold that bar against itself either (``test_port_vs_jax_like_jax_vs_jax``:
its own trace loop against its compiled render).  Measured (printed under
``pytest -s``): 96.16% of entries within 1e-5 relative, the image sum
within 4.0e-6 relative, the 8-bit image 0.48/255 from the PNG golden on
average (its bar is 0.8/255).  Required: 95% of entries, the sum within
2e-5, and the PNG golden's mean bar.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.ops.camera import generate_camera_rays as jax_camera_rays
from pathtracer_tpu.render.common import camera_uniforms as jax_camera_uniforms
from pathtracer_tpu.render.diff import resolve_features as jax_resolve_features
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu.render.megakernel import trace_paths as jax_trace_paths
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.imageio import load_png
from tests.test_bounce_grad import MINI_SCENE

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden")


def test_cornell_96_golden():
    desc = dataclasses.replace(
        load_scene(os.path.join(ROOT, "scenes", "cornell.txt")), resolution=(96, 96)
    )
    scene = desc.scene_for_frame(0, device="cpu")
    cfg = RenderConfig(nee=True, max_depth=8, iters_per_launch=8)
    img, accum, stats = render(scene, 16, cfg, device="cpu")
    accum = accum.numpy()
    golden = np.load(os.path.join(GOLDEN, "cornell_96.npy"))
    assert accum.shape == golden.shape
    frac = _within_1e5(accum, golden).mean()
    sum_rel = abs(accum.sum() - golden.sum()) / abs(golden.sum())
    png = load_png(os.path.join(GOLDEN, "cornell_96.png")).astype(np.float32) / 255.0
    png_mean = np.abs(img.numpy() - png).mean()
    print(f"cornell_96: {frac:.5f} of entries within 1e-5, sum rel {sum_rel:.3g}, "
          f"PNG mean {png_mean * 255:.3f}/255")
    assert frac >= 0.95
    assert sum_rel <= 2e-5
    assert png_mean <= 0.8 / 255.0
    assert stats["spp"] == 16 and stats["rays_traced"] > 16 * 96 * 96


def _within_1e5(accum, golden):
    """The entry-wise bar of ``tests/test_golden.py:_fp32_golden_check``."""
    return np.abs(accum - golden) <= 1e-5 * (np.abs(golden) + 1e-3)


def test_port_vs_jax_like_jax_vs_jax():
    """Cornell 48x48, 2 spp, depth 8, NEE: the port's accumulator against
    JAX's compiled ``render``, beside JAX's own per-iteration
    ``trace_paths`` loop against the same render.  Both miss the 1e-5
    bar on some entries; the port's misses stay within 4x JAX's own.
    Measured (printed under ``pytest -s``): JAX loop 84 of 6912 entries
    beyond 1e-5, the port 264; sums within 1e-7 relative."""
    res, spp = (48, 48), 2
    path = os.path.join(ROOT, "scenes", "cornell.txt")
    jscene = dataclasses.replace(jax_load_scene(path), resolution=res).scene_for_frame(0)
    jcfg = JaxConfig(nee=True, max_depth=8, iters_per_launch=spp)
    _, want, _ = jax_render(jscene, spp, jcfg)
    want = np.asarray(want)

    rcfg = jax_resolve_features(jcfg, jscene.materials)
    key = jax.random.PRNGKey(0)
    n = res[0] * res[1]
    pix = jnp.arange(n, dtype=jnp.int32)
    jax_loop = jnp.zeros((n, 3), jnp.float32)
    for it in range(spp):
        sample = it * n + pix
        rays = jax_camera_rays(
            jscene.camera, pix, None, jitter=True,
            per_ray_uniforms=jax_camera_uniforms(key, sample, True),
        )
        jax_loop = jax_loop + jax_trace_paths(jscene, rays, sample, key, rcfg)[0]
    jax_loop = np.asarray(jax_loop)

    tscene = dataclasses.replace(load_scene(path), resolution=res).scene_for_frame(0, device="cpu")
    _, port, _ = render(tscene, spp, RenderConfig(nee=True, max_depth=8), device="cpu")
    port = port.numpy()

    jax_miss = int((~_within_1e5(jax_loop, want)).sum())
    port_miss = int((~_within_1e5(port, want)).sum())
    print(f"entries beyond 1e-5 of {want.size}: JAX loop {jax_miss}, port {port_miss}")
    assert 0 < jax_miss
    assert port_miss <= 4 * jax_miss
    assert abs(port.sum() - want.sum()) <= 1e-6 * abs(want.sum())


def test_resume_matches_one_run():
    """Two halves with ``accum`` / ``start_iteration`` resume give the
    accumulator of one run, bit for bit (same samples, same order)."""
    scene = dataclasses.replace(
        load_scene(os.path.join(ROOT, "scenes", "cornell.txt")), resolution=(16, 12)
    ).scene_for_frame(0, device="cpu")
    cfg = RenderConfig(max_depth=3, iters_per_launch=2)
    _, whole, st = render(scene, 4, cfg, device="cpu")
    _, half, st1 = render(scene, 2, cfg, device="cpu")
    img, resumed, st2 = render(scene, 2, cfg, accum=half, start_iteration=2, device="cpu")
    assert torch.equal(whole, resumed)
    assert st["rays_traced"] == st1["rays_traced"] + st2["rays_traced"]
    assert img.shape == (12, 16, 3)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pathtracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pathtracer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'pathtracer_tpu' or k.startswith('pathtracer_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('pathtracer_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = load_scene(os.path.join(ROOT, "scenes", "cornell.txt")).scene_for_frame(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render(scene, 1)
    scene_file = tmp_path / "mini.txt"
    scene_file.write_text(MINI_SCENE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([f"scene={scene_file}", "--spp", "1"])
    out = tmp_path / "mini.png"
    assert cli.main([f"scene={scene_file}", "--spp", "1", "--depth", "3",
                     "--device", "cpu", "--out", str(out)]) == 0
    assert load_png(str(tmp_path / "mini.0.png")).shape == (40, 40, 3)
