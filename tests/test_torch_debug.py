"""The debug engine: ``RenderConfig(debug=True)`` in the port against JAX.

Port of ``tests/test_debug.py``.  Under ``debug`` every engine checks the
accumulator after every chunk and raises ``RuntimeError`` naming the spp
window when it is not finite; the megakernel engine takes the per-bounce
scan (the split route too) and returns the alive lanes counted before each
bounce, summed over the iterations (``stats["alive_per_bounce"]``); the
wavefront engines return no histogram, as in JAX.  JAX also turns on
``jax_debug_nans``, which has no counterpart in the port (JAX's own test
accepts either error).

Against JAX on Cornell at 32x32, depth 4, NEE, 4 spp: the histograms are
equal at every bounce (measured: 0 lanes apart at each of the 4 bounces,
so the later entries are held at 0), and the accumulators meet the golden
bars of ``tests/test_torch_render.py`` (measured 97.1% of entries within
1e-5 relative, the sum within 1.6e-7; required 95% and 2e-5).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu.render.motion import render_motion as jax_render_motion
from pathtracer_tpu.scene.parser import load_scene as jax_load_scene
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.render.motion import render_motion
from pathtracer_tpu_torch.scene.parser import load_scene
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
RES = (32, 32)
ENGINES = {
    "megakernel": dict(),
    "split": dict(fused=False),
    "pinned": dict(wavefront=True),
    "queue": dict(wavefront=True, wavefront_pinned=False),
}
HISTOGRAM = {"megakernel", "split"}  # the engines whose debug render is the scan


def _scene():
    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=RES)
    return desc.scene_for_frame(0, device="cpu")


def _nan_material(scene):
    color = scene.materials.color.clone()
    color[1, 0] = float("nan")
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, color=color))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_debug_renders_on_every_engine(engine):
    """A clean scene renders finite on every engine; the scan's engines
    have the histogram (every primary ray alive at bounce 0, never rising,
    one ray per alive lane and bounce plus its shadow ray), the wavefront
    engines none; the image equals the render without ``debug``."""
    scene = _scene()
    cfg = RenderConfig(debug=True, max_depth=4, nee=True, iters_per_launch=2, **ENGINES[engine])
    spp, n = 3, RES[0] * RES[1]
    img, accum, stats = render(scene, spp, cfg, device="cpu")
    assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(accum).all())
    _, plain, plain_stats = render(scene, spp, dataclasses.replace(cfg, debug=False),
                                   device="cpu")
    assert torch.equal(accum, plain)
    assert stats["rays_traced"] == plain_stats["rays_traced"]
    assert "alive_per_bounce" not in plain_stats
    if engine not in HISTOGRAM:
        assert "alive_per_bounce" not in stats
        return
    hist = stats["alive_per_bounce"]
    assert len(hist) == cfg.max_depth and all(isinstance(x, float) for x in hist)
    assert hist[0] == spp * n
    assert all(a >= b for a, b in zip(hist, hist[1:])), hist
    assert hist[-1] < hist[0]
    assert sum(hist) * 2 == stats["rays_traced"]  # NEE: a shadow ray per alive lane


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_debug_catches_nan_material(engine):
    """A NaN in material 1's colour raises the finite check's
    ``RuntimeError`` for the first chunk's window on every engine; without
    ``debug`` the same render returns a non-finite accumulator."""
    scene = _nan_material(_scene())
    cfg = RenderConfig(debug=True, max_depth=4, nee=True, iters_per_launch=1, **ENGINES[engine])
    with pytest.raises(RuntimeError, match=r"non-finite accumulator after spp window \[0, 1\)"):
        render(scene, 2, cfg, device="cpu")
    with pytest.raises(RuntimeError, match=r"spp window \[5, 6\)"):
        render(scene, 1, cfg, start_iteration=5, device="cpu")
    _, accum, _ = render(scene, 1, dataclasses.replace(cfg, debug=False), device="cpu")
    assert not bool(torch.isfinite(accum).all())


def test_debug_matches_jax(cornell_scene):
    """JAX's debug render and the port's on the same scene numbers: equal
    histograms (``hist[0]`` = 4 spp x 1,024 lanes), equal ray counts, and
    accumulators at the golden bars."""
    jscene = dataclasses.replace(
        cornell_scene, camera=dataclasses.replace(cornell_scene.camera, resolution=RES))
    kw = dict(max_depth=4, nee=True, wavefront=False, debug=True, iters_per_launch=2)
    _, want, jstats = jax_render(jscene, 4, JaxConfig(**kw))
    _, got, stats = render(port_scene_from_jax(jscene), 4, RenderConfig(**kw), device="cpu")
    jh, ph = np.asarray(jstats["alive_per_bounce"]), np.asarray(stats["alive_per_bounce"])
    print(f"alive per bounce: JAX {jh.tolist()}, port {ph.tolist()}, apart {(ph - jh).tolist()}")
    assert ph[0] == jh[0] == 4 * RES[0] * RES[1]
    assert np.abs(ph - jh).max() <= 0  # measured: 0 at every bounce
    assert stats["rays_traced"] == jstats["rays_traced"]
    want, got = np.asarray(want), got.numpy()
    frac = (np.abs(got - want) <= 1e-5 * (np.abs(want) + 1e-3)).mean()
    sum_rel = abs(float(got.sum()) - float(want.sum())) / abs(float(want.sum()))
    print(f"debug accumulators: {frac:.5f} of entries within 1e-5, sum rel {sum_rel:.3g}")
    assert frac >= 0.95 and sum_rel <= 2e-5


def test_motion_refuses_debug():
    """``render_motion`` under ``debug`` raises in both packages: JAX's chunk
    unpacks the debug scan's three outputs into two, the port refuses the
    flag by name before it renders."""
    name = os.path.join(ROOT, "scenes", "animation.txt")
    jdesc = dataclasses.replace(jax_load_scene(name), resolution=(8, 8))
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_render_motion(jdesc, 0, 1, JaxConfig(debug=True, max_depth=2))
    desc = dataclasses.replace(load_scene(name), resolution=(8, 8))
    with pytest.raises(ValueError, match=r"debug=True"):
        render_motion(desc, 0, 1, RenderConfig(debug=True, max_depth=2), device="cpu")
    _, accum, _ = render_motion(desc, 0, 1, RenderConfig(max_depth=2), device="cpu")
    assert bool(torch.isfinite(accum).all())
