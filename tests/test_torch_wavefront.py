"""The port's wavefront engines on the CPU: against the JAX package's, against
the port's megakernel, and their sharding and capacity contracts.

Against JAX (Cornell 32x32, depth 6, NEE, 4 spp; the JAX scene crosses
through ``tests/test_torch_scene.port_scene_from_jax``): equal
``rays_traced``; the accumulators within rtol = atol = 2e-4
(``tests/test_render.py:120``) on at least 99.5% of entries, with the sums
within 2e-5 relative.  Not on every entry: JAX on the CPU shades with its
split XLA path, the port with the plain version of its per-bounce kernel,
and six bounces magnify their last-ulp differences (a glass refraction or a
grazing NEE test now and then goes the other way).  Measured, printed
under ``pytest -s``: 99.87% of entries, sums within 1e-6.  JAX's own two
engines give no miss count to compare with here: on the CPU both run the
same XLA path and agree exactly.

Inside the port: the wavefront accumulators against the megakernel's
(``test_render.py:111-121``: rtol = atol = 2e-4 on every entry, equal ray
counts); capacity invariance (``:124-130``); a stride-2 split of the pixels
with ``pixel_offset`` 0 and 1, interleaved, equals the stride-1 render
(pinned: bit for bit, the same samples in the same order; queue: within
1e-6, its flushes add a pixel's samples in another order).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import bounce_fused, intersect_cuda, trace
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.render import wavefront
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.imageio import load_png
from tests.test_bounce_grad import MINI_SCENE
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
QUEUE = dict(wavefront=True, wavefront_pinned=False)


def _cornell(res):
    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=res)
    return desc.scene_for_frame(0, device="cpu")


@pytest.mark.parametrize("engine", [dict(wavefront=True), dict(QUEUE, wavefront_capacity=1 << 9),
                                    dict(wavefront=True, russian_roulette=True, rr_start=2)],
                         ids=["pinned", "queue", "pinned_rr"])
def test_wavefront_matches_jax(cornell_scene, engine):
    res, spp = (32, 32), 4
    jscene = dataclasses.replace(cornell_scene,
                                 camera=dataclasses.replace(cornell_scene.camera, resolution=res))
    _, want, jstats = jax_render(jscene, spp, JaxConfig(max_depth=6, iters_per_launch=spp, **engine))
    want = np.asarray(want)
    before = (trace.launches, bounce_fused.launches)
    _, got, stats = render(port_scene_from_jax(jscene), spp,
                           RenderConfig(max_depth=6, iters_per_launch=spp, **engine), device="cpu")
    got = got.numpy()
    assert (trace.launches, bounce_fused.launches) == before  # the plain versions ran
    share = float(np.isclose(got, want, rtol=2e-4, atol=2e-4).mean())
    sum_rel = abs(float(got.sum()) - float(want.sum())) / abs(float(want.sum()))
    print(f"{engine}: {share:.5f} of entries within 2e-4 of JAX, sums within {sum_rel:.3g}")
    assert stats["rays_traced"] == int(jstats["rays_traced"])
    assert share >= 0.995
    assert sum_rel <= 2e-5


@pytest.mark.parametrize("engine", [dict(wavefront=True), dict(QUEUE, wavefront_capacity=1 << 10),
                                    dict(wavefront=True, fused=False)],
                         ids=["pinned", "queue", "pinned_split"])
def test_wavefront_matches_megakernel(engine):
    scene = _cornell((32, 32))
    base = dict(max_depth=6, iters_per_launch=8)
    _, mega, ms = render(scene, 8, RenderConfig(**base), device="cpu")
    steps = wavefront.super_steps
    _, wave, ws = render(scene, 8, RenderConfig(**base, **engine), device="cpu")
    # a pinned super-step bounces every pixel's current path once; a pixel
    # traces 8 paths of at most 6 bounces
    assert 6 <= wavefront.super_steps - steps <= 8 * 6
    torch.testing.assert_close(wave, mega, rtol=2e-4, atol=2e-4)
    assert ws["rays_traced"] == ms["rays_traced"]


def test_megakernel_split_scan_matches_trace():
    """``fused=False`` on the megakernel runs the per-bounce scan over the
    split route; it traces the same samples as the full-depth trace."""
    scene = _cornell((24, 24))
    _, mega, ms = render(scene, 4, RenderConfig(max_depth=6), device="cpu")
    _, scan, ss = render(scene, 4, RenderConfig(max_depth=6, fused=False), device="cpu")
    torch.testing.assert_close(scan, mega, rtol=2e-4, atol=2e-4)
    assert ss["rays_traced"] == ms["rays_traced"]


def test_wavefront_capacity_invariance():
    scene = _cornell((32, 32))
    base = dict(QUEUE, max_depth=4, iters_per_launch=8)
    _, a1, s1 = render(scene, 8, RenderConfig(wavefront_capacity=1 << 10, **base), device="cpu")
    _, a2, s2 = render(scene, 8, RenderConfig(wavefront_capacity=1 << 13, **base), device="cpu")
    torch.testing.assert_close(a1, a2, rtol=1e-4, atol=1e-4)
    assert s1["rays_traced"] == s2["rays_traced"]


@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "queue"])
def test_strided_split_equals_whole(pinned):
    scene = _cornell((16, 12))
    cfg = resolve_features(RenderConfig(max_depth=5, wavefront_capacity=1 << 7), scene.materials)
    tables = pack_tables(scene)
    n, iters = 16 * 12, 3
    engine = wavefront.render_samples_pinned if pinned else wavefront.render_samples_wavefront
    start, count = (1, iters) if pinned else (n, iters * n)
    whole, rays = engine(scene, torch.zeros((n, 3)), start, count, 7, cfg, tables=tables)
    parts, part_rays = [], 0
    for offset in (0, 1):
        n_local = n // 2
        start, count = (1, iters) if pinned else (n_local, iters * n_local)
        acc, r = engine(scene, torch.zeros((n_local, 3)), start, count, 7, cfg,
                        pixel_offset=offset, pixel_stride=2, n_global_pixels=n, tables=tables)
        parts.append(acc)
        part_rays += int(r)
    split = torch.stack(parts, dim=1).reshape(n, 3)  # pixel 2i from part 0, 2i+1 from part 1
    assert part_rays == int(rays)
    if pinned:
        assert torch.equal(split, whole)
    else:
        torch.testing.assert_close(split, whole, rtol=1e-6, atol=1e-6)


def test_cli_engines_on_cpu(tmp_path, capsys):
    scene_file = tmp_path / "mini.txt"
    scene_file.write_text(MINI_SCENE)
    images = {}
    for engine in ("wavefront", "megakernel", "auto"):
        out = tmp_path / f"{engine}.png"
        assert cli.main([f"scene={scene_file}", "--spp", "2", "--depth", "3", "--device", "cpu",
                         "--engine", engine, "--out", str(out)]) == 0
        images[engine] = load_png(str(tmp_path / f"{engine}.0.png"))
        assert images[engine].shape == (40, 40, 3)
    printed = capsys.readouterr().out
    assert "engine=wavefront" in printed and "engine=megakernel" in printed
    # auto takes the wavefront engine off CUDA
    assert printed.count("engine=wavefront") == 2
    # both engines trace the same samples
    diff = np.abs(images["wavefront"].astype(int) - images["megakernel"].astype(int))
    assert diff.max() <= 1


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    """No path hands a CUDA tensor to a plain version: the launchers refuse
    other devices, and the engines need CUDA unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _cornell((8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render(scene, 1, RenderConfig(wavefront=True))
    tables = pack_tables(scene)
    rays_o, rays_d = torch.zeros(4, 3), torch.ones(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        bounce_fused.bounce_fused_cuda(tables, rays_o, rays_d, torch.ones(4, 3),
                                       torch.arange(4), 0, torch.zeros(4), torch.zeros(4, 4), 1,
                                       nee=True)
    from pathtracer_tpu_torch.scene.structs import Rays

    with pytest.raises(ValueError, match="CUDA"):
        intersect_cuda.nearest_hit_cuda(Rays(rays_o, rays_d), tables[0])
    with pytest.raises(ValueError, match="CUDA"):
        intersect_cuda.occlusion_t_cuda(Rays(rays_o, rays_d), tables[0])
