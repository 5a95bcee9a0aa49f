"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test decides inside itself whether a card is
present and skips where there is none (nvcc builds the kernel on first
use).  Run on a machine with an NVIDIA H100:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances (those of ``tests/test_trace_pallas.py`` for the TPU kernel
against its scan): equal ray counts; radiance within rtol = atol = 2e-6 on
at least 99.9% of lanes; the wavefront's sum within 1e-5 relative.  Kernel
and plain version run the same float32 operations in the same order
(nvcc -fmad=false, no fast math), so they usually agree bit for bit.
"""

import dataclasses
import os

import pytest
import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import trace
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from tests.test_bounce_grad import MINI_SCENE

pytestmark = pytest.mark.cuda

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")


def _scene(name, res):
    if name == "mini":
        desc = parse_scene_text(MINI_SCENE, name="mini")
    else:
        desc = load_scene(os.path.join(ROOT, "scenes", f"{name}.txt"))
    return dataclasses.replace(desc, resolution=res).scene_for_frame(0, device="cuda")


@pytest.mark.parametrize(
    "name,res,kw",
    [
        ("cornell", (160, 120), dict(max_depth=8, nee=True)),
        ("mini", (64, 64), dict(max_depth=6, nee=False, russian_roulette=True, rr_start=1)),
        ("mini", (64, 64), dict(max_depth=4, nee=True)),
    ],
)
def test_trace_kernel_matches_plain(name, res, kw):
    _need_cuda()
    scene = _scene(name, res)
    cfg = RenderConfig(**kw)
    n = res[0] * res[1]
    pixel = torch.arange(n, device="cuda")
    seed = 1234
    for iteration in (0, 7):
        sample = iteration * n + pixel
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
        args = (*pack_tables(scene), seed, rays.origin, rays.direction, sample)
        opts = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
                    rr_start=cfg.rr_start)
        before = trace.launches
        rad_k, rays_k = trace.trace_cuda(*args, **opts)
        assert trace.launches == before + 1
        rad_p, rays_p = trace.trace_plain(*args, **opts)
        torch.cuda.synchronize()
        assert int(rays_k) == int(rays_p)
        close = torch.isclose(rad_k, rad_p, rtol=2e-6, atol=2e-6).all(-1)
        assert float(close.float().mean()) >= 0.999
        total = float(rad_p.double().sum())
        assert abs(float(rad_k.double().sum()) - total) <= 1e-5 * abs(total)


def test_render_launches_once_per_iteration():
    _need_cuda()
    scene = _scene("cornell", (64, 48))
    before = trace.launches
    img, accum, stats = render(scene, 5, RenderConfig(iters_per_launch=2), device="cuda")
    torch.cuda.synchronize()
    assert trace.launches - before == 5
    assert img.shape == (48, 64, 3) and bool(torch.isfinite(accum).all())
    assert stats["rays_traced"] > 0


def test_wrapper_checks_inputs():
    _need_cuda()
    scene = _scene("mini", (8, 8))
    gtab, mtab, ltab, scal = pack_tables(scene)
    o = torch.zeros((4, 3), device="cuda")
    d = torch.ones((4, 3), device="cuda")
    s = torch.arange(4, device="cuda")
    kw = dict(max_depth=2, nee=True, rr=False, rr_start=3)
    with pytest.raises(TypeError):
        trace.trace_cuda(gtab.double(), mtab, ltab, scal, 1, o, d, s, **kw)
    with pytest.raises(ValueError):
        trace.trace_cuda(gtab, mtab, ltab, scal, 1, torch.zeros((3, 4), device="cuda").t(), d, s, **kw)
    big = gtab.repeat(trace.MAX_GEOMS, 1)
    with pytest.raises(ValueError):
        trace.trace_cuda(big, mtab, ltab.repeat(trace.MAX_GEOMS, 1), scal, 1, o, d, s, **kw)
