"""Progressive render loop.

Port of ``pathtracer_tpu/render/integrator.py:28-201``: ``render_sample``
(one jittered sample per pixel), ``render_chunk`` (a run of progressive
iterations into the radiance-sum accumulator) and ``render`` (the whole
progressive loop with ``start_iteration`` / ``accum`` resume, tone map and
stats).  The accumulator stays on the device and takes ``acc + radiance``
in float32 one iteration at a time, in the same order as the JAX loop.
Every entry point renders on the device it is given, CUDA by default; on
a host without CUDA the caller must ask for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
from pathtracer_tpu_torch.ops.tonemap import tonemap
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.megakernel import trace_paths
from pathtracer_tpu_torch.scene.structs import Scene


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA on a
    host without a usable card (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to "
            "render with the plain PyTorch version"
        )
    return device


def render_sample(
    scene: Scene, pixel_index, iteration: int, seed: int, cfg: RenderConfig, tables=None
):
    """One progressive iteration: ``(radiance [N, 3], rays_traced)``.
    Randomness is keyed by the global sample index ``iteration * N +
    pixel``, computed in int64 (the RNG reduces it mod 2^32, which gives
    the bits of JAX's wrapping int32)."""
    sample_idx = iteration * pixel_index.shape[0] + pixel_index.to(torch.int64)
    u4 = camera_uniforms(seed, sample_idx)
    rays = generate_camera_rays(scene.camera, pixel_index, u4, jitter=cfg.jitter)
    return trace_paths(scene, rays, sample_idx, seed, cfg, tables=tables)


def render_chunk(
    scene: Scene, accum, start_iteration: int, seed: int, cfg: RenderConfig,
    n_iters: int, tables=None,
):
    """Add ``n_iters`` progressive iterations to ``accum`` (``[N, 3]``
    radiance sum); returns ``(accum, rays_traced int64 [])``."""
    n_pixels = accum.shape[0]
    pixel_index = torch.arange(n_pixels, dtype=torch.int64, device=accum.device)
    nrays = torch.zeros((), dtype=torch.int64, device=accum.device)
    for i in range(n_iters):
        radiance, n = render_sample(
            scene, pixel_index, start_iteration + i, seed, cfg, tables=tables
        )
        accum = accum + radiance
        nrays = nrays + n
    return accum, nrays


def render(
    scene: Scene,
    spp: int,
    cfg: Optional[RenderConfig] = None,
    base_key=None,
    accum: Optional[torch.Tensor] = None,
    start_iteration: int = 0,
    progress_fn=None,
    device="cuda",
):
    """Render ``spp`` progressive samples per pixel on ``device`` (where the
    scene must live); returns ``(image [H, W, 3] in [0, 1], accum [N, 3],
    stats)`` with ``stats["rays_traced"]`` and ``stats["spp"]``."""
    device = resolve_device(device)
    if scene.device.type != device.type or device.index not in (None, scene.device.index):
        raise ValueError(f"scene is on {scene.device}, render asked for {device}")
    cfg = resolve_features(cfg or RenderConfig(), scene.materials)
    seed = key_to_seed(base_key if base_key is not None else prng_key(cfg.seed))
    w, h = scene.camera.width, scene.camera.height
    if accum is None:
        accum = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
    tables = pack_tables(scene)

    done = 0
    counts = []
    while done < spp:
        chunk = min(cfg.iters_per_launch, spp - done)
        accum, nrays = render_chunk(
            scene, accum, start_iteration + done, seed, cfg, chunk, tables=tables
        )
        counts.append(nrays)
        done += chunk
        if progress_fn is not None:
            progress_fn(done, accum)

    img = tonemap(accum.reshape(h, w, 3), start_iteration + spp)
    stats = {"rays_traced": int(sum(int(c) for c in counts)), "spp": spp}
    return img, accum, stats
