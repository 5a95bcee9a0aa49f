"""Progressive render loop.

Port of ``pathtracer_tpu/render/integrator.py:28-201``: ``render_sample``
(one jittered sample per pixel), ``render_chunk`` (a run of progressive
iterations into the radiance-sum accumulator) and ``render`` (the whole
progressive loop with ``start_iteration`` / ``accum`` resume, tone map and
stats).  ``render_chunk`` dispatches as ``_chunk_executable`` does
(``:67-80``): with ``cfg.wavefront`` the chunk is one call of a wavefront
engine (``render/wavefront.py``: pinned slots up to
``cfg.wavefront_pinned_max_pixels`` pixels, the free-slot queue otherwise);
else the megakernel's accumulator takes ``acc + radiance`` in float32 one
iteration at a time, in the same order as the JAX loop.  Ray counts are
int64 on every engine.  ``cfg.debug`` (``:87-97,154-200``) checks the
accumulator after every chunk and raises ``RuntimeError`` when it is not
finite, on every engine; the megakernel engine (the per-bounce scan under
``debug``) also sums each bounce's alive lanes into
``stats["alive_per_bounce"]``.  JAX also turns on ``jax_debug_nans``, which
has no counterpart here: the per-chunk check is what both packages share.
Every entry point renders on the device it is given, CUDA by default; on
a host without CUDA the caller must ask for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.bounce import pack_tables
from pathtracer_tpu_torch.ops.camera import primary_rays
from pathtracer_tpu_torch.ops.rng import KeyedSeed, prng_key
from pathtracer_tpu_torch.ops.tonemap import tonemap
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.megakernel import trace_paths
from pathtracer_tpu_torch.render.wavefront import render_samples_pinned, render_samples_wavefront
from pathtracer_tpu_torch.scene.structs import Scene
from pathtracer_tpu_torch.utils.metrics import span


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


def camera_sample(scene: Scene, pixel_index, iteration: int, seed: int, cfg: RenderConfig,
                  n_global_pixels=None):
    """One progressive iteration's primary rays and global sample indices
    ``iteration * n_global + pixel``, computed in int64 (the RNG reduces
    them mod 2^32, which gives the bits of JAX's wrapping int32);
    ``n_global`` is ``n_global_pixels``, or the number of pixels listed
    when it is None (``integrator.py:28-43``), so a strided subset of the
    pixels draws the samples the whole image draws there.  The camera
    uniforms follow ``cfg.fast_rng``; the rays are ``ops/camera.
    primary_rays`` (the camera kernel on the card)."""
    with span("camera_sample"):
        n_global = pixel_index.shape[0] if n_global_pixels is None else n_global_pixels
        sample_idx = iteration * n_global + pixel_index.to(torch.int64)
        return primary_rays(scene.camera, pixel_index, sample_idx, seed, cfg), sample_idx


def render_sample(
    scene: Scene, pixel_index, iteration: int, seed: int, cfg: RenderConfig, tables=None,
    replay=None, n_global_pixels=None,
):
    """One progressive iteration: ``(radiance [N, 3], rays_traced)``, its
    randomness keyed by the global sample index (:func:`camera_sample`).
    ``replay`` is the lean scan's per-bounce winners, NEE bits and rays
    (``render/megakernel.scan_paths``)."""
    rays, sample_idx = camera_sample(scene, pixel_index, iteration, seed, cfg, n_global_pixels)
    return trace_paths(scene, rays, sample_idx, seed, cfg, tables=tables, replay=replay)


def render_chunk(
    scene: Scene, accum, start_iteration: int, seed: int, cfg: RenderConfig,
    n_iters: int, tables=None,
):
    """Add ``n_iters`` progressive iterations to ``accum`` (``[N, 3]``
    radiance sum); returns ``(accum, rays_traced int64 [])``, and on the
    megakernel engine under ``cfg.debug`` a third value, the chunk's alive
    lanes per bounce (``[max_depth]`` int64)."""
    with span("render_chunk"):
        n_pixels = accum.shape[0]
        if cfg.wavefront:
            if cfg.wavefront_pinned and n_pixels <= cfg.wavefront_pinned_max_pixels:
                return render_samples_pinned(scene, accum, start_iteration, n_iters, seed, cfg,
                                             tables=tables)
            return render_samples_wavefront(scene, accum, start_iteration * n_pixels,
                                            n_iters * n_pixels, seed, cfg, tables=tables)
        pixel_index = torch.arange(n_pixels, dtype=torch.int64, device=accum.device)
        nrays = torch.zeros((), dtype=torch.int64, device=accum.device)
        hist = (torch.zeros(cfg.max_depth, dtype=torch.int64, device=accum.device)
                if cfg.debug else None)
        for i in range(n_iters):
            radiance, n, *h = render_sample(
                scene, pixel_index, start_iteration + i, seed, cfg, tables=tables
            )
            with span("accumulate"):
                accum = accum + radiance
                nrays = nrays + n
                if cfg.debug:
                    hist = hist + h[0]
        return (accum, nrays, hist) if cfg.debug else (accum, nrays)


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
    stats)`` with ``stats["rays_traced"]`` and ``stats["spp"]``, and under
    ``cfg.debug`` on the megakernel engine ``stats["alive_per_bounce"]``
    (floats, as JAX's).  Under ``cfg.debug`` a chunk that leaves the
    accumulator non-finite raises ``RuntimeError`` naming its spp window."""
    with span("render"):
        device = resolve_device(device)
        if scene.device.type != device.type or device.index not in (None, scene.device.index):
            raise ValueError(f"scene is on {scene.device}, render asked for {device}")
        cfg = resolve_features(cfg or RenderConfig(), scene.materials)
        seed = KeyedSeed(base_key if base_key is not None else prng_key(cfg.seed))
        w, h = scene.camera.width, scene.camera.height
        if accum is None:
            accum = torch.zeros((w * h, 3), dtype=torch.float32, device=scene.device)
        tables = pack_tables(scene)

        done = 0
        counts = []
        hists = []
        while done < spp:
            chunk = min(cfg.iters_per_launch, spp - done)
            accum, nrays, *hist = render_chunk(
                scene, accum, start_iteration + done, seed, cfg, chunk, tables=tables
            )
            hists += hist
            if cfg.debug and not bool(torch.isfinite(accum).all()):
                raise RuntimeError(
                    f"debug: non-finite accumulator after spp window "
                    f"[{start_iteration + done}, {start_iteration + done + chunk})"
                )
            counts.append(nrays)
            done += chunk
            if progress_fn is not None:
                progress_fn(done, accum)

        img = tonemap(accum.reshape(h, w, 3), start_iteration + spp)
        stats = {"rays_traced": int(sum(int(c) for c in counts)), "spp": spp}
        if hists:
            stats["alive_per_bounce"] = [float(x) for x in torch.stack(hists).sum(0).tolist()]
        return img, accum, stats
