"""Motion blur: the shutter interval between two animation frames.

Port of ``pathtracer_tpu/render/motion.py:30-121`` (``lerp_params``,
``render_motion``).  Each progressive iteration draws one shutter time
``t ~ U[0, 1)``, threefry's ``uniform(fold_in(fold_in(key, iteration),
0x7FFF7777))`` whatever ``cfg.fast_rng`` says (``:50-52``), and renders the
scene with every leaf of ``render/diff.SceneParams`` lerped to ``t``
(TRS components and camera vectors, not matrices, so rotations
interpolate on angles; a deforming mesh's vertices).  Every pixel of an
iteration shares its ``t``; over the iterations the shutter integral
converges like any other dimension of the estimator.  The iteration then
runs as ``render/integrator.render_chunk`` runs it: the megakernel (kernel
1, or 1m for meshes the in-kernel sweep takes, once per iteration) or a
wavefront engine, by ``cfg``.

Deforming meshes lerp their vertices.  JAX sweeps them densely, without
the LBVH (``:94-100``).  The port sweeps them with kernels 9 and 10 up to
``ops/mesh.MESH_KERNEL_MAX_TRIS`` triangles and, above that, through an
LBVH built over frame ``frame``'s vertices and rebound to the lerped
vertices at each shutter time (``render/diff.build_scene``,
``ops/accel.refresh_accel``): the traversal tests the lerped triangles
themselves, so it finds the dense sweep's nearest hits.

``cfg.debug`` is refused with a ``ValueError`` before anything renders:
JAX's motion chunk unpacks the debug scan's three outputs into two
(``:65``) and fails, and neither package gives motion blur a debug mode.
"""

from __future__ import annotations

from typing import Optional

import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.mesh import MESH_KERNEL_MAX_TRIS
from pathtracer_tpu_torch.ops.rng import KeyedSeed, fold_in, prng_key, uniform
from pathtracer_tpu_torch.ops.tonemap import tonemap
from pathtracer_tpu_torch.render.diff import SceneParams, build_scene, params_from_description
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.integrator import render_chunk, resolve_device

SHUTTER_STREAM = 0x7FFF7777  # folded into an iteration's key for its shutter time


def lerp_params(p0: SceneParams, p1: SceneParams, t) -> SceneParams:
    """Every leaf ``a + t * (b - a)`` (float32); the atlas's slot sizes
    stay ``p0``'s."""
    b = p1.leaves()
    leaves = {k: a + t * (b[k] - a) for k, a in p0.leaves().items()}
    return SceneParams.from_leaves(leaves, None if p0.textures is None else p0.textures.hw)


def shutter_time(seed: KeyedSeed, iteration: int) -> torch.Tensor:
    """The iteration's shutter time, a float32 scalar on the CPU."""
    key = torch.tensor(seed.key, dtype=torch.int64)
    return uniform(fold_in(fold_in(key, iteration), SHUTTER_STREAM))


def motion_params(desc, frame: int, device):
    """``(p0, p1, static)``: the scene at frames ``frame`` and ``frame + 1``.
    A deforming mesh above ``MESH_KERNEL_MAX_TRIS`` triangles gets its LBVH
    (the module docstring says why); otherwise deforming scenes take none,
    as in JAX."""
    deforming = any(x is not None for x in (desc.mesh_tris_frames or ()))
    over_cap = any(t is not None and len(t) > MESH_KERNEL_MAX_TRIS
                   for t in desc.mesh_tris_for_frame(frame))
    accel = not deforming or over_cap
    p0, static = params_from_description(desc, frame, device=device, accel=accel)
    p1, _ = params_from_description(desc, frame + 1, device=device, accel=accel)
    return p0, p1, static


def render_motion(desc, frame: int, spp: int, cfg: Optional[RenderConfig] = None,
                  base_key=None, progress_fn=None, device="cuda"):
    """Motion-blurred render of the shutter interval ``[frame, frame + 1]``
    on ``device``: ``(image [H, W, 3], accum [N, 3], stats)`` as
    ``render/integrator.render`` returns them, ``stats["rays_traced"]`` an
    int.  ``progress_fn(done, accum)`` runs after each chunk of
    ``cfg.iters_per_launch`` iterations."""
    device = resolve_device(device)
    cfg = cfg or RenderConfig()
    if cfg.debug:
        raise ValueError("render_motion takes no RenderConfig(debug=True): motion blur has "
                         "no debug mode")
    if frame + 1 >= desc.frames:
        raise ValueError(f"motion blur needs frames {frame} and {frame + 1}; scene has "
                         f"{desc.frames} frame(s)")
    seed = KeyedSeed(base_key if base_key is not None else prng_key(cfg.seed))
    p0, p1, static = motion_params(desc, frame, device)
    cfg = resolve_features(cfg, p0.materials)
    w, h = desc.resolution
    accum = torch.zeros((w * h, 3), dtype=torch.float32, device=device)
    rays = torch.zeros((), dtype=torch.int64, device=device)
    done = 0
    while done < spp:
        chunk = min(cfg.iters_per_launch, spp - done)
        for it in range(done, done + chunk):
            t = shutter_time(seed, it).to(device)
            scene = build_scene(lerp_params(p0, p1, t), static)
            accum, n = render_chunk(scene, accum, it, seed, cfg, 1)
            rays = rays + n
        done += chunk
        if progress_fn is not None:
            progress_fn(done, accum)
    img = tonemap(accum.reshape(h, w, 3), spp)
    return img, accum, {"rays_traced": int(rays), "spp": spp}
