"""The per-bounce shading step both wavefront engines and the per-bounce
scan call.

Port of ``pathtracer_tpu/render/common.py``: ``bounce_uniforms``
(``:37-48``), ``BounceResult`` (``:61-77``, defined in
``ops/bounce_fused.py`` and re-exported here) and ``shade_bounce``
(``:101-460``) for analytic scenes.  One bounce is: nearest hit,
emittance under the 0/1/2 emit-state code, BSDF continuation, and NEE at
diffuse hits with a shadow ray.  Two routes:

* fused (``cfg.fused`` None or True): ``ops/bounce_fused.bounce_fused``,
  kernel 2 on a CUDA tensor;
* split (``cfg.fused=False``): ``ops/intersect_cuda.nearest_hit`` (kernel
  6), ``ops/bsdf.gather_materials`` / ``sample_bsdf``,
  ``ops/lights.sample_lights`` and ``ops/intersect_cuda.occlusion_t``
  (kernel 8) for the shadow ray, the rest in PyTorch ops, in the JAX split
  path's order of operations.

Triangle meshes (``:123-234``): the fused route takes kernel 2 with the
in-kernel tables when the meshes total at most 4096 triangles, and raises
above that (kernel 2's mesh-merge variant is a later slice); the split
route merges each mesh's winner, with its authored smooth normal, into the
analytic one (kernels 9 and 10 up to 8192 triangles, the LBVH traversal
above).

Under ``cfg.grad_lean`` (``:204-222,395-417``) a scene in the fused scope
takes ``ops/bounce_grad.bounce_fused_diff`` (kernel 2 with replay planes,
kernel 3 backward); any other takes the lean split route: the detached
winner search (``ops/intersect_cuda.winner_t_gid``, kernel 7) and the
winner-only recompute of ``ops/intersect.intersect_scene_lean``, the split
route's shading, and the NEE shadow ray on detached inputs through kernel
8, visibility a comparison.  ``lean_cache``, a dict, keeps the two detached
searches' outputs on their first run and hands them back to a recompute
(the lean scan's per-bounce checkpoint), so neither kernel runs again.

``cfg.pallas`` picks no route in the port.  Texture, bump, volumetric,
hg, the Cook-Torrance and Ward lobes, image textures and differentiable
meshes raise ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.ops.bounce import check_features, pack_tables
from pathtracer_tpu_torch.ops.bounce_fused import BounceResult, bounce_fused
from pathtracer_tpu_torch.ops.bounce_grad import bounce_fused_diff
from pathtracer_tpu_torch.ops.bsdf import RAY_BIAS, gather_materials, sample_bsdf
from pathtracer_tpu_torch.ops.intersect import intersect_scene_lean
from pathtracer_tpu_torch.ops.intersect_cuda import nearest_hit, occlusion_t, winner_t_gid
from pathtracer_tpu_torch.ops.lights import sample_lights
from pathtracer_tpu_torch.ops.rng import hash_uniforms
from pathtracer_tpu_torch.ops.trace_grad import fused_diff_eligible
from pathtracer_tpu_torch.scene.structs import Rays

__all__ = ["BounceResult", "bounce_uniforms", "shade_bounce"]


def bounce_uniforms(seed: int, sample_idx, depth) -> torch.Tensor:
    """``[N, 11]`` uniforms, a pure function of (seed, sample, depth): 3 for
    the BSDF, 1 for russian roulette, 4 for the light sample, 3 for media."""
    return hash_uniforms(seed, sample_idx, depth, 11)


def _cached(cache, key, fn):
    """``fn()``, kept in ``cache[key]`` on the first call when a cache is
    given."""
    if cache is None:
        return fn()
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _detached(rays: Rays) -> Rays:
    return Rays(origin=rays.origin.detach().contiguous(),
                direction=rays.direction.detach().contiguous())


def shade_bounce(scene, rays: Rays, throughput, sample_idx, depth, prev_specular, seed: int,
                 cfg, medium_sigma=None, tables=None, lean_cache=None) -> BounceResult:
    """One physics step for a wavefront of rays (mask-free: callers gate
    with their alive masks).  ``depth`` is an int or a per-lane tensor;
    ``tables`` are ``ops/bounce.pack_tables`` of the scene; ``lean_cache``
    as the module docstring says."""
    check_features(cfg.features)
    if scene.textures is not None or not cfg.fast_rng:
        raise NotImplementedError(
            "shade_bounce for image textures or fast_rng=False: later slice"
        )
    if scene.meshes and cfg.grad_lean:
        raise NotImplementedError("differentiable meshes: later slice")
    tables = tables if tables is not None else pack_tables(scene)
    if medium_sigma is None:
        medium_sigma = torch.zeros((throughput.shape[0], 4), dtype=torch.float32,
                                   device=throughput.device)
    if cfg.grad_lean and fused_diff_eligible(scene, cfg):
        return bounce_fused_diff(scene, rays.origin, rays.direction, throughput, sample_idx,
                                 depth, prev_specular, medium_sigma, seed, cfg, tables=tables)
    if cfg.fused is not False and not cfg.grad_lean:
        return bounce_fused(scene, rays.origin, rays.direction, throughput, sample_idx, depth,
                            prev_specular, medium_sigma, seed, cfg, tables=tables)

    gtab, mtab = tables[0], tables[1]
    if cfg.grad_lean:
        winner = _cached(lean_cache, "winner",
                         lambda: winner_t_gid(_detached(rays), gtab.detach().contiguous()))
        hit = intersect_scene_lean(rays, gtab, winner=winner)
    else:
        hit = nearest_hit(rays, gtab, scene.meshes)
    mat = gather_materials(mtab, hit.material_id)
    emissive = mat.emittance > 0.0
    u = bounce_uniforms(seed, sample_idx, depth)

    # emittance at a BSDF hit: with NEE only where no NEE could have sampled
    # the light, on primary rays and after a specular event (state 1)
    prev_state = prev_specular.to(torch.float32)
    if cfg.nee:
        at_depth0 = torch.as_tensor(depth, device=throughput.device) == 0
        count_emit = at_depth0 | (torch.abs(prev_state - 1.0) < 0.5)
    else:
        count_emit = torch.ones_like(emissive)
    emitted = throughput * mat.color * mat.emittance[:, None]
    contrib = torch.where((hit.hit & emissive & count_emit)[:, None], emitted, 0.0)

    scatter = sample_bsdf(mat, hit.position, hit.normal, rays.direction, u[:, 0:3],
                          glossy="glossy" in cfg.features)

    if cfg.nee:
        ls = sample_lights(scene.geoms, scene.materials, u[:, 4:8])
        n_shade = hit.normal * torch.sign(
            -torch.sum(hit.normal * rays.direction, dim=-1, keepdim=True)
        )
        x = hit.position + RAY_BIAS * n_shade
        to_light = ls.position - x
        dist2 = torch.sum(to_light * to_light, dim=-1)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = to_light / dist[:, None]
        cos_x = torch.sum(n_shade * wi, dim=-1)
        cos_y = torch.sum(ls.normal * (-wi), dim=-1)
        diffuse_lane = hit.hit & (~emissive) & (~scatter.is_specular)
        candidate = diffuse_lane & ls.valid & (cos_x > 0) & (cos_y > 0)
        shadow = Rays(origin=x.contiguous(), direction=wi.contiguous())
        if cfg.grad_lean:  # visibility is a comparison: the shadow ray runs detached
            occ_t = _cached(lean_cache, "occlusion",
                            lambda: occlusion_t(_detached(shadow), gtab.detach().contiguous()))
            visible = occ_t >= dist.detach() - 4.0 * RAY_BIAS
        else:
            occ_t = occlusion_t(shadow, gtab, scene.meshes)
            visible = occ_t >= dist - 4.0 * RAY_BIAS
        g = cos_x * cos_y / torch.clamp(dist2, min=1e-12)
        nee = (throughput * (mat.color / math.pi) * ls.emitted
               * (g / torch.clamp(ls.pdf_area, min=1e-20))[:, None])
        contrib = contrib + torch.where((candidate & visible)[:, None], nee, 0.0)

    # emit-state code of this bounce: a specular event continues a
    # suppressed chain (2 -> 2), otherwise 1; a diffuse event resets to 0
    surf_state = torch.where(
        scatter.is_specular, torch.where(torch.abs(prev_state - 2.0) < 0.5, 2.0, 1.0), 0.0
    )
    return BounceResult(
        contrib=contrib,
        next_origin=scatter.origin,
        next_direction=scatter.direction,
        throughput_mult=scatter.throughput_mult,
        terminate=(~hit.hit) | emissive,
        was_specular=surf_state,
        rr_uniform=u[:, 3],
        next_medium=medium_sigma,
    )
