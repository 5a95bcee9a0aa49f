"""The per-bounce shading step both wavefront engines and the per-bounce
scan call.

Port of ``pathtracer_tpu/render/common.py``: ``bounce_uniforms``
(``:37-48``, the counter hash or threefry by ``cfg.fast_rng``),
``BounceResult`` (``:61-77``, defined in ``ops/bounce_fused.py`` and
re-exported here) and ``shade_bounce`` (``:101-582``).  One bounce is: nearest hit,
emittance under the 0/1/2 emit-state code, BSDF continuation, and NEE at
diffuse hits with a shadow ray.  Two routes:

* fused (``cfg.fused`` None or True): ``ops/bounce_fused.bounce_fused``,
  kernel 2 on a CUDA tensor;
* split (``cfg.fused=False``, and ``cfg.fast_rng=False``, whose threefry
  uniforms kernel 2 does not draw: a warning says so, as JAX's does,
  ``:145-190``): ``ops/intersect_cuda.nearest_hit`` (kernel
  6), ``ops/bsdf.gather_materials`` / ``sample_bsdf``,
  ``ops/lights.sample_lights`` and ``ops/intersect_cuda.occlusion_t``
  (kernel 8) for the shadow ray, the rest in PyTorch ops, in the JAX split
  path's order of operations.

Triangle meshes (``:123-234``): the fused route takes kernel 2 with the
in-kernel tables when the meshes total at most 4096 triangles, and above
that kernel 2's mesh-merge variant (``ops/bounce_fused.py``); the split
route merges each mesh's winner, with its authored smooth normal and UV,
into the analytic one (kernels 9 and 10 up to 8192 triangles, the LBVH
traversal above).

Under ``cfg.grad_lean`` (``:204-222,395-417``) a scene in the fused scope
takes ``ops/bounce_grad.bounce_fused_diff`` (kernel 2 with replay planes,
kernel 3 backward; their volumetric instances in media); any other takes
the lean split route: the detached winner search
(``ops/intersect_cuda.winner_t_gid``, kernel 7) and the winner-only
recompute of ``ops/intersect.intersect_scene_lean``, the split route's
shading, and the NEE shadow ray on detached inputs through kernel 8,
visibility a comparison.  Meshes join both detached searches (kernels 9
and 10 per mesh, or the LBVH traversal), and a mesh winner's triangle is
recomputed from the live vertices, so vertex gradients flow (JAX
``:395-417``, ``ops/intersect.py:777-910``).  ``lean_cache``, a dict, keeps
the detached searches' outputs on their first run (the volumetric NEE's
split sweep too) and hands them back to a recompute (the lean scan's
per-bounce checkpoint), so no search kernel runs again.  ``replay``, on a
scene of the fused scope, is the forward kernel's ``(gid, nee)`` of this
bounce (``ops/trace_grad.trace_replay``): the re-trace takes the replayed
winner (``ops/intersect.replay_winner``; kernel 7's ``t`` where it found
the same geom) and the replayed surface NEE bit in place of its own
comparisons, with no shadow ray; the scan gives it the forward's ray
(``render/megakernel.scan_paths``), so it differentiates the path the
forward counted.

Participating media (``:311-348,440-582``): with ``volumetric`` the
bounce samples an exponential free path in the medium the ray travels
through; a lane that scatters before the surface takes no surface event (no
emittance, no surface NEE) and continues from the scatter point, isotropic
or with ``hg`` Henyey-Greenstein; Beer-Lambert attenuation scales the
throughput first, and a transmission into or out of a material switches the
medium.  Volumetric NEE connects the scatter point to the light sample
through ``ops/intersect.occlusion_split_t`` on detached inputs (plain
PyTorch over the analytic geoms, as JAX's XLA, and kernel 10 per mesh).
Meshes above 4096 triangles with volumetric NEE take the split route, as
in JAX (``:131-153``).  Under ``grad_lean`` media differentiate: the free
path, the Beer-Lambert attenuation, the in-medium continuation and the
volumetric NEE's transmittance and phase carry gradients to the medium (its
absorption and scattering coefficients and, with ``hg``, the phase g),
while the volumetric NEE's split sweep runs detached, as JAX's
(``:537-545``): visibility is a comparison and the boundary distance a
constant of the transmittance.  ``hg`` runs on the lean route only.

Optional surface physics (``:238-308``): with ``texture`` the checker /
stripes albedo and, for a scene with image textures, the bilinear atlas
texel (``ops/texture.py``) modulate the diffuse albedo; with ``bump`` the
sinusoidal bump perturbs the shading normal, which NEE and the BSDF then
use; ``microfacet`` / ``ward`` put the Cook-Torrance and Ward lobes in the
BSDF.  On the fused route kernel 2 runs its surface instance and, with
image textures, its deferred-texel variant.  A mesh lane's image UV is the
box map of its object-space normal ``M^T n_world`` or its authored ``vt``
(``:258-279``).  Under ``grad_lean`` the surface features differentiate:
in a scene in the fused scope on kernel 2's surface instance with replay
planes and kernel 3's (2r-s, 3s); otherwise on the lean split route, where
the albedo's choice is discrete, the bump's frame is JAX's split path's
(``:284-309``), and an image texture's texels are differentiable while the
UV's geom id and box-map transform run detached (``:262,266``).

``cfg.pallas`` picks no route in the port.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from pathtracer_tpu_torch.ops.bounce import check_diff_features, check_features, pack_tables
from pathtracer_tpu_torch.ops.bounce_fused import BounceResult, bounce_fused, medium_width
from pathtracer_tpu_torch.ops.bounce_grad import bounce_fused_diff
from pathtracer_tpu_torch.ops.bsdf import (
    RAY_BIAS,
    gather_materials,
    henyey_greenstein,
    hg_phase_value,
    sample_bsdf,
    uniform_sphere,
)
from pathtracer_tpu_torch.ops.intersect import (
    intersect_scene_lean,
    occlusion_split_t,
    replay_winner,
)
from pathtracer_tpu_torch.ops.intersect_cuda import nearest_hit, occlusion_t, winner_t_gid
from pathtracer_tpu_torch.ops.lights import sample_lights
from pathtracer_tpu_torch.ops.mesh import merge_mesh_winners
from pathtracer_tpu_torch.ops.mesh_tables import mesh_inkernel_eligible
from pathtracer_tpu_torch.ops.rng import fold_in, hash_uniforms, sample_keys, uniform
from pathtracer_tpu_torch.ops.texture import compute_uv, sample_atlas
from pathtracer_tpu_torch.ops.trace_grad import fused_diff_eligible
from pathtracer_tpu_torch.scene.structs import Rays

__all__ = ["BounceResult", "bounce_uniforms", "shade_bounce"]


def bounce_uniforms(seed: int, sample_idx, depth, fast_rng: bool = True) -> torch.Tensor:
    """``[N, 11]`` uniforms, a pure function of (seed, sample, depth): 3 for
    the BSDF, 1 for russian roulette, 4 for the light sample, 3 for media.
    ``fast_rng`` takes the counter hash; otherwise threefry's
    ``uniform(fold_in(fold_in(key, sample), depth + 1), (11,))`` per lane,
    with ``seed`` a ``KeyedSeed``."""
    if fast_rng:
        return hash_uniforms(seed, sample_idx, depth, 11)
    keys = sample_keys(seed, sample_idx)
    d1 = (depth.to(torch.int64) if isinstance(depth, torch.Tensor) else int(depth)) + 1
    return uniform(fold_in(keys, d1), (11,))


def _cached(cache, key, fn):
    """``fn()`` of a detached search, run without autograd (so that the
    checkpoint's recompute, which reads the cache, saves what its first run
    saved), kept in ``cache[key]`` on the first call when a cache is
    given."""
    if cache is None or key not in cache:
        with torch.no_grad():
            out = fn()
        if cache is None:
            return out
        cache[key] = out
    return cache[key]


def _detached(rays: Rays) -> Rays:
    return Rays(origin=rays.origin.detach().contiguous(),
                direction=rays.direction.detach().contiguous())


def shade_bounce(scene, rays: Rays, throughput, sample_idx, depth, prev_specular, seed: int,
                 cfg, medium_sigma=None, tables=None, lean_cache=None,
                 replay=None) -> BounceResult:
    """One physics step for a wavefront of rays (mask-free: callers gate
    with their alive masks).  ``depth`` is an int or a per-lane tensor;
    ``tables`` are ``ops/bounce.pack_tables`` of the scene; ``medium_sigma``
    the medium each ray travels through, ``[N, 4]`` (sigma_a rgb, sigma_s)
    or with ``hg`` ``[N, 5]`` (the phase g), None for vacuum; ``lean_cache``
    and ``replay`` (the lean split route's ``(gid [N], nee [N])``) as the
    module docstring says."""
    check_features(cfg.features)
    if cfg.grad_lean:
        check_diff_features(cfg.features, "lean")
    if replay is not None and (not cfg.grad_lean or scene.meshes):
        raise ValueError("a replay is the lean split route's, on scenes without meshes")
    tables = tables if tables is not None else pack_tables(scene)
    if medium_sigma is None:
        medium_sigma = torch.zeros((throughput.shape[0], medium_width(cfg.features)),
                                   dtype=torch.float32, device=throughput.device)
    # volumetric NEE through meshes the in-kernel sweep does not take runs
    # on the split route (:131-153): kernel 2's mesh-merge variant defers no
    # refractive/opaque split
    vol_mesh = (bool(scene.meshes) and not mesh_inkernel_eligible(scene.meshes)
                and "volumetric" in cfg.features and cfg.nee and cfg.vol_nee)
    if cfg.grad_lean and fused_diff_eligible(scene, cfg):
        return bounce_fused_diff(scene, rays.origin, rays.direction, throughput, sample_idx,
                                 depth, prev_specular, medium_sigma, seed, cfg, tables=tables)
    use_fused = cfg.fused is not False and not cfg.grad_lean and not vol_mesh
    if use_fused and not cfg.fast_rng:
        # kernel 2 draws the counter hash: threefry's samples take the split
        # route, with JAX's warning (:145-190)
        warnings.warn(
            ("fused bounce kernel auto-disabled (fast_rng=False) — rendering on the split "
             "per-op path") if cfg.fused is None else
            "cfg.fused=True unsupported (fast_rng=False) — falling back to the split per-op path",
            stacklevel=2)
        use_fused = False
    if use_fused:
        return bounce_fused(scene, rays.origin, rays.direction, throughput, sample_idx, depth,
                            prev_specular, medium_sigma, seed, cfg, tables=tables)

    gtab, mtab = tables[0], tables[1]
    if cfg.grad_lean:
        def search():
            rays_d, gtab_d = _detached(rays), gtab.detach().contiguous()
            found = merge_mesh_winners(rays_d, gtab_d, scene.meshes,
                                       *winner_t_gid(rays_d, gtab_d))
            return found if replay is None else replay_winner(rays_d, gtab_d, found, replay[0])

        winner = _cached(lean_cache, "winner", search)
        hit = intersect_scene_lean(rays, gtab, winner=winner, meshes=scene.meshes)
    else:
        hit = nearest_hit(rays, gtab, scene.meshes)
    mat = gather_materials(mtab, hit.material_id)
    emissive = mat.emittance > 0.0
    normal = hit.normal

    if "texture" in cfg.features:
        # procedural solid texture in the winner's object space
        cells = torch.floor(hit.position_obj * mat.texture_scale[:, None])
        checker = torch.remainder(cells[:, 0] + cells[:, 1] + cells[:, 2], 2.0)
        stripes = torch.remainder(cells[:, 0], 2.0)
        pattern = torch.where(mat.texture_type > 1.5, stripes, checker)
        textured = (mat.texture_type > 0.5) & (mat.texture_type < 2.5) & (pattern > 0.5)
        mat = dataclasses.replace(
            mat, color=torch.where(textured[:, None], mat.texture_color2, mat.color))
    if "texture" in cfg.features and scene.textures is not None:
        # image texture: UV from the object-space hit, bilinear atlas texel
        gid = hit.geom_id.detach().long()
        gtype = scene.geoms.type[gid]
        m3 = scene.geoms.transform.detach()[gid][:, :3, :3].to(normal.dtype)
        n_obj = torch.einsum("nij,ni->nj", m3, normal)  # n_obj ~ M^T n_world
        uv = compute_uv(gtype, hit.position_obj, n_obj)
        if hit.uv is not None:
            # the authored vt wins on the mesh lanes that have one
            uv = torch.where(hit.uv_valid[:, None], hit.uv, uv)
        texel = sample_atlas(scene.textures, mat.texture_image,
                             uv * mat.texture_scale[:, None])
        is_img = mat.texture_type > 2.5
        mat = dataclasses.replace(
            mat, color=torch.where(is_img[:, None], mat.color * texel, mat.color))
    if "bump" in cfg.features:
        # tangential sinusoidal perturbation of the shading normal
        bump_on = mat.bump_scale > 0.0
        ax = torch.abs(normal)
        use_x = ax[:, 0] < 0.577
        use_y = (~use_x) & (ax[:, 1] < 0.577)
        one, zero = torch.ones_like(ax[:, 0]), torch.zeros_like(ax[:, 0])
        not_n = torch.stack([torch.where(use_x, one, zero), torch.where(use_y, one, zero),
                             torch.where(use_x | use_y, zero, one)], dim=-1)
        t1 = torch.linalg.cross(normal, not_n, dim=-1)
        t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-12)
        t2 = torch.linalg.cross(normal, t1, dim=-1)
        w1 = torch.tensor([12.9898, 78.233, 37.719], dtype=torch.float32, device=normal.device)
        w2 = torch.tensor([93.989, 26.651, 61.312], dtype=torch.float32, device=normal.device)
        ph1 = torch.sum(hit.position_obj * w1, dim=-1)
        ph2 = torch.sum(hit.position_obj * w2, dim=-1)
        amp = torch.where(bump_on, mat.bump_amp, 0.0)
        n_bumped = (normal + (amp * torch.sin(mat.bump_scale * ph1))[:, None] * t1
                    + (amp * torch.sin(mat.bump_scale * ph2))[:, None] * t2)
        n_bumped = n_bumped / torch.clamp(
            torch.linalg.vector_norm(n_bumped, dim=-1, keepdim=True), min=1e-12)
        normal = torch.where(bump_on[:, None], n_bumped, normal)

    u = bounce_uniforms(seed, sample_idx, depth, cfg.fast_rng)

    sigma_a = medium_sigma[:, 0:3]
    sigma_s = medium_sigma[:, 3]
    wide_medium = medium_sigma.shape[1] > 4
    medium_g = medium_sigma[:, 4] if wide_medium else torch.zeros_like(sigma_s)
    has_vol = "volumetric" in cfg.features
    if has_vol:
        # the free path to the next scatter event (effectively infinite in
        # a medium that does not scatter), and Beer-Lambert attenuation
        # over the segment actually travelled
        free_path = torch.where(
            sigma_s > 0.0,
            -torch.log(torch.clamp(1.0 - u[:, 8], 1e-7, 1.0)) / torch.clamp(sigma_s, min=1e-12),
            1e30,
        )
        vol_scatter = hit.hit & (free_path < hit.t)
        seg = torch.where(vol_scatter, free_path, torch.where(hit.hit, hit.t, 0.0))
        atten = torch.exp(-sigma_a * seg[:, None])
        throughput = throughput * atten
    else:
        vol_scatter = torch.zeros_like(hit.hit)

    # emittance at a BSDF hit: with NEE only where no NEE could have sampled
    # the light, on primary rays and after a specular event (state 1)
    prev_state = prev_specular.to(torch.float32)
    if cfg.nee:
        at_depth0 = torch.as_tensor(depth, device=throughput.device) == 0
        count_emit = at_depth0 | (torch.abs(prev_state - 1.0) < 0.5)
    else:
        count_emit = torch.ones_like(emissive)
    emitted = throughput * mat.color * mat.emittance[:, None]
    contrib = torch.where((hit.hit & emissive & count_emit & (~vol_scatter))[:, None],
                          emitted, 0.0)

    scatter = sample_bsdf(mat, hit.position, normal, rays.direction, u[:, 0:3],
                          glossy="glossy" in cfg.features,
                          microfacet="microfacet" in cfg.features, ward="ward" in cfg.features)

    if cfg.nee:
        ls = sample_lights(scene.geoms, scene.materials, u[:, 4:8])
        n_shade = normal * torch.sign(-torch.sum(normal * rays.direction, dim=-1, keepdim=True))
        x = hit.position + RAY_BIAS * n_shade
        to_light = ls.position - x
        dist2 = torch.sum(to_light * to_light, dim=-1)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = to_light / dist[:, None]
        cos_x = torch.sum(n_shade * wi, dim=-1)
        cos_y = torch.sum(ls.normal * (-wi), dim=-1)
        diffuse_lane = hit.hit & (~emissive) & (~scatter.is_specular) & (~vol_scatter)
        candidate = diffuse_lane & ls.valid & (cos_x > 0) & (cos_y > 0)
        shadow = Rays(origin=x.contiguous(), direction=wi.contiguous())
        if replay is not None:  # the forward kernel's bit: candidate and visible
            add = replay[1]
        elif cfg.grad_lean:  # visibility is a comparison: the shadow ray runs detached
            occ_t = _cached(lean_cache, "occlusion", lambda: occlusion_t(
                _detached(shadow), gtab.detach().contiguous(), scene.meshes))
            add = candidate & (occ_t >= dist.detach() - 4.0 * RAY_BIAS)
        else:
            occ_t = occlusion_t(shadow, gtab, scene.meshes)
            add = candidate & (occ_t >= dist - 4.0 * RAY_BIAS)
        g = cos_x * cos_y / torch.clamp(dist2, min=1e-12)
        nee = (throughput * (mat.color / math.pi) * ls.emitted
               * (g / torch.clamp(ls.pdf_area, min=1e-20))[:, None])
        contrib = contrib + torch.where(add[:, None], nee, 0.0)

    # emit-state code of this bounce: a specular event continues a
    # suppressed chain (2 -> 2), otherwise 1; a diffuse event resets to 0
    surf_state = torch.where(
        scatter.is_specular, torch.where(torch.abs(prev_state - 2.0) < 0.5, 2.0, 1.0), 0.0
    )
    terminate = (~hit.hit) | (emissive & (~vol_scatter))
    if not has_vol:
        return BounceResult(
            contrib=contrib,
            next_origin=scatter.origin,
            next_direction=scatter.direction,
            throughput_mult=scatter.throughput_mult,
            terminate=terminate,
            was_specular=surf_state,
            rr_uniform=u[:, 3],
            next_medium=medium_sigma,
        )

    # ---- in-medium scatter: a phase-sampled continuation from the scatter
    # point, in the same medium
    vol_pos = rays.origin + free_path[:, None] * rays.direction
    if "hg" in cfg.features:
        # per lane against the uniform sphere, so that g == 0 lanes scatter
        # as without the feature
        hg_dir = henyey_greenstein(rays.direction, medium_g, u[:, 9], u[:, 10])
        vol_dir = torch.where((medium_g != 0.0)[:, None], hg_dir,
                              uniform_sphere(u[:, 9], u[:, 10]))
    else:
        vol_dir = uniform_sphere(u[:, 9], u[:, 10])

    # a transmission enters the material's medium or leaves to vacuum
    tr, ent = scatter.transmitted, scatter.entering
    surf_medium = torch.cat(
        [
            torch.where(tr[:, None], torch.where(ent[:, None], mat.absorption, 0.0), sigma_a),
            torch.where(tr, torch.where(ent, mat.has_scatter * mat.scatter_coeff, 0.0),
                        sigma_s)[:, None],
        ]
        + ([torch.where(tr, torch.where(ent, mat.phase_g, 0.0), medium_g)[:, None]]
           if wide_medium else []),
        dim=-1,
    )

    # ---- volumetric NEE: the light sample (the surface NEE's: the two sets
    # of lanes are disjoint) connected to the scatter point through the
    # straight-line transmittance; refractive interfaces bound the
    # attenuated segment, opaque geometry blocks.  Emit state 2 where it
    # counted keeps the next specular chain from counting the light again.
    vol_state = torch.ones_like(sigma_s)
    if cfg.nee and cfg.vol_nee:
        # a lane that does not scatter has a ~1e30 free path: its shadow ray
        # starts at the (finite) ray origin instead, and is masked
        vp = torch.where(vol_scatter[:, None], vol_pos, rays.origin)
        to_l = ls.position - vp
        d2v = torch.sum(to_l * to_l, dim=-1)
        distv = torch.sqrt(torch.clamp(d2v, min=1e-12))
        wiv = to_l / distv[:, None]
        cos_yv = torch.sum(ls.normal * (-wiv), dim=-1)
        cand_v = vol_scatter & ls.valid & (cos_yv > 0)
        def split():
            return occlusion_split_t(
                Rays(origin=vp.detach().contiguous(), direction=wiv.detach().contiguous()),
                gtab.detach(), mtab.detach(), scene.meshes)

        t_opaque, t_boundary = (_cached(lean_cache, "occlusion_split", split) if cfg.grad_lean
                                else split())
        visible_v = t_opaque >= distv.detach() - 4.0 * RAY_BIAS
        seg_v = torch.minimum(t_boundary, distv)
        transmit = torch.exp(-(sigma_a + sigma_s[:, None]) * seg_v[:, None])
        cos_th = torch.sum(rays.direction * wiv, dim=-1)
        if "hg" in cfg.features:
            phase = hg_phase_value(medium_g, cos_th)
        else:
            phase = torch.full_like(cos_th, 1.0 / (4.0 * math.pi))
        vol_nee = (throughput * transmit * ls.emitted
                   * (phase * cos_yv / torch.clamp(d2v, min=1e-12)
                      / torch.clamp(ls.pdf_area, min=1e-20))[:, None])
        add_v = cand_v & visible_v
        contrib = contrib + torch.where(add_v[:, None], vol_nee, 0.0)
        vol_state = torch.where(add_v, 2.0, 1.0)

    vs = vol_scatter[:, None]
    return BounceResult(
        contrib=contrib,
        next_origin=torch.where(vs, vol_pos, scatter.origin),
        next_direction=torch.where(vs, vol_dir, scatter.direction),
        throughput_mult=torch.where(vs, atten, atten * scatter.throughput_mult),
        terminate=terminate,
        was_specular=torch.where(vol_scatter, vol_state, surf_state),
        rr_uniform=u[:, 3],
        next_medium=torch.where(vs, medium_sigma, surf_medium),
    )
