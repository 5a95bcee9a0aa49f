"""Masked megakernel path integrator: the trace of one wavefront.

Port of ``pathtracer_tpu/render/megakernel.py:28-175``.  The forward takes
the full-depth trace of ``ops/trace.py`` (``:44-64`` in the JAX package).
With ``cfg.fused=False`` the forward takes the per-bounce scan
(``:116-175``, the non-lean branch): a loop over ``max_depth`` bounces of
``render/common.shade_bounce`` on its split route (kernels 6 and 8 on a
CUDA tensor) with an alive mask.  Under ``cfg.grad_lean`` (``:66-115``) a
scene in the fused scope takes the full-depth differentiable trace of
``ops/trace_grad.py`` (kernels 4 and 5), or with ``grad_full_trace=False``
the per-bounce engine: the same scan, whose ``shade_bounce`` is
``ops/bounce_grad.BounceDiff`` (kernel 2 with replay planes, kernel 3
backward), with no checkpoint.  Any other scene takes the lean scan: the
scan on ``shade_bounce``'s lean split route, each bounce under
``torch.utils.checkpoint``, so that only the bounce's inputs are kept and
its backward recomputes the shading; the detached winner search and shadow
ray (kernels 7 and 8) keep their outputs in a per-bounce cache and do not
run again in the recompute (``save_only_these_names("lean_winner")`` in
JAX).  The lean engine's backward on a scene of the fused scope passes
the scan its forward's winners, NEE bits and rays, which each bounce
replays (``render/diff.LeanSample``).  Each runs its CUDA kernels for rays
on a CUDA device and its plain version for rays on the CPU.  The scan carries each path's medium, ``[N,
4]`` or ``[N, 5]`` with the ``hg`` feature (``:164-166``), from vacuum.
``cfg.debug`` raises: the debug variant belongs to a later slice.
The wavefront engines are ``render/wavefront.py``, chosen by the
integrator.

A scene with image textures takes the per-bounce scan on every route, as
JAX's ``trace_paths`` does (its trace kernel refuses them): with
``cfg.fused`` None the scan's ``shade_bounce`` runs kernel 2's
deferred-texel variant.

Mesh scenes whose meshes total at most 4096 triangles take the full-depth
trace with the in-kernel triangle sweep (kernel 1's mesh variant); larger
ones take the per-bounce scan, as in JAX (``:44-64``), whose
``shade_bounce`` runs kernel 2's mesh-merge variant (kernels 9 and 10, or
the LBVH traversal above 8192 triangles, around it), or the split route
with ``cfg.fused=False``.  Under ``cfg.grad_lean`` mesh scenes take the
lean scan, as JAX's ``fused_diff_eligible`` excludes them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.bounce_fused import medium_width
from pathtracer_tpu_torch.ops.trace import fused_trace_eligible, trace_fused
from pathtracer_tpu_torch.ops.trace_grad import fused_diff_eligible, trace_fused_diff
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.scene.structs import Rays, Scene


DEBUG_MISSING = (
    "RenderConfig(debug=True): the per-chunk finite check and the alive histogram "
    "(pathtracer_tpu/render/integrator.py:154-192, render/megakernel.py:156-175) are a "
    "later slice"
)


def scan_paths(scene: Scene, rays: Rays, sample_idx, seed: int, cfg: RenderConfig,
               tables=None, replay=None):
    """The per-bounce scan: ``(radiance [N, 3], rays_traced int64 [])``.
    Russian roulette divides by ``p`` with ``p`` detached, as the JAX scan
    does.  Under ``cfg.grad_lean`` outside the fused scope each bounce runs
    under a checkpoint with its own lean cache (the module docstring says
    why); the checkpoint keeps no torch RNG state, since the port's
    sampling is the counter hash.  ``replay``, the lean scan's only, is
    ``(gid [depth, N], nee [depth, N], ray [depth, 6, N])`` of
    ``ops/trace_grad.trace_replay``: bounce ``k`` takes the winner and NEE
    bit of row ``k`` (and its checkpoint's recompute the same), and its ray
    takes the forward's values with the scan's own gradient (the forward
    kernel and the scan round apart, and a grazing hit magnifies that
    across bounces), so each bounce is differentiated at the forward's
    path, as the full-depth engine's reverse kernel does."""
    lean = cfg.grad_lean and not fused_diff_eligible(scene, cfg)
    if replay is not None and not lean:
        raise ValueError("a replay is the lean scan's: RenderConfig(grad_lean=True, "
                         "grad_fused=False)")
    n = rays.count
    f32 = dict(dtype=torch.float32, device=rays.origin.device)
    throughput = torch.ones((n, 3), **f32)
    alive = torch.ones(n, dtype=torch.bool, device=rays.origin.device)
    prev_spec = torch.zeros(n, **f32)  # emit-state code
    medium = torch.zeros((n, medium_width(cfg.features)), **f32)
    radiance = torch.zeros((n, 3), **f32)
    nrays = torch.zeros((), dtype=torch.int64, device=rays.origin.device)
    for depth in range(cfg.max_depth):
        nrays = nrays + alive.sum() * (2 if cfg.nee else 1)  # + the shadow ray
        if replay is not None:
            ray = replay[2][depth]
            rays = Rays(origin=_with_value(rays.origin, ray[0:3].T),
                        direction=_with_value(rays.direction, ray[3:6].T))
        if lean:
            res = checkpoint(shade_bounce, scene, rays, throughput, sample_idx, depth, prev_spec,
                             seed, cfg, medium_sigma=medium, tables=tables, lean_cache={},
                             replay=None if replay is None else (replay[0][depth],
                                                                 replay[1][depth]),
                             use_reentrant=False, preserve_rng_state=False)
        else:
            res = shade_bounce(scene, rays, throughput, sample_idx, depth, prev_spec, seed, cfg,
                               medium_sigma=medium, tables=tables)
        radiance = radiance + torch.where(alive[:, None], res.contrib, 0.0)
        new_alive = alive & (~res.terminate)
        throughput = torch.where(new_alive[:, None], throughput * res.throughput_mult,
                                 throughput)
        if cfg.russian_roulette:
            p = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0).detach()
            rr_active = new_alive & (depth >= cfg.rr_start)
            throughput = torch.where(rr_active[:, None], throughput / p[:, None], throughput)
            new_alive = torch.where(rr_active, new_alive & (res.rr_uniform < p), new_alive)
        rays = Rays(
            origin=torch.where(new_alive[:, None], res.next_origin, rays.origin),
            direction=torch.where(new_alive[:, None], res.next_direction, rays.direction),
        )
        alive, prev_spec, medium = new_alive, res.was_specular, res.next_medium
    return radiance, nrays


def _with_value(x, value):
    """``value`` exactly, with ``x``'s gradient."""
    return value + (x - x.detach())


def trace_paths(
    scene: Scene, rays: Rays, sample_idx, seed: int, cfg: RenderConfig, tables=None,
    replay=None,
):
    """Trace a wavefront of primary rays to completion: ``(radiance [N, 3],
    rays_traced int64 [])``, one sample of the estimator per ray.
    ``replay`` goes to the lean scan (:func:`scan_paths`)."""
    if cfg.debug:
        raise NotImplementedError(DEBUG_MISSING)
    if replay is not None:
        return scan_paths(scene, rays, sample_idx, seed, cfg, tables=tables, replay=replay)
    if cfg.grad_lean and fused_diff_eligible(scene, cfg) and cfg.grad_full_trace is not False:
        return trace_fused_diff(scene, rays, sample_idx, seed, cfg, tables=tables)
    if cfg.grad_lean or cfg.fused is False or (cfg.fast_rng
                                                and not fused_trace_eligible(scene, cfg)):
        # image textures and meshes above the in-kernel cap stay outside the
        # one-kernel trace, as in JAX (:44-64)
        return scan_paths(scene, rays, sample_idx, seed, cfg, tables=tables)
    return trace_fused(scene, rays, sample_idx, seed, cfg, tables=tables)
