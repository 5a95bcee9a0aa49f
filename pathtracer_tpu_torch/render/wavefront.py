"""Wavefront path tracing with ray regeneration.

Port of ``pathtracer_tpu/render/wavefront.py``: the free-slot queue engine
``render_samples_wavefront`` (``:48-180``) and the pinned engine
``render_samples_pinned`` (``:183-303``).  A wavefront of path slots runs
one bounce per super-step through ``render/common.shade_bounce`` (kernel 2
on a CUDA tensor; kernels 6 and 8 with ``cfg.fused=False``); a slot whose
path ends is refilled at once with its next camera sample, so no lane idles
while work is left.  The rank of each refilled slot among them is one
``cumsum`` (``ops/compact.partition``), the parallel scan classic stream
compaction uses, with no movement of live lanes.

* Pinned: slot ``i`` is local pixel ``i`` and traces that pixel's samples
  back to back; its radiance stays in the slot and lands in the
  accumulator with one add at the end.
* Queue: ``capacity`` slots take camera samples from a queue; a path that
  ends adds its radiance into three ``[P]`` accumulator planes
  (``index_add_``, whose float sums run in no fixed order on the card).

Each slot carries its path's medium, ``[N, 4]`` or ``[N, 5]`` with the
``hg`` feature (``wavefront.py:98,240``); a refilled slot starts in vacuum.

RNG and sharding contract: every uniform is keyed by the global sample
index ``iteration * n_global_pixels + global_pixel``, with ``global_pixel =
pixel_offset + pixel_stride * local_pixel``, so both engines, every
capacity and every strided split of the pixels trace the same sample set as
the megakernel.

Differences from the JAX engines, each with its reason:

* The camera rays of a refill are computed for the refilled lanes only and
  scattered into place (JAX computes them for every lane of every
  super-step and selects): they are a pure function of the global sample
  index, so the rays are the same, at the cost of one host sync per
  super-step to learn how many lanes refill.  That sync also serves the
  loop's ``while any(alive)``; :data:`super_steps` counts the super-steps.
* Rays are counted in int64 (JAX sums a float32, exact only below 2^24).
* Russian roulette divides by ``p`` as these engines do in JAX
  (``wavefront.py:136,275``), not multiplies by ``1/p`` as the trace kernel
  does.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.ops.bounce_fused import medium_width
from pathtracer_tpu_torch.ops.camera import primary_rays
from pathtracer_tpu_torch.ops.compact import partition
from pathtracer_tpu_torch.render.common import shade_bounce
from pathtracer_tpu_torch.scene.structs import Rays

super_steps = 0  # super-steps run by both engines in this process


def _spawn(scene, global_pix, sample, seed: int, cfg) -> Rays:
    """Camera rays of the given global pixels and global sample indices
    (``ops/camera.primary_rays``: the camera kernel on the card)."""
    return primary_rays(scene.camera, global_pix, sample, seed, cfg)


def _step(scene, st, seed: int, cfg, tables):
    """One super-step's bounce and path bookkeeping, shared by both engines:
    ``(res, radiance, throughput, survive)``; ``st`` holds the slot state."""
    global super_steps
    super_steps += 1
    alive = st["alive"]
    st["rays"] += alive.sum() * (2 if cfg.nee else 1)  # + the shadow ray
    res = shade_bounce(
        scene, Rays(origin=st["origin"], direction=st["direction"]), st["throughput"],
        st["sample"], st["depth"], st["prev_spec"], seed, cfg,
        medium_sigma=st["medium"], tables=tables,
    )
    radiance = st["radiance"] + torch.where(alive[:, None], res.contrib, 0.0)
    depth = st["depth"] + 1
    survive = alive & (~res.terminate) & (depth < cfg.max_depth)
    throughput = torch.where(survive[:, None], st["throughput"] * res.throughput_mult,
                             st["throughput"])
    if cfg.russian_roulette:
        p = torch.clamp(torch.amax(throughput, dim=-1), 0.05, 1.0)
        rr_on = survive & (depth >= cfg.rr_start)
        keep = res.rr_uniform < p
        throughput = torch.where(rr_on[:, None], throughput / p[:, None], throughput)
        survive = torch.where(rr_on, survive & keep, survive)
    st["depth"] = depth
    return res, radiance, throughput, survive


def _refill_lanes(refill, survive):
    """Indices of the ``refill`` lanes, in order, and whether any lane is
    alive after the refill, with one host sync."""
    lanes, count = partition(refill, torch.arange(refill.shape[0], device=refill.device))
    n_refill, n_alive = torch.stack([count, (refill | survive).sum()]).tolist()
    return lanes[:n_refill], n_alive > 0


def _continue(st, res, throughput, survive, refill, lanes):
    """Carry the continuation into every slot and reset the refilled ones
    (a fresh path starts in vacuum)."""
    st["origin"] = res.next_origin
    st["direction"] = res.next_direction
    st["throughput"] = throughput.index_fill(0, lanes, 1.0)
    st["depth"] = st["depth"].index_fill(0, lanes, 0)
    st["prev_spec"] = res.was_specular.index_fill(0, lanes, 0.0)
    st["medium"] = res.next_medium.index_fill(0, lanes, 0.0)
    st["alive"] = refill | survive


def _init_state(rays: Rays, sample, n: int, alive, device, cfg):
    f32 = dict(dtype=torch.float32, device=device)
    return dict(
        origin=rays.origin,
        direction=rays.direction,
        throughput=torch.ones((n, 3), **f32),
        radiance=torch.zeros((n, 3), **f32),
        sample=sample,
        depth=torch.zeros(n, dtype=torch.int32, device=device),
        prev_spec=torch.zeros(n, **f32),  # emit-state code
        medium=torch.zeros((n, medium_width(cfg.features)), **f32),  # vacuum
        alive=alive,
        rays=torch.zeros((), dtype=torch.int64, device=device),
    )


def render_samples_pinned(scene, accum, start_iteration: int, n_iters: int, seed: int, cfg,
                          pixel_offset: int = 0, pixel_stride: int = 1,
                          n_global_pixels=None, tables=None):
    """Pinned-slot wavefront: slot ``i`` is local pixel ``i`` and traces
    iterations ``start_iteration .. start_iteration + n_iters`` of it.
    Returns ``(accum + radiance, rays_traced int64 [])``."""
    n_local = accum.shape[0]
    n_global = n_global_pixels if n_global_pixels is not None else n_local
    device = accum.device
    global_pix = pixel_offset + pixel_stride * torch.arange(n_local, device=device)
    end_iter = start_iteration + n_iters
    it = torch.full((n_local,), start_iteration, dtype=torch.int64, device=device)
    sample = it * n_global + global_pix
    st = _init_state(_spawn(scene, global_pix, sample, seed, cfg), sample, n_local,
                     torch.full((n_local,), n_iters > 0, device=device), device, cfg)
    any_alive = n_iters > 0
    while any_alive:
        res, st["radiance"], throughput, survive = _step(scene, st, seed, cfg, tables)
        # a slot done with its sample moves to the same pixel's next sample
        it_next = it + 1
        refill = st["alive"] & (~survive) & (it_next < end_iter)
        lanes, any_alive = _refill_lanes(refill, survive)
        _continue(st, res, throughput, survive, refill, lanes)
        if lanes.numel():
            it = it.index_copy(0, lanes, it_next[lanes])
            fresh_sample = it[lanes] * n_global + global_pix[lanes]
            fresh = _spawn(scene, global_pix[lanes], fresh_sample, seed, cfg)
            st["sample"] = st["sample"].index_copy(0, lanes, fresh_sample)
            st["origin"] = st["origin"].index_copy(0, lanes, fresh.origin)
            st["direction"] = st["direction"].index_copy(0, lanes, fresh.direction)
    return accum + st["radiance"], st["rays"]


def render_samples_wavefront(scene, accum, start_queue: int, n_samples: int, seed: int, cfg,
                             pixel_offset: int = 0, pixel_stride: int = 1,
                             n_global_pixels=None, tables=None):
    """Free-slot queue engine: trace the camera samples of local queue
    indices ``start_queue .. start_queue + n_samples`` (queue index ``q`` is
    iteration ``q // P`` of local pixel ``q % P``) into ``accum`` (``[P, 3]``
    radiance sum).  Returns ``(accum, rays_traced int64 [])``."""
    n_local = accum.shape[0]
    n_global = n_global_pixels if n_global_pixels is not None else n_local
    device = accum.device
    capacity = min(cfg.wavefront_capacity, n_samples)
    end_queue = start_queue + n_samples

    def spawn(q):
        """queue indices -> (rays, local pixel, global sample)."""
        local_pix = q % n_local
        global_pix = pixel_offset + pixel_stride * local_pix
        sample = (q // n_local) * n_global + global_pix
        return _spawn(scene, global_pix, sample, seed, cfg), local_pix, sample

    first_q = start_queue + torch.arange(capacity, device=device)
    rays0, pixel, sample0 = spawn(first_q)
    st = _init_state(rays0, sample0, capacity, first_q < end_queue, device, cfg)
    planes = [accum[:, c].clone() for c in range(3)]  # the accumulator as 3 [P] planes
    next_queue = torch.full((), start_queue + capacity, dtype=torch.int64, device=device)
    any_alive = capacity > 0
    while any_alive:
        res, radiance, throughput, survive = _step(scene, st, seed, cfg, tables)
        # ended paths: flush their radiance, then refill their slots in
        # rank order from the queue
        dead = st["alive"] & (~survive)
        flush = torch.where(dead[:, None], radiance, 0.0)
        for c in range(3):
            planes[c].index_add_(0, pixel, flush[:, c])
        new_q = next_queue + torch.cumsum(dead.to(torch.int64), dim=0) - 1
        refill = dead & (new_q < end_queue)
        next_queue = next_queue + dead.sum()  # the queue advances past every ended path
        lanes, any_alive = _refill_lanes(refill, survive)
        _continue(st, res, throughput, survive, refill, lanes)
        st["radiance"] = radiance.index_fill(0, lanes, 0.0)
        if lanes.numel():
            fresh, fresh_pix, fresh_sample = spawn(new_q[lanes])
            pixel = pixel.index_copy(0, lanes, fresh_pix)
            st["sample"] = st["sample"].index_copy(0, lanes, fresh_sample)
            st["origin"] = st["origin"].index_copy(0, lanes, fresh.origin)
            st["direction"] = st["direction"].index_copy(0, lanes, fresh.direction)
    return torch.stack(planes, dim=-1), st["rays"]
