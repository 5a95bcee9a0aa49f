"""Plain reference: progressive renders and the loss's gradient, in blocks.

``render_pixels`` sums the radiance of chosen pixels over chosen progressive
iterations, one iteration after another in order from zero, as a
progressive renderer's accumulator does; the paths of many (pixel,
iteration) pairs are traced together, in blocks of lanes.
``loss_and_grad`` differentiates the mean squared error of a ``spp``-sample
linear image against a target with ``torch.autograd`` through the plain
path tracer of ``plain.py``, block of pixels by block of pixels, so that its
graph fits; ``render_linear`` is its forward alone.  Imports nothing of the
program under test.
"""

from __future__ import annotations

import torch

from port_bench.reference import plain
from port_bench.reference.scene import tables


def camera_of(lv: dict) -> dict:
    return dict(position=lv["cam_position"], view=lv["cam_view"], up=lv["cam_up"],
                fov=lv["cam_fov"], aperture=lv["cam_aperture"], focal=lv["cam_focal"])


def trace_opts(cfg: dict, vol: bool) -> dict:
    return dict(max_depth=int(cfg["max_depth"]), nee=bool(cfg["nee"]), vol=vol,
                vol_nee=bool(cfg["vol_nee"]))


def scene_tables(sc: dict, lv: dict, dt=torch.float32):
    """The scene's tables in ``dt`` and the host values the sweeps read.
    Matrix products stay in float32 (``plain.rows``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tabs = tuple(t.to(dt) for t in tables(lv, sc["types"], sc["mat_ids"]))
    return tabs, plain.table_info(tabs)


def is_volumetric(sc: dict) -> bool:
    m = sc["materials"]
    return bool((m["has_scatter"] > 0).any() or (m["absorption_coefficient"] > 0).any())


def _radiance(sc, lv, tabs, info, pix, its, seed, cfg, dt):
    """Radiance ``[len(its), len(pix), 3]`` and rays of every (iteration,
    pixel) pair, traced together."""
    cam = sc["camera"]
    lane_pix = pix.repeat(len(its))
    lane_it = torch.tensor(list(its), dtype=torch.int64, device=pix.device).repeat_interleave(
        pix.shape[0])
    o, d, sidx = plain.camera_rays(camera_of(lv), cam["width"], cam["height"], lane_pix, lane_it,
                                   seed, dt, jitter=bool(cfg["jitter"]))
    rad, n = plain.trace(tabs, info, seed, o, d, sidx, **trace_opts(cfg, is_volumetric(sc)))
    return rad.reshape(len(its), pix.shape[0], 3), n


def render_pixels(sc: dict, lv: dict, pixel, iterations, key, cfg: dict, dt=torch.float32,
                  lanes: int = 1 << 20):
    """``(accum [K, 3] in dt, rays int)``: the radiance of ``pixel`` summed
    over ``iterations`` in order from zero, and the rays traced; about
    ``lanes`` paths traced at a time."""
    seed = plain.key_seed(key)
    iterations = list(iterations)
    out = torch.zeros((pixel.shape[0], 3), dtype=dt, device=pixel.device)
    rays = 0
    with torch.no_grad():
        tabs, info = scene_tables(sc, lv, dt)
        per = max(1, lanes // max(1, len(iterations)))
        for lo in range(0, pixel.shape[0], per):
            pix = pixel[lo:lo + per]
            acc = torch.zeros((pix.shape[0], 3), dtype=dt, device=pix.device)
            step = max(1, lanes // pix.shape[0])
            for i0 in range(0, len(iterations), step):
                rad, n = _radiance(sc, lv, tabs, info, pix, iterations[i0:i0 + step], seed, cfg,
                                   dt)
                for r in rad:
                    acc = acc + r
                rays += int(n)
            out[lo:lo + per] = acc
    return out, rays


def render_linear(sc: dict, lv: dict, spp: int, key, cfg: dict):
    """The ``spp``-sample linear image ``[W * H, 3]`` (float32), no graph."""
    cam = sc["camera"]
    pixel = torch.arange(cam["width"] * cam["height"], device=lv["translations"].device)
    acc, _ = render_pixels(sc, lv, pixel, range(spp), key, cfg)
    return acc / spp


def loss_and_grad(sc: dict, lv: dict, target, spp: int, key, cfg: dict, dt=torch.float32,
                  lanes: int = 1 << 20):
    """``(loss, {leaf: gradient})`` of ``mean((image - target) ** 2)`` over
    every pixel and channel, ``image`` the mean of ``spp`` samples; the
    gradients of every leaf of ``lv`` (float32 leaves; ``dt`` the working
    type of the trace).  The loss is summed over blocks of about ``lanes``
    paths, each block's graph freed after its backward."""
    cam = sc["camera"]
    n_pix = cam["width"] * cam["height"]
    seed = plain.key_seed(key)
    names = list(lv)
    leaves = [lv[k].detach().requires_grad_(True) for k in names]
    grads = [torch.zeros_like(x) for x in leaves]
    loss = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    block = max(1, lanes // spp)
    with torch.enable_grad():
        for lo in range(0, n_pix, block):
            live = dict(zip(names, leaves))
            tabs, info = scene_tables(sc, live, dt)
            pix = torch.arange(lo, min(lo + block, n_pix), device=leaves[0].device)
            rad, _ = _radiance(sc, live, tabs, info, pix, range(spp), seed, cfg, dt)
            total = torch.zeros((pix.shape[0], 3), dtype=dt, device=pix.device)
            for r in rad:
                total = total + r
            img = (total / spp).float()
            part = torch.sum((img - target[lo:lo + block]) ** 2) / (n_pix * 3)
            got = torch.autograd.grad(part, leaves, allow_unused=True)
            grads = [a if g is None else a + g for a, g in zip(grads, got)]
            loss = loss + part.detach().double()
    return float(loss), dict(zip(names, grads))
