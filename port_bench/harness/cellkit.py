"""What the entries share: keys from the seed, the scene text, the 8-bit
readout, the sampled pixels and the numbers the check compares."""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def key_of(seed: int, stream: int = 0) -> tuple:
    """The two-word key of ``stream`` (0: a render's; 1: a target's;
    ``2 + s``: gradient step ``s``'s) for the run's ``--seed``."""
    return (((seed >> 32) + stream * GOLDEN) & MASK32, seed & MASK32)


def scene_text(config: dict) -> str:
    return "\n".join(config["scene"]) + "\n"


def render_settings(workload: dict, config: dict) -> dict:
    """The ``RenderConfig`` fields a cell runs with: the configuration's
    ``render`` block, with the workload's own ``render`` object (an engine
    choice is traffic) merged over it."""
    return {**config["render"], **workload.get("render", {})}


def to8(img):
    """``[..., 3]`` floats in [0, 1] -> uint8, truncating, on their device."""
    return (img * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def sample_pixels(seed: int, n_pixels: int, k: int):
    """``k`` distinct pixel indices drawn from the seed (CPU int64)."""
    g = torch.Generator().manual_seed(seed & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(n_pixels, generator=g)[:k]


def share_differing(a, b) -> float:
    """The share of pixels (rows of ``[N, 3]``) whose values differ."""
    return float((a.reshape(-1, 3) != b.reshape(-1, 3)).any(-1).double().mean())


def rel_gap(a: float, b: float) -> float:
    """``|a - b| / |b|``; 0 where both are 0, inf where only ``b`` is."""
    if a == b:
        return 0.0
    return abs(a - b) / abs(b) if b != 0 else math.inf


def max_gap(a, b) -> float:
    """The widest entry-wise gap of ``a`` from ``b`` over ``b``'s mean magnitude."""
    a, b = a.double(), b.double()
    scale = float(b.abs().mean())
    gap = float((a - b).abs().max())
    return gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)


def trace_context(config: dict, settings: dict, w: int, h: int, spp: int, rays: int) -> dict:
    """What the per-layer readers know of a traced stretch: the samples per
    pixel and rays it completed, and the scene's geoms and engine settings as
    the reference's parser reads them."""
    from port_bench.reference.drive import is_volumetric
    from port_bench.reference.scene import parse

    sc = parse(scene_text(config), (w, h))
    return dict(spp=spp, pixels=w * h, rays=rays, geom_types=sc["types"],
                n_materials=len(sc["materials"]["emittance"]), nee=settings["nee"],
                vol=is_volumetric(sc), depth=settings["max_depth"])


def checks(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}``; a number that is not finite fails."""
    out = {}
    for name, v in values.items():
        v = float(v)
        out[name] = {"value": v if math.isfinite(v) else 1e300, "limit": float(limits[name])}
    return out
