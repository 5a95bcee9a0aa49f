"""Render configuration.

Port of ``pathtracer_tpu/config.py``: the same frozen dataclass with the
same fields and defaults, so one set of knobs drives both packages.  Knobs
that select a JAX engine (``pallas``, ``fused``, ``grad_*``, ``wavefront``)
are kept for parity; the port reads only the ones its slices implement
(``max_depth``, ``jitter``, ``nee``, ``russian_roulette``, ``rr_start``,
``seed``, ``fast_rng``, ``features``, ``auto_features``) and refuses the
engines it does not have yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    max_depth: int = 8  # bounces per path
    jitter: bool = True  # supersampled AA
    nee: bool = True  # next-event estimation (direct light sampling)
    vol_nee: bool = True  # direct light at in-medium scatter events
    russian_roulette: bool = False  # RR path termination after rr_start bounces
    rr_start: int = 3
    iters_per_launch: int = 16  # progressive iterations per chunk
    wavefront: bool = False  # wavefront+regeneration engine vs masked megakernel
    wavefront_pinned: bool = True
    wavefront_pinned_max_pixels: int = 1 << 21
    wavefront_capacity: int = 1 << 18
    accum_dtype: str = "float32"  # HDR sum accumulator dtype
    compute_dtype: str = "float32"
    seed: int = 0
    fast_rng: bool = True  # counter-hash RNG (the only RNG the port has)
    pallas: bool | None = None
    fused: bool | None = None
    grad_fused: bool | None = None
    grad_full_trace: bool | None = None
    grad_lean: bool = False
    debug: bool = False
    features: tuple = ("texture", "bump", "volumetric", "glossy")
    # which optional physics blocks the bounce materializes; render()
    # trims it from the material table (render/features.py)
    auto_features: bool = True
