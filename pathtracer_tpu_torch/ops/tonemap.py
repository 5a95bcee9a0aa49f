"""HDR accumulator -> displayable image.

Port of ``pathtracer_tpu/ops/tonemap.py``: progressive average, then
gamma ``1/2.2``, clamped to [0, 1].
"""

from __future__ import annotations

import torch

GAMMA = 1.0 / 2.2


def tonemap(accum: torch.Tensor, iterations) -> torch.Tensor:
    """``accum``: ``[..., 3]`` running radiance sum; returns float in [0, 1]."""
    img = torch.clamp(accum / max(float(iterations), 1.0), min=0.0) ** GAMMA
    return torch.clamp(img, 0.0, 1.0)
