"""Masked megakernel path integrator: the trace of one wavefront.

Port of ``pathtracer_tpu/render/megakernel.py:28-175`` for the forward
engine.  The JAX function dispatches to the full-depth trace kernel on a
TPU (``:44-64``); here :func:`trace_paths` always takes the full-depth
trace of ``ops/trace.py``, which runs the CUDA kernel for rays on a CUDA
device and its plain version for rays on the CPU.  The lean, debug and scan
variants belong to later slices.
"""

from __future__ import annotations

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.trace import trace_fused
from pathtracer_tpu_torch.scene.structs import Rays, Scene


def trace_paths(
    scene: Scene, rays: Rays, sample_idx, seed: int, cfg: RenderConfig, tables=None
):
    """Trace a wavefront of primary rays to completion: ``(radiance [N, 3],
    rays_traced int64 [])``, one sample of the estimator per ray."""
    if cfg.grad_lean or cfg.debug or cfg.wavefront:
        raise NotImplementedError(
            "grad_lean / debug / wavefront engines of trace_paths: later slice"
        )
    return trace_fused(scene, rays, sample_idx, seed, cfg, tables=tables)
