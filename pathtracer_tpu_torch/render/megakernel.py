"""Masked megakernel path integrator: the trace of one wavefront.

Port of ``pathtracer_tpu/render/megakernel.py:28-175``.  The forward takes
the full-depth trace of ``ops/trace.py`` (``:44-64`` in the JAX package);
under ``cfg.grad_lean`` an eligible scene takes the full-depth
differentiable trace of ``ops/trace_grad.py`` (``:66-76``).  Each runs its
CUDA kernels for rays on a CUDA device and its plain version for rays on
the CPU.  The per-bounce differentiable engine (``grad_full_trace=False``),
the lean scan, the debug and the wavefront variants belong to later
slices.
"""

from __future__ import annotations

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.trace import trace_fused
from pathtracer_tpu_torch.ops.trace_grad import fused_diff_eligible, trace_fused_diff
from pathtracer_tpu_torch.scene.structs import Rays, Scene


def trace_paths(
    scene: Scene, rays: Rays, sample_idx, seed: int, cfg: RenderConfig, tables=None
):
    """Trace a wavefront of primary rays to completion: ``(radiance [N, 3],
    rays_traced int64 [])``, one sample of the estimator per ray."""
    if cfg.debug or cfg.wavefront:
        raise NotImplementedError("debug / wavefront engines of trace_paths: later slice")
    if cfg.grad_lean:
        if not fused_diff_eligible(scene, cfg):
            raise NotImplementedError(
                "lean differentiable scan for scenes outside the fused trace: later slice"
            )
        if cfg.grad_full_trace is False:
            raise NotImplementedError(
                "per-bounce differentiable engine (grad_full_trace=False): later slice"
            )
        return trace_fused_diff(scene, rays, sample_idx, seed, cfg, tables=tables)
    return trace_fused(scene, rays, sample_idx, seed, cfg, tables=tables)
