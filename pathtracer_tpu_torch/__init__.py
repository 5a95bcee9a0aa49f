"""pathtracer_tpu_torch — the path tracer in PyTorch, with CUDA kernels
for the NVIDIA H100.

A port of the JAX package ``pathtracer_tpu`` (which stays the reference):
the same scene DSL, the same ``RenderConfig`` knobs and the same
counter-hash RNG, so one seed gives the same samples in both.  The
full-depth trace runs as one hand-written CUDA kernel per progressive
iteration (``csrc/trace.cu``); on CPU tensors its plain PyTorch version
runs instead.  This package imports neither JAX nor ``pathtracer_tpu``.

    from pathtracer_tpu_torch import load_scene, render, RenderConfig
    scene = load_scene("scenes/cornell.txt").scene_for_frame(0, device="cuda")
    img, accum, stats = render(scene, spp=16, device="cuda")
"""

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene

__all__ = ["RenderConfig", "load_scene", "render"]
