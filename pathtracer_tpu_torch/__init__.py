"""pathtracer_tpu_torch — the path tracer in PyTorch, with CUDA kernels
for the NVIDIA H100.

A port of the JAX package ``pathtracer_tpu`` (which stays the reference):
the same scene DSL, the same ``RenderConfig`` knobs and the same RNGs (the
counter hash, and threefry under ``fast_rng=False``), so one seed gives the
same samples in both.  The
full-depth trace runs as one hand-written CUDA kernel per progressive
iteration (``csrc/trace.cu``); the differentiable render runs a forward
kernel with residuals and a reverse kernel per iteration
(``csrc/trace_grad.cu``).  The wavefront engines
(``RenderConfig(wavefront=True)``) run one bounce per launch
(``csrc/bounce.cu``), or with ``fused=False`` the nearest-hit and occlusion
kernels (``csrc/intersect.cu``) around PyTorch shading.  Triangle meshes
(OBJ files, displacement) render too: inside the trace and per-bounce
kernels up to 4096 triangles, and on the split route through the mesh
kernels (``csrc/mesh.cu``).  On CPU tensors their plain PyTorch versions
run instead.  This package imports neither
JAX nor ``pathtracer_tpu``.

    from pathtracer_tpu_torch import load_scene, render, RenderConfig
    scene = load_scene("scenes/cornell.txt").scene_for_frame(0, device="cuda")
    img, accum, stats = render(scene, spp=16, device="cuda")

    from pathtracer_tpu_torch import loss_and_grad, params_from_description
    params, static = params_from_description(load_scene("scenes/cornell.txt"))
    loss, grads = loss_and_grad(params, static, target, 4, (0, 0), RenderConfig())
"""

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render.diff import (
    SceneParams,
    SceneStatic,
    build_scene,
    l2_loss,
    l2_loss_rays,
    loss_and_grad,
    loss_and_grad_rays,
    params_from_description,
    render_linear,
    render_linear_rays,
)
from pathtracer_tpu_torch.render.integrator import render, render_chunk
from pathtracer_tpu_torch.scene.parser import load_scene, parse_scene_text
from pathtracer_tpu_torch.scene.structs import Camera, Geoms, Materials, Rays, Scene

__all__ = [
    "Camera",
    "Geoms",
    "Materials",
    "Rays",
    "RenderConfig",
    "Scene",
    "SceneParams",
    "SceneStatic",
    "build_scene",
    "l2_loss",
    "l2_loss_rays",
    "load_scene",
    "loss_and_grad",
    "loss_and_grad_rays",
    "params_from_description",
    "parse_scene_text",
    "render",
    "render_chunk",
    "render_linear",
    "render_linear_rays",
]
