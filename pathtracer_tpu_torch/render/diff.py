"""Differentiable rendering: the loss of an image and its gradient with
respect to every scene parameter.

Port of ``pathtracer_tpu/render/diff.py:49-497``.  Transforms are rebuilt
from TRS inside the graph, so gradients reach translations, rotations and
scales; materials and the camera are leaves themselves.  Sampling is
detached (lobe choice, russian roulette, visibility are comparisons); the
throughput, Fresnel weights, emittance, hit points and normals through the
intersection ``t`` carry pathwise gradients.  Gradients come from
``torch.autograd.grad`` over the :class:`SceneParams` leaves; a leaf with
no path to the loss gets zeros, as in JAX's pytree of gradients.

Engines (``diff.py:279-327``), chosen per scene as JAX chooses them:

* a scene in the fused scope runs each progressive iteration on the
  full-depth differentiable trace (``ops/trace_grad.py``: kernels 4 and 5),
  or with ``grad_full_trace=False`` on the per-bounce engine
  (``ops/bounce_grad.py``: kernels 2 with replay planes and 3 per bounce);
  above 8 spp each iteration runs under ``torch.utils.checkpoint``, so one
  iteration's residuals are alive at a time and the backward recomputes
  them with the forward kernels;
* any other scene (``grad_fused=False``) runs each iteration as
  :class:`LeanSample`: the forward is the fast forward engine (kernel 1 on
  the card), the backward re-traces the lean scan (kernels 7 and 8, PyTorch
  shading, a checkpoint per bounce) and returns the scene's cotangents.
  JAX takes this split only on a TPU and runs the lean graph both ways on
  the CPU; the port takes it on every device.

On the card the kernels run, on the CPU their plain versions.  Not ported
yet: meshes and textures as leaves (``mesh_verts`` and ``textures`` raise
when set), the LBVH cache and the sharded variants.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.bounce import check_diff_features, pack_tables
from pathtracer_tpu_torch.ops.rng import key_to_seed
from pathtracer_tpu_torch.ops.trace_grad import fused_diff_eligible
from pathtracer_tpu_torch.ops.transforms import build_transform
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.integrator import render_sample, resolve_device
from pathtracer_tpu_torch.scene.structs import (
    MATERIAL_FIELDS,
    Camera,
    Geoms,
    Materials,
    Scene,
    derive_fov,
)


@dataclasses.dataclass
class SceneParams:
    """Every differentiable leaf of a scene (float32 tensors on one
    device)."""

    materials: Materials
    translations: torch.Tensor  # [G, 3]
    rotations: torch.Tensor  # [G, 3] degrees
    scales: torch.Tensor  # [G, 3]
    cam_position: torch.Tensor  # [3]
    cam_view: torch.Tensor  # [3]
    cam_up: torch.Tensor  # [3]
    cam_fov: torch.Tensor  # [2]
    cam_aperture: torch.Tensor  # []
    cam_focal: torch.Tensor  # []
    mesh_verts: tuple = ()  # mesh vertices as leaves: later slice
    textures: object = None  # texture atlas as a leaf: later slice

    def __post_init__(self):
        if self.mesh_verts or self.textures is not None:
            raise NotImplementedError("mesh vertices and textures as leaves: later slice")

    def leaves(self) -> dict:
        """``{name: tensor}`` of every leaf, materials as ``materials.<field>``."""
        out = {f"materials.{k}": getattr(self.materials, k) for k in MATERIAL_FIELDS}
        for f in dataclasses.fields(self):
            if f.name not in ("materials", "mesh_verts", "textures"):
                out[f.name] = getattr(self, f.name)
        return out

    @classmethod
    def from_leaves(cls, leaves: dict) -> "SceneParams":
        mats = Materials(**{k: leaves[f"materials.{k}"] for k in MATERIAL_FIELDS})
        rest = {k: v for k, v in leaves.items() if not k.startswith("materials.")}
        return cls(materials=mats, **rest)

    @property
    def device(self) -> torch.device:
        return self.translations.device


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """The non-differentiable scene structure."""

    geom_type: tuple  # ints
    geom_material: tuple  # ints
    resolution: tuple  # (width, height)


def params_from_description(desc, frame: int = 0, device="cuda"):
    """SceneDescription -> ``(SceneParams, SceneStatic)`` on ``device``
    (CUDA by default; raises on a host without CUDA unless asked for the
    CPU)."""
    device = resolve_device(device)
    if desc.texture_images or any(t is not None for t in desc.mesh_tris):
        raise NotImplementedError("differentiable meshes and image textures: later slice")

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device).clone()

    mats = Materials(**{k: f32(desc.materials[k]) for k in MATERIAL_FIELDS})
    params = SceneParams(
        materials=mats,
        translations=f32(desc.translations[frame]),
        rotations=f32(desc.rotations[frame]),
        scales=f32(desc.scales[frame]),
        cam_position=f32(desc.eye[frame]),
        cam_view=f32(desc.view[frame]),
        cam_up=f32(desc.up[frame]),
        cam_fov=f32(derive_fov(desc.fovy, desc.resolution[0], desc.resolution[1])),
        cam_aperture=f32(desc.aperture),
        cam_focal=f32(desc.focal_distance),
    )
    static = SceneStatic(
        geom_type=tuple(int(t) for t in desc.geom_type),
        geom_material=tuple(int(m) for m in desc.geom_material),
        resolution=tuple(int(r) for r in desc.resolution),
    )
    return params, static


def build_scene(params: SceneParams, static: SceneStatic) -> Scene:
    """Differentiable scene assembly: TRS -> matrices inside the graph."""
    t, inv = build_transform(params.translations, params.rotations, params.scales)
    dev = params.device
    geoms = Geoms(
        type=torch.tensor(static.geom_type, dtype=torch.int32, device=dev),
        material_id=torch.tensor(static.geom_material, dtype=torch.int32, device=dev),
        transform=t,
        inv_transform=inv,
    )
    cam = Camera(
        resolution=tuple(static.resolution),
        position=params.cam_position,
        view=params.cam_view,
        up=params.cam_up,
        fov=params.cam_fov,
        aperture=params.cam_aperture,
        focal_distance=params.cam_focal,
    )
    return Scene(geoms=geoms, materials=params.materials, camera=cam)


CAMERA_FIELDS = ("position", "view", "up", "fov", "aperture", "focal_distance")


def scene_tensors(scene: Scene) -> list:
    """The float tensors of an analytic scene that gradients reach: the
    transforms, every material field and the camera's."""
    return [scene.geoms.transform, scene.geoms.inv_transform,
            *(getattr(scene.materials, k) for k in MATERIAL_FIELDS),
            *(getattr(scene.camera, k) for k in CAMERA_FIELDS)]


def scene_with_tensors(scene: Scene, tensors) -> Scene:
    """``scene`` with :func:`scene_tensors`' tensors replaced, in order."""
    tensors = list(tensors)
    nm = len(MATERIAL_FIELDS)
    geoms = dataclasses.replace(scene.geoms, transform=tensors[0], inv_transform=tensors[1])
    mats = Materials(**dict(zip(MATERIAL_FIELDS, tensors[2:2 + nm])))
    cam = dataclasses.replace(scene.camera, **dict(zip(CAMERA_FIELDS, tensors[2 + nm:])))
    return dataclasses.replace(scene, geoms=geoms, materials=mats, camera=cam)


class LeanSample(torch.autograd.Function):
    """One progressive iteration of the lean engine (``diff.py:299-321``):
    ``(radiance [N, 3], rays_traced)`` of ``render_sample`` under
    ``cfg_fwd`` (the fast forward: kernel 1 on the card), with the backward
    re-tracing the lean scan under ``cfg_bwd`` and differentiating it
    (``torch.autograd.grad`` at the lean forward's values, equal to the fast
    forward's a.e.).  Its differentiable inputs are :func:`scene_tensors`."""

    @staticmethod
    def forward(ctx, scene, pixel_index, iteration, seed, cfg_fwd, cfg_bwd, *tensors):
        scene = scene_with_tensors(scene, tensors)
        radiance, nrays = render_sample(scene, pixel_index, iteration, seed, cfg_fwd,
                                        tables=pack_tables(scene))
        ctx.save_for_backward(pixel_index, *tensors)
        ctx.scene, ctx.iteration, ctx.seed, ctx.cfg_bwd = scene, iteration, seed, cfg_bwd
        ctx.mark_non_differentiable(nrays)
        return radiance, nrays

    @staticmethod
    def backward(ctx, g_rad, _g_nrays):
        pixel_index, *tensors = ctx.saved_tensors
        needs = ctx.needs_input_grad[6:]
        leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
        wanted = [x for x in leaves if x.requires_grad]
        with torch.enable_grad():
            scene = scene_with_tensors(ctx.scene, leaves)
            radiance, _ = render_sample(scene, pixel_index, ctx.iteration, ctx.seed,
                                        ctx.cfg_bwd, tables=pack_tables(scene))
            grads = iter(torch.autograd.grad(radiance, wanted, g_rad, allow_unused=True))
        return (None,) * 6 + tuple(next(grads) if x.requires_grad else None for x in leaves)


def render_linear_rays(params: SceneParams, static: SceneStatic, spp: int, base_key,
                       cfg: RenderConfig):
    """Differentiable linear (pre-tonemap) image ``[N, 3]``, the mean of
    ``spp`` progressive samples, plus the measured int64 number of rays of
    one forward pass (primary, bounce and shadow rays).  Linear, because
    the gamma curve has an unbounded gradient at 0.  ``cfg.features`` is
    trimmed to the materials' needs, as every render entry point does; the
    engine is chosen as the module docstring says."""
    cfg = resolve_features(cfg, params.materials)
    check_diff_features(cfg.features)  # media are forward only: every engine refuses them
    cfg_bwd = dataclasses.replace(cfg, fused=False, grad_lean=True, debug=False)
    scene = build_scene(params, static)
    seed = key_to_seed(base_key)
    w, h = static.resolution
    pixel_index = torch.arange(w * h, dtype=torch.int64, device=params.device)
    if fused_diff_eligible(scene, cfg_bwd):
        tables = pack_tables(scene)

        def sample(it):
            if spp > 8:
                return checkpoint(render_sample, scene, pixel_index, it, seed, cfg_bwd,
                                  tables=tables, use_reentrant=False, preserve_rng_state=False)
            return render_sample(scene, pixel_index, it, seed, cfg_bwd, tables=tables)
    else:
        cfg_fwd = dataclasses.replace(cfg, grad_lean=False, debug=False)

        def sample(it):
            return LeanSample.apply(scene, pixel_index, it, seed, cfg_fwd, cfg_bwd,
                                    *scene_tensors(scene))
    total = torch.zeros((w * h, 3), dtype=torch.float32, device=params.device)
    rays = torch.zeros((), dtype=torch.int64, device=params.device)
    for it in range(spp):
        radiance, n = sample(it)
        total = total + radiance
        rays = rays + n
    return total / spp, rays


def render_linear(params, static, spp, base_key, cfg) -> torch.Tensor:
    """:func:`render_linear_rays` without the ray count."""
    return render_linear_rays(params, static, spp, base_key, cfg)[0]


def l2_loss_rays(params, static, target, spp, base_key, cfg):
    """``(MSE against the target linear image [N, 3], measured rays)``."""
    img, rays = render_linear_rays(params, static, spp, base_key, cfg)
    return torch.mean((img - target) ** 2), rays


def l2_loss(params, static, target, spp, base_key, cfg) -> torch.Tensor:
    """Mean squared error against a target linear image ``[N, 3]``."""
    return l2_loss_rays(params, static, target, spp, base_key, cfg)[0]


def loss_and_grad_rays(params, static, target, spp, base_key, cfg, device="cuda"):
    """``(loss, grads, rays)``: the loss, its gradient as a
    :class:`SceneParams` of tensors (zeros for a leaf the loss does not
    reach), and the measured rays of one forward pass, the count behind
    ``bench.py``'s fwd+bwd Mrays/s (the backward is not counted again).
    Runs on ``device``, where ``params`` and ``target`` must live."""
    device = resolve_device(device)
    if params.device.type != device.type or device.index not in (None, params.device.index):
        raise ValueError(f"params are on {params.device}, loss_and_grad asked for {device}")
    names, values = zip(*params.leaves().items())
    leaves = [v.detach().requires_grad_(True) for v in values]
    p = SceneParams.from_leaves(dict(zip(names, leaves)))
    with torch.enable_grad():
        loss, rays = l2_loss_rays(p, static, target, spp, base_key, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return loss.detach(), SceneParams.from_leaves(dict(zip(names, grads))), rays


def loss_and_grad(params, static, target, spp, base_key, cfg, device="cuda"):
    """``(loss, dloss/dparams)`` on one device."""
    loss, grads, _ = loss_and_grad_rays(params, static, target, spp, base_key, cfg, device)
    return loss, grads
