"""Differentiable rendering: the loss of an image and its gradient with
respect to every scene parameter.

Port of ``pathtracer_tpu/render/diff.py:49-497``.  Transforms are rebuilt
from TRS inside the graph, so gradients reach translations, rotations and
scales; materials, the camera and each mesh's object-space vertices
(``SceneParams.mesh_verts``) are leaves themselves.  Sampling is
detached (lobe choice, russian roulette, visibility are comparisons); the
throughput, Fresnel weights, emittance, hit points and normals through the
intersection ``t`` carry pathwise gradients.  A scene's image textures
are a leaf too: ``SceneParams.textures`` holds the atlas, whose texels
(``textures.data``) take gradients (inverse texture painting) and whose
slot sizes (``textures.hw``) stay static.  Gradients come from
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
* any other scene (``grad_fused=False``, ``fast_rng=False``, and every mesh
  scene, as JAX's ``fused_diff_eligible`` excludes meshes) runs each
  iteration as
  :class:`LeanSample`: the backward re-traces the lean scan (kernels 7 and
  8, and 9 and 10 per mesh, detached; PyTorch shading, a checkpoint per
  bounce) and returns the scene's cotangents.  On a scene of the fused
  scope (``grad_fused=False`` chosen by the caller) the forward is the
  forward with residuals (kernel 4 on the card), which keeps each
  bounce's winner, NEE bit and entering ray, and the re-trace replays
  them; on the others the forward is the fast forward engine (kernel 1 for
  hg media, 1m for meshes up to 4096 triangles; above that and with image
  textures the per-bounce scan on kernel 2's mesh-merge and deferred-texel
  variants; under ``fast_rng=False`` the scan on the split route, kernels 6
  and 8) and the re-trace runs its own searches.  JAX takes this split only on a TPU and
  runs the lean graph both ways on the CPU; the port takes it on every
  device.

Meshes: a mesh of at least ``ACCEL_MIN_TRIS`` triangles gets an LBVH built
once over its initial vertices (``_ACCEL_CACHE``, keyed by a hash of
them); every :func:`build_scene` rebinds it to the live vertices
(``ops/accel.refresh_accel``), so a vertex that moves far is never missed
(the stale Morton order only loosens the chunk boxes).  Authored normals
and UVs do not enter differentiable mode, as in JAX.

Features (``ops/bounce.check_diff_features``): the full-depth and
per-bounce engines differentiate the base lobes, ``volumetric`` media (with
or without ``vol_nee``) and the surface features (``texture``, ``bump``,
``microfacet``, ``ward``), on their kernels' volumetric instances (4v and
5v, 2r-v and 3v) and surface instances (4s and 5s, 2r-s and 3s); the lean
engine differentiates those and ``hg``, on analytic scenes and with meshes.
A scene with ``hg`` or image textures takes the lean engine, as in JAX;
its forward is the fast forward engine (on an image-textured scene the
per-bounce scan on kernel 2's deferred-texel variant, 2t).

On the card the kernels run, on the CPU their plain versions.
:func:`loss_and_grad_sharded` splits the pixels over the shards of a
``parallel/mesh.Mesh`` (``diff.py:500-557``); each shard runs the engine
above on its strided pixels.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.accel import build_mesh_accel, refresh_accel
from pathtracer_tpu_torch.ops.bounce import check_diff_features, pack_tables
from pathtracer_tpu_torch.ops.camera import CAMERA_FIELDS
from pathtracer_tpu_torch.ops.rng import KeyedSeed
from pathtracer_tpu_torch.ops.texture import TextureAtlas, build_atlas
from pathtracer_tpu_torch.ops.trace_grad import fused_diff_eligible, replay_scope, trace_replay
from pathtracer_tpu_torch.ops.transforms import build_transform
from pathtracer_tpu_torch.render.features import resolve_features
from pathtracer_tpu_torch.render.integrator import camera_sample, render_sample, resolve_device
from pathtracer_tpu_torch.scene.structs import (
    ACCEL_MIN_TRIS,
    MATERIAL_FIELDS,
    Camera,
    Geoms,
    Materials,
    MeshInstance,
    Scene,
    derive_fov,
)
from pathtracer_tpu_torch.utils.metrics import span


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
    # per mesh geom its [T, 3, 3] object-space vertices (file order): the
    # gradients reach them and, through TRS, the instance's transform
    mesh_verts: tuple = ()
    # the image textures' ops/texture.TextureAtlas, or None: its texels
    # ``data`` [K, H, W, 3] are a leaf, its slot sizes ``hw`` static
    textures: object = None

    def __post_init__(self):
        self.mesh_verts = tuple(self.mesh_verts)

    def leaves(self) -> dict:
        """``{name: tensor}`` of every leaf, materials as ``materials.<field>``,
        the meshes' vertices as ``mesh_verts.<k>`` and the atlas's texels as
        ``textures.data``."""
        out = {f"materials.{k}": getattr(self.materials, k) for k in MATERIAL_FIELDS}
        for f in dataclasses.fields(self):
            if f.name not in ("materials", "mesh_verts", "textures"):
                out[f.name] = getattr(self, f.name)
        out.update({f"mesh_verts.{k}": v for k, v in enumerate(self.mesh_verts)})
        if self.textures is not None:
            out["textures.data"] = self.textures.data
        return out

    @classmethod
    def from_leaves(cls, leaves: dict, textures_hw=None) -> "SceneParams":
        """The inverse of :meth:`leaves`; ``textures_hw`` is the atlas's
        slot sizes when the leaves hold ``textures.data``."""
        mats = Materials(**{k: leaves[f"materials.{k}"] for k in MATERIAL_FIELDS})
        verts = [v for k, v in leaves.items() if k.startswith("mesh_verts.")]
        tex = leaves.get("textures.data")
        rest = {k: v for k, v in leaves.items()
                if not k.startswith(("materials.", "mesh_verts.", "textures."))}
        return cls(materials=mats, mesh_verts=tuple(verts),
                   textures=None if tex is None else TextureAtlas(data=tex, hw=textures_hw),
                   **rest)

    @property
    def device(self) -> torch.device:
        return self.translations.device


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """The non-differentiable scene structure."""

    geom_type: tuple  # ints
    geom_material: tuple  # ints
    resolution: tuple  # (width, height)
    mesh_geom_indices: tuple = ()  # the geom slot of each mesh_verts entry
    # per mesh_verts entry its key into _ACCEL_CACHE, or None (no LBVH)
    mesh_accel_keys: tuple = ()


# LBVHs built on the host over the initial vertices of the differentiable
# meshes, keyed by a hash of them (SceneStatic stays hashable).  Only their
# Morton grouping (scan_to_file) is used: build_scene rebinds the triangle
# copies and boxes to the live vertices (ops/accel.refresh_accel).
_ACCEL_CACHE: dict = {}


def _accel_key_for(verts) -> str:
    """Content key of a ``[T, 3, 3]`` vertex array (``diff.py:102-107``)."""
    a = np.ascontiguousarray(np.asarray(verts, np.float32))
    return f"{a.shape[0]}-{hashlib.sha1(a.tobytes()).hexdigest()[:16]}"


def params_from_description(desc, frame: int = 0, device="cuda", accel: bool = True):
    """SceneDescription -> ``(SceneParams, SceneStatic)`` on ``device``
    (CUDA by default; raises on a host without CUDA unless asked for the
    CPU).  ``accel=True`` builds the LBVH of each mesh of at least
    ``ACCEL_MIN_TRIS`` triangles over its initial vertices (``diff.py:
    110-183``); the image textures' atlas is built on ``device``."""
    device = resolve_device(device)
    mesh_tris = desc.mesh_tris_for_frame(frame)
    keys = []
    for t in mesh_tris:
        if t is None:
            continue
        if not accel or len(t) < ACCEL_MIN_TRIS:
            keys.append(None)
            continue
        key = _accel_key_for(t)
        if key not in _ACCEL_CACHE:
            _ACCEL_CACHE[key] = build_mesh_accel(t, device="cpu")
        keys.append(key)

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
        mesh_verts=tuple(f32(t) for t in mesh_tris if t is not None),
        textures=build_atlas(desc.texture_images, device=device) if desc.texture_images else None,
    )
    static = SceneStatic(
        geom_type=tuple(int(t) for t in desc.geom_type),
        geom_material=tuple(int(m) for m in desc.geom_material),
        resolution=tuple(int(r) for r in desc.resolution),
        mesh_geom_indices=tuple(g for g, t in enumerate(mesh_tris) if t is not None),
        mesh_accel_keys=tuple(keys),
    )
    return params, static


def _mesh_accel(key, verts):
    """The cached LBVH of ``key`` rebound to ``verts``, or None (no key, or
    a cold cache: the mesh then takes kernels 9 and 10 up to 8192 triangles,
    as JAX degrades to its dense sweep)."""
    cached = _ACCEL_CACHE.get(key) if key else None
    return None if cached is None else refresh_accel(cached, verts)


def build_scene(params: SceneParams, static: SceneStatic) -> Scene:
    """Differentiable scene assembly: TRS -> matrices inside the graph; the
    meshes take their live vertices and their LBVH rebound to them, the
    scene the live atlas."""
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
    keys = static.mesh_accel_keys or (None,) * len(static.mesh_geom_indices)
    meshes = tuple(MeshInstance(geom_index=g, tri_verts=v, accel=_mesh_accel(k, v))
                   for g, v, k in zip(static.mesh_geom_indices, params.mesh_verts, keys))
    return Scene(geoms=geoms, materials=params.materials, camera=cam, meshes=meshes,
                 textures=params.textures)


def scene_tensors(scene: Scene) -> list:
    """The float tensors of a scene that gradients reach: the transforms,
    every material field, the camera's, each mesh's vertices and the
    atlas's texels."""
    return [scene.geoms.transform, scene.geoms.inv_transform,
            *(getattr(scene.materials, k) for k in MATERIAL_FIELDS),
            *(getattr(scene.camera, k) for k in CAMERA_FIELDS),
            *(m.tri_verts for m in scene.meshes),
            *(() if scene.textures is None else (scene.textures.data,))]


def scene_with_tensors(scene: Scene, tensors) -> Scene:
    """``scene`` with :func:`scene_tensors`' tensors replaced, in order; a
    mesh's LBVH is rebound to its new vertices."""
    tensors = list(tensors)
    nm, nc = len(MATERIAL_FIELDS), len(CAMERA_FIELDS)
    geoms = dataclasses.replace(scene.geoms, transform=tensors[0], inv_transform=tensors[1])
    mats = Materials(**dict(zip(MATERIAL_FIELDS, tensors[2:2 + nm])))
    cam = dataclasses.replace(scene.camera, **dict(zip(CAMERA_FIELDS, tensors[2 + nm:2 + nm + nc])))
    mesh_end = 2 + nm + nc + len(scene.meshes)
    meshes = tuple(
        dataclasses.replace(m, tri_verts=v,
                            accel=None if m.accel is None else refresh_accel(m.accel, v))
        for m, v in zip(scene.meshes, tensors[2 + nm + nc:mesh_end]))
    textures = (None if scene.textures is None
                else dataclasses.replace(scene.textures, data=tensors[mesh_end]))
    return dataclasses.replace(scene, geoms=geoms, materials=mats, camera=cam, meshes=meshes,
                               textures=textures)


def lean_forward(scene, pixel_index, iteration: int, seed: int, cfg_fwd, tables=None,
                 n_global_pixels=None):
    """The lean engine's forward of one iteration: ``(radiance [N, 3],
    rays_traced, replay)``.  In the fused scope (``ops/trace_grad.
    replay_scope``) it is ``trace_replay`` (kernel 4 on the card) and
    ``replay`` the ``(gid, nee, ray)`` planes its backward replays;
    elsewhere the fast forward engine (``render_sample``: kernel 1, 1m, or
    the scan on 2mm or 2t) and ``replay`` None.  ``n_global_pixels`` keys
    the samples as :func:`render_sample` does."""
    if not replay_scope(scene, cfg_fwd):
        return (*render_sample(scene, pixel_index, iteration, seed, cfg_fwd, tables=tables,
                               n_global_pixels=n_global_pixels), None)
    rays, sample_idx = camera_sample(scene, pixel_index, iteration, seed, cfg_fwd,
                                     n_global_pixels)
    radiance, nrays, *replay = trace_replay(scene, rays, sample_idx, seed, cfg_fwd,
                                            tables=tables)
    return radiance, nrays, tuple(replay)


class LeanSample(torch.autograd.Function):
    """One progressive iteration of the lean engine (``diff.py:299-321``):
    ``(radiance [N, 3], rays_traced)`` of :func:`lean_forward` under
    ``cfg_fwd``, with the backward re-tracing the lean scan under
    ``cfg_bwd`` and differentiating it (``torch.autograd.grad``).  In the
    fused scope the forward's winners, NEE bits and the rays entering each
    bounce (27 bytes per lane-bounce) are saved and the re-trace replays
    them, so it differentiates the paths the forward counted at the
    forward's values; elsewhere the re-trace runs its own searches, whose
    last bits may part from the forward kernel's on a few lanes (ROADMAP
    queue 3).  ``n_global`` keys the samples (:func:`render_sample`'s
    ``n_global_pixels``).  Its differentiable inputs are
    :func:`scene_tensors`."""

    @staticmethod
    def forward(ctx, scene, pixel_index, iteration, seed, cfg_fwd, cfg_bwd, n_global, *tensors):
        scene = scene_with_tensors(scene, tensors)
        radiance, nrays, replay = lean_forward(scene, pixel_index, iteration, seed, cfg_fwd,
                                               tables=pack_tables(scene),
                                               n_global_pixels=n_global)
        replay = replay or ()
        ctx.save_for_backward(pixel_index, *replay, *tensors)
        ctx.n_replay = len(replay)
        ctx.scene, ctx.iteration, ctx.seed, ctx.cfg_bwd = scene, iteration, seed, cfg_bwd
        ctx.n_global = n_global
        ctx.mark_non_differentiable(nrays)
        return radiance, nrays

    @staticmethod
    def backward(ctx, g_rad, _g_nrays):
        pixel_index, *rest = ctx.saved_tensors
        replay, tensors = tuple(rest[:ctx.n_replay]), rest[ctx.n_replay:]
        needs = ctx.needs_input_grad[7:]
        leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
        wanted = [x for x in leaves if x.requires_grad]
        with torch.enable_grad():
            scene = scene_with_tensors(ctx.scene, leaves)
            radiance, _ = render_sample(scene, pixel_index, ctx.iteration, ctx.seed,
                                        ctx.cfg_bwd, tables=pack_tables(scene),
                                        replay=replay or None, n_global_pixels=ctx.n_global)
            grads = iter(torch.autograd.grad(radiance, wanted, g_rad, allow_unused=True))
        return (None,) * 7 + tuple(next(grads) if x.requires_grad else None for x in leaves)


def lean_cfgs(cfg: RenderConfig, materials):
    """``(cfg_fwd, cfg_bwd)`` of the lean engine for ``cfg``: the forward's
    and the backward's re-trace (the lean split route), features
    resolved."""
    cfg = resolve_features(cfg, materials)
    return (dataclasses.replace(cfg, grad_lean=False, debug=False),
            dataclasses.replace(cfg, fused=False, grad_lean=True, debug=False))


def _pixels(static: SceneStatic, pixel_index, device):
    """The pixels to render: ``pixel_index`` as int64 on ``device``, or
    every pixel of the image when it is None."""
    if pixel_index is None:
        w, h = static.resolution
        return torch.arange(w * h, dtype=torch.int64, device=device)
    return torch.as_tensor(pixel_index, device=device).to(torch.int64)


def lean_parted(params: SceneParams, static: SceneStatic, iteration: int, base_key,
                cfg: RenderConfig, pixel_index=None, n_global_pixels=None):
    """The pixels whose lean re-trace parts from the lean forward in one
    iteration, a check's measure: ``(parted [N] bool, forward radiance,
    re-trace radiance)``, detached, over ``pixel_index`` (every pixel when
    None; ``n_global_pixels`` as :func:`render_linear_rays` takes it).  The
    re-trace replays the forward where the engine does; a pixel parts where
    the two radiances differ beyond float32 rounding (1e-4 of 1 + the
    forward's)."""
    cfg_fwd, cfg_bwd = lean_cfgs(cfg, params.materials)
    scene = build_scene(params, static)
    seed = KeyedSeed(base_key)
    pix = _pixels(static, pixel_index, params.device)
    tables = pack_tables(scene)
    with torch.no_grad():
        fwd, _, replay = lean_forward(scene, pix, iteration, seed, cfg_fwd, tables=tables,
                                      n_global_pixels=n_global_pixels)
        back, _ = render_sample(scene, pix, iteration, seed, cfg_bwd, tables=tables,
                                replay=replay, n_global_pixels=n_global_pixels)
    return ((fwd - back).abs() > 1e-4 * (1.0 + fwd.abs())).any(-1), fwd, back


def render_linear_rays(params: SceneParams, static: SceneStatic, spp: int, base_key,
                       cfg: RenderConfig, pixel_index=None, n_global_pixels=None):
    """Differentiable linear (pre-tonemap) image ``[N, 3]``, the mean of
    ``spp`` progressive samples, plus the measured int64 number of rays of
    one forward pass (primary, bounce and shadow rays).  Linear, because
    the gamma curve has an unbounded gradient at 0.  ``cfg.features`` is
    trimmed to the materials' needs, as every render entry point does; the
    engine is chosen as the module docstring says.  ``pixel_index`` lists
    the pixels to render (every pixel when None), and ``n_global_pixels``
    the image's pixel count that keys their samples (``diff.py:243-400``):
    the rows of a strided subset equal those rows of the whole image."""
    cfg_fwd, cfg_bwd = lean_cfgs(cfg, params.materials)
    check_diff_features(cfg_bwd.features, "lean")  # each engine checks its own features
    scene = build_scene(params, static)
    seed = KeyedSeed(base_key)
    pixel_index = _pixels(static, pixel_index, params.device)
    n_glob = n_global_pixels
    if fused_diff_eligible(scene, cfg_bwd):
        tables = pack_tables(scene)

        def sample(it):
            if spp > 8:
                return checkpoint(render_sample, scene, pixel_index, it, seed, cfg_bwd,
                                  tables=tables, n_global_pixels=n_glob, use_reentrant=False,
                                  preserve_rng_state=False)
            return render_sample(scene, pixel_index, it, seed, cfg_bwd, tables=tables,
                                 n_global_pixels=n_glob)
    else:
        def sample(it):
            return LeanSample.apply(scene, pixel_index, it, seed, cfg_fwd, cfg_bwd, n_glob,
                                    *scene_tensors(scene))
    total = torch.zeros((pixel_index.shape[0], 3), dtype=torch.float32, device=params.device)
    rays = torch.zeros((), dtype=torch.int64, device=params.device)
    for it in range(spp):
        radiance, n = sample(it)
        total = total + radiance
        rays = rays + n
    return total / spp, rays


def render_linear(params, static, spp, base_key, cfg, pixel_index=None,
                  n_global_pixels=None) -> torch.Tensor:
    """:func:`render_linear_rays` without the ray count."""
    return render_linear_rays(params, static, spp, base_key, cfg, pixel_index,
                              n_global_pixels)[0]


def l2_loss_rays(params, static, target, spp, base_key, cfg, pixel_index=None,
                 n_global_pixels=None):
    """``(MSE against the target linear image [N, 3], measured rays)``."""
    img, rays = render_linear_rays(params, static, spp, base_key, cfg, pixel_index,
                                   n_global_pixels)
    return torch.mean((img - target) ** 2), rays


def l2_loss(params, static, target, spp, base_key, cfg, pixel_index=None,
            n_global_pixels=None) -> torch.Tensor:
    """Mean squared error against a target linear image ``[N, 3]``."""
    return l2_loss_rays(params, static, target, spp, base_key, cfg, pixel_index,
                        n_global_pixels)[0]


def loss_and_grad_rays(params, static, target, spp, base_key, cfg, device="cuda"):
    """``(loss, grads, rays)``: the loss, its gradient as a
    :class:`SceneParams` of tensors (zeros for a leaf the loss does not
    reach, and for the atlas's static slot sizes), and the measured rays of
    one forward pass, the count behind ``bench.py``'s fwd+bwd Mrays/s (the
    backward is not counted again).
    Runs on ``device``, where ``params`` and ``target`` must live."""
    device = resolve_device(device)
    if params.device.type != device.type or device.index not in (None, params.device.index):
        raise ValueError(f"params are on {params.device}, loss_and_grad asked for {device}")
    return _value_and_grad(
        params, lambda p: l2_loss_rays(p, static, target, spp, base_key, cfg))


def _value_and_grad(params: SceneParams, loss_fn):
    """``(loss, grads, aux)`` of ``loss_fn(p) -> (loss, aux)`` over every
    leaf of ``params``: a :class:`SceneParams` of gradients, zeros where
    the loss does not reach (and for the atlas's static slot sizes)."""
    with span("loss_and_grad"):
        names, values = zip(*params.leaves().items())
        leaves = [v.detach().requires_grad_(True) for v in values]
        hw = None if params.textures is None else params.textures.hw
        p = SceneParams.from_leaves(dict(zip(names, leaves)), hw)
        with torch.enable_grad():
            with span("forward"):
                loss, aux = loss_fn(p)
            with span("backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
        # the slot sizes are static: their entry of the gradient is zeros
        hw_grad = None if hw is None else torch.zeros_like(hw)
        return loss.detach(), SceneParams.from_leaves(dict(zip(names, grads)), hw_grad), aux


def loss_and_grad(params, static, target, spp, base_key, cfg, device="cuda"):
    """``(loss, dloss/dparams)`` on one device."""
    loss, grads, _ = loss_and_grad_rays(params, static, target, spp, base_key, cfg, device)
    return loss, grads


def scatter_target(target_flat, mesh) -> torch.Tensor:
    """A pixel-ordered target ``[N, 3]`` in the device-major layout of
    ``parallel/sharded.py``: row ``d*(N/D) + j`` holds pixel ``d + D*j``
    (``diff.py:551-557``)."""
    n_dev = mesh.size
    t = torch.as_tensor(target_flat)
    return t.reshape(-1, n_dev, 3).transpose(0, 1).reshape(-1, 3)


def loss_and_grad_sharded(params, static, target_sharded, spp, base_key, cfg, mesh):
    """``(loss, grads)`` of :func:`l2_loss` over the mesh's shards
    (``diff.py:500-548``): shard ``d`` of ``D`` renders the strided pixels
    ``d + D*j`` with their global sample keys, on a copy of ``params`` on
    its device, and differentiates its share of the loss, ``sum((img -
    target_local)**2) / (N*3)``; the shares and their gradients are summed
    over the local shards and then over the processes (one ``all_reduce``
    of a flat buffer, every rank must call it).  ``target_sharded`` is the
    device-major ``[N, 3]`` of :func:`scatter_target`.  Returns the loss
    and a :class:`SceneParams` of gradients on the mesh's first local
    device, with zeros where the loss does not reach, like
    :func:`loss_and_grad`."""
    from pathtracer_tpu_torch.parallel.mesh import all_reduce_sum
    from pathtracer_tpu_torch.parallel.sharded import _run_shards, shard_rows, to_device

    target = torch.as_tensor(target_sharded)
    n_global = target.shape[0]
    n_local = shard_rows(n_global, mesh)

    def shard(i):
        d, dev = mesh.shard_ids[i], mesh.devices[i]
        pix = d + mesh.size * torch.arange(n_local, dtype=torch.int64, device=dev)
        t_local = target[d * n_local:(d + 1) * n_local].to(dev)

        def local_loss(p):
            img = render_linear(p, static, spp, base_key, cfg, pix, n_global)
            return torch.sum((img - t_local) ** 2) / (n_global * 3), None

        loss, grads, _ = _value_and_grad(to_device(params, dev), local_loss)
        return loss, grads

    results = _run_shards(mesh, shard)
    first = mesh.devices[0]
    shapes = {k: v.shape for k, v in params.leaves().items()}

    def local_sum(values):
        return torch.stack([v.to(first) for v in values]).sum(0).reshape(-1)

    flat = [local_sum([loss for loss, _ in results])]
    flat += [local_sum([g.leaves()[k] for _, g in results]) for k in shapes]
    summed = all_reduce_sum(torch.cat(flat)).split([x.numel() for x in flat])
    grads = {k: g.reshape(shape) for (k, shape), g in zip(shapes.items(), summed[1:])}
    hw = None if params.textures is None else torch.zeros_like(params.textures.hw, device=first)
    return summed[0].reshape(()), SceneParams.from_leaves(grads, hw)
