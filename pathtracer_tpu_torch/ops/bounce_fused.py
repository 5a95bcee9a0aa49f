"""One bounce per launch: the per-bounce kernel and its plain version.

Port of the wrapper ``pathtracer_tpu/ops/bounce_pallas.py:1637-1830``
(``bounce_fused``) for analytic scenes, and of ``BounceResult``
(``pathtracer_tpu/render/common.py:61-77``).  One call shades a wavefront
of lanes at mixed depths: nearest hit, emittance under the 0/1/2 emit-state
code, BSDF continuation, and NEE with a shadow sweep.

* :func:`bounce_fused_plain` is the plain version: ``ops/bounce.py:
  bounce_physics`` over the 16 input planes, with a per-lane depth and the
  per-lane ``hash_uniforms(seed, sample, depth, 11)``.
* :func:`bounce_fused_cuda` launches ``csrc/bounce.cu`` (kernel 2: one
  thread per lane, the tables in shared memory, the same ``pt::bounce``
  as the trace kernels).  Its 19 outputs equal the plain version's on
  every lane, terminated lanes included (the header says why).
* ``emit_replay=True`` on either is the forward of the per-bounce
  differentiable engine (``pathtracer_tpu/ops/bounce_grad.py:200-257``):
  it also returns the winner geom as a float (-1 on a miss) and the NEE
  bit, the planes kernel 3 (``ops/bounce_grad.py``) replays.  On the card
  it is the same kernel with two more output pointers, counted in
  ``replay_launches``.
* :func:`bounce_fused` dispatches on the rays' device: a CUDA tensor
  launches the kernel or raises, a CPU tensor takes the plain version.

Mesh scenes the in-kernel sweep takes (``bounce_pallas.py:1637-1671``, the
in-kernel branch) pass its tables as ``mesh=``: the bounce sweeps the
triangles for its nearest hit and its shadow ray.  Participating media
(``volumetric``, ``hg``): the medium is read and written, ``[N, 4]``
(sigma_a rgb, sigma_s) or ``[N, 5]`` with the phase g when ``hg`` is on
(:func:`medium_width`; ``bounce_pallas.py:1485-1488,1661,1737``), and the
kernel runs its ``kVol`` / ``kHg`` instance; in vacuum the medium passes
through.  The replay variant stays in vacuum.  The surface features
(``texture``, ``bump``, ``microfacet``, ``ward``) run the kernel's ``kSurf``
instance (``surf_launches``).  A scene with image textures runs the
deferred-texel variant (``bounce_pallas.py:1076-1119,1772-1793``): both
versions, with ``tex_defer=True``, also return the texture-scaled UV and the
atlas slot of each lane, and :func:`bounce_fused` multiplies the bilinear
texel (``ops/texture.sample_atlas``) into ``contrib`` and, on diffuse
events, the throughput multiplier (``tex_launches``).  Larger meshes (the
mesh-merge variant) and image textures on meshes raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.bounce import bounce_physics, check_features, pack_tables
from pathtracer_tpu_torch.ops.intersect import T_MIN
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes
from pathtracer_tpu_torch.ops.mesh_tables import mesh_inkernel_eligible
from pathtracer_tpu_torch.ops.texture import (
    MESH_TEXTURES_MISSING,
    check_texture_scene,
    sample_atlas,
)
from pathtracer_tpu_torch.ops.trace import (
    MEDIA_ARGTYPES,
    MESH_ARGTYPES,
    MESH_MERGE_MISSING,
    SURF_ARGTYPE,
    check_launch,
    check_tensor,
    media_args,
    mesh_launch_args,
    surface_bits,
)

launches = 0  # launches of csrc/bounce.cu in this process, analytic vacuum scenes
vol_launches = 0  # launches of its volumetric instance (analytic scenes)
hg_launches = 0  # launches of its volumetric instance with the HG phase
replay_launches = 0  # launches of its emit_replay variant
mesh_launches = 0  # launches of its variant with in-kernel mesh tables, media or not
surf_launches = 0  # launches of its surface instances (no deferred texel), any mesh or media
tex_launches = 0  # launches of its deferred-texel variant (surface blocks, any media case)


@dataclasses.dataclass(frozen=True)
class BounceResult:
    contrib: torch.Tensor  # [N, 3] radiance contribution this bounce
    next_origin: torch.Tensor  # [N, 3]
    next_direction: torch.Tensor  # [N, 3]
    throughput_mult: torch.Tensor  # [N, 3]
    terminate: torch.Tensor  # [N] bool: the path ends here (miss or light hit)
    # [N] float32 emit-state code of this bounce's event: 0 = diffuse (NEE
    # covers the next light hit), 1 = specular (a following light hit
    # counts), 2 = post-scatter specular chain (volumetric NEE covered it)
    was_specular: torch.Tensor
    rr_uniform: torch.Tensor  # [N] the uniform reserved for russian roulette
    # [N, 4] (sigma_a rgb, sigma_s) of the medium entered, [N, 5] with the
    # Henyey-Greenstein g when the hg feature is on
    next_medium: torch.Tensor


def medium_width(features) -> int:
    """The medium carry's width: 5 with the ``hg`` feature (the phase g
    rides beside sigma_a rgb and sigma_s), else 4, as every JAX engine
    sizes it (``render/megakernel.py:164-166``, ``render/wavefront.py:98,
    240``)."""
    return 5 if "hg" in features else 4


def _per_lane_depth(depth, n: int, device) -> torch.Tensor:
    return torch.as_tensor(depth, dtype=torch.int32, device=device).expand(n).contiguous()


def _checked_width(medium_sigma, hg: int) -> int:
    """The medium's width, 4 or 5; the hg instance needs the phase g."""
    width = medium_sigma.shape[1] if medium_sigma.dim() == 2 else 0
    if width not in (4, 5) or (hg and width != 5):
        raise ValueError(f"medium of shape {tuple(medium_sigma.shape)}: expected [N, 4] or, "
                         "with the hg feature, [N, 5]")
    return width


def _check_variants(emit_replay: bool, tex_defer: bool, mesh) -> None:
    if emit_replay and tex_defer:
        raise NotImplementedError("winner replay of image textures: later slice")
    if tex_defer and mesh is not None:
        raise NotImplementedError(MESH_TEXTURES_MISSING)


def bounce_fused_plain(tables, origin, direction, throughput, sample_idx, depth,
                       prev_specular, medium_sigma, seed: int, *, nee: bool,
                       features=frozenset(), emit_replay: bool = False, mesh=None,
                       vol_nee: bool = True, tex_defer: bool = False):
    """Plain version of kernel 2.  ``depth`` is an int or a per-lane
    tensor; ``medium_sigma`` ``[N, 4]`` or, with ``hg``, ``[N, 5]``; ``mesh``
    the scene's in-kernel triangle tables or None.  The output medium has
    the input's width: with ``volumetric`` the medium entered (its g column
    zero without ``hg``), without it the input passed through.  Returns a
    :class:`BounceResult`, with ``emit_replay`` the tuple ``(BounceResult,
    replay_gid [N], replay_nee_add [N])``, with ``tex_defer`` the tuple
    ``(BounceResult, tex_u [N], tex_v [N], tex_slot [N])``: the deferred
    texel's texture-scaled UV and atlas slot (-1: no texel)."""
    _check_variants(emit_replay, tex_defer, mesh)
    gtab, mtab, ltab, scal = tables
    vol, hg, _ = media_args(features, vol_nee)
    width = _checked_width(medium_sigma, hg)
    depth = _per_lane_depth(depth, origin.shape[0], origin.device)
    u = hash_uniforms_planes(seed, sample_idx, depth, 11)
    out = bounce_physics(
        tuple(origin.unbind(-1)), tuple(direction.unbind(-1)), tuple(throughput.unbind(-1)),
        tuple(medium_sigma[:, :3].unbind(-1)), medium_sigma[:, 3],
        gtab, mtab, ltab, scal, u, depth, prev_specular.to(torch.float32),
        nee=nee, t_min=T_MIN, features=features, emit_replay=emit_replay, mesh=mesh,
        medium_g=medium_sigma[:, 4] if hg else None, vol_nee=vol_nee, tex_defer=tex_defer,
    )
    g_col = []
    if width == 5:
        g_col = [out["out_mg"] if hg else (torch.zeros_like(out["out_ms"]) if vol
                                            else medium_sigma[:, 4])]
    res = BounceResult(
        contrib=torch.stack(out["contrib"], dim=-1),
        next_origin=torch.stack(out["next_o"], dim=-1),
        next_direction=torch.stack(out["next_d"], dim=-1),
        throughput_mult=torch.stack(out["thr_mult"], dim=-1),
        terminate=out["terminate"],
        was_specular=out["wspec"],
        rr_uniform=out["rru"],
        next_medium=torch.stack([*out["out_ma"], out["out_ms"], *g_col], dim=-1),
    )
    if tex_defer:
        tex = out["tex_out"]
        return res, tex["u"], tex["v"], tex["slot"]
    return (res, out["replay_gid"], out["replay_nee_add"]) if emit_replay else res


def _lib():
    fn = _build.load("bounce").bounce_launch
    if fn.argtypes is None:  # without argtypes ctypes would cut pointers to 32 bits
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [
            P, I, P, I, P, P,  # geom table, G, material table, M, light table, scalars
            ctypes.c_uint, I, I,  # seed, nee, n
            P, P, P, P, P, P, P,  # origin, direction, throughput, sample, depth, state, medium
            P, P, P, P, P, P, P, P,  # contrib, next o, next d, thr mult, terminate, state, rru, medium
            P, P,  # replay gid, replay NEE bit (null: not written)
            *MEDIA_ARGTYPES, I,  # volumetric, hg, vol_nee; the medium's width
            SURF_ARGTYPE, P, P, P,  # surface bits; deferred texel u, v, slot (null: none)
            *MESH_ARGTYPES,
            P,  # stream
        ]
    return fn


def bounce_fused_cuda(tables, origin, direction, throughput, sample_idx, depth,
                      prev_specular, medium_sigma, seed: int, *, nee: bool,
                      features=frozenset(), emit_replay: bool = False, mesh=None,
                      vol_nee: bool = True, tex_defer: bool = False):
    """Launch kernel 2 on the rays' CUDA device, on the current stream;
    ``features``, ``emit_replay``, ``mesh``, ``vol_nee`` and ``tex_defer``
    as in :func:`bounce_fused_plain`."""
    global launches, replay_launches, mesh_launches, vol_launches, hg_launches
    global surf_launches, tex_launches
    check_features(features)
    _check_variants(emit_replay, tex_defer, mesh)
    gtab, mtab, ltab, scal = tables
    device = origin.device
    n = origin.shape[0]
    media = media_args(features, vol_nee)
    surf = surface_bits(features)
    width = _checked_width(medium_sigma, media[1])
    if mesh is not None and emit_replay:
        raise NotImplementedError("winner replay of mesh scenes: later slice")
    if media[0] and emit_replay:
        raise NotImplementedError("winner replay of volumetric media: later slice")
    g, m, bits = check_launch(gtab, mtab, ltab, scal, sample_idx, n, device)
    f32 = dict(dtype=torch.float32, device=device)
    depth = _per_lane_depth(depth, n, device)
    prev = prev_specular.to(torch.float32).contiguous()
    for t, name, shape in ((origin, "origin", (n, 3)), (direction, "direction", (n, 3)),
                           (throughput, "throughput", (n, 3)), (prev, "prev_specular", (n,)),
                           (medium_sigma, "medium", (n, width))):
        check_tensor(t, name, torch.float32, shape, device)

    contrib, next_o, next_d, thr_mult = (torch.empty((n, 3), **f32) for _ in range(4))
    terminate = torch.empty(n, dtype=torch.uint8, device=device)
    wspec, rru = torch.empty(n, **f32), torch.empty(n, **f32)
    medium = torch.empty((n, width), **f32)
    replay = (torch.empty(n, **f32), torch.empty(n, **f32)) if emit_replay else (None, None)
    tex = tuple(torch.empty(n, **f32) for _ in range(3)) if tex_defer else (None,) * 3
    err = _lib()(
        gtab.data_ptr(), g, mtab.data_ptr(), m, ltab.data_ptr(), scal.data_ptr(),
        int(seed) & 0xFFFFFFFF, int(bool(nee)), n,
        origin.data_ptr(), direction.data_ptr(), throughput.data_ptr(), bits.data_ptr(),
        depth.data_ptr(), prev.data_ptr(), medium_sigma.data_ptr(),
        contrib.data_ptr(), next_o.data_ptr(), next_d.data_ptr(), thr_mult.data_ptr(),
        terminate.data_ptr(), wspec.data_ptr(), rru.data_ptr(), medium.data_ptr(),
        *(None if r is None else r.data_ptr() for r in replay), *media, width,
        surf, *(None if t is None else t.data_ptr() for t in tex),
        *mesh_launch_args(mesh, device), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bounce kernel launch failed: CUDA error {err}")
    res = BounceResult(contrib=contrib, next_origin=next_o, next_direction=next_d,
                       throughput_mult=thr_mult, terminate=terminate.view(torch.bool),
                       was_specular=wspec, rr_uniform=rru, next_medium=medium)
    if emit_replay:
        replay_launches += 1
        return (res, *replay)
    if tex_defer:
        tex_launches += 1
        return (res, *tex)
    if surf:
        surf_launches += 1
    elif mesh is not None:
        mesh_launches += 1
    elif media[1]:
        hg_launches += 1
    elif media[0]:
        vol_launches += 1
    else:
        launches += 1
    return res


def bounce_fused(scene, origin, direction, throughput, sample_idx, depth, prev_specular,
                 medium_sigma, seed: int, cfg, tables=None) -> BounceResult:
    """One bounce for a wavefront of lanes (mask-free: callers gate with
    their alive masks).  ``tables`` are :func:`pack_tables` of the scene
    (packed here when not given); ``medium_sigma`` ``[N, medium_width]`` or
    None (vacuum)."""
    check_features(cfg.features)
    if scene.meshes and not mesh_inkernel_eligible(scene.meshes):
        raise NotImplementedError(MESH_MERGE_MISSING)
    check_texture_scene(scene)
    if not cfg.fast_rng:
        raise NotImplementedError("per-bounce kernel for fast_rng=False: later slice")
    tables = tables if tables is not None else pack_tables(scene)
    if medium_sigma is None:
        medium_sigma = torch.zeros((origin.shape[0], medium_width(cfg.features)),
                                   dtype=torch.float32, device=origin.device)
    args = (tables, origin, direction, throughput, sample_idx, depth, prev_specular,
            medium_sigma, seed)
    tex_defer = scene.textures is not None
    kw = dict(nee=cfg.nee, features=frozenset(cfg.features), mesh=scene.mesh_tables,
              vol_nee=cfg.vol_nee, tex_defer=tex_defer)
    device_type = origin.device.type
    if device_type == "cuda":
        out = bounce_fused_cuda(*args, **kw)
    elif device_type == "cpu":
        out = bounce_fused_plain(*args, **kw)
    else:
        raise ValueError(f"no per-bounce kernel for device type {device_type!r}")
    return apply_texel(scene.textures, *out) if tex_defer else out


def apply_texel(atlas, res: BounceResult, tex_u, tex_v, tex_slot) -> BounceResult:
    """The deferred texel (``bounce_pallas.py:1772-1793``): the albedo enters
    ``contrib`` (emittance or NEE, never both on a lane) and the diffuse
    multiplier linearly, so one bilinear texel multiplies in what the split
    route folds into the albedo; only diffuse events (emit state 0) carry
    the albedo in their multiplier."""
    texel = sample_atlas(atlas, tex_slot, torch.stack([tex_u, tex_v], dim=-1))
    on = tex_slot >= 0.0
    diffuse = (on & (res.was_specular < 0.5))[:, None]
    return dataclasses.replace(
        res,
        contrib=res.contrib * torch.where(on[:, None], texel, 1.0),
        throughput_mult=torch.where(diffuse, res.throughput_mult * texel, res.throughput_mult),
    )
