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
  ``replay_launches`` (``replay_vol_launches`` for its volumetric instance,
  2r-v, ``replay_surf_launches`` for its surface instances, 2r-s).
* :func:`bounce_fused` dispatches on the rays' device: a CUDA tensor
  launches the kernel or raises, a CPU tensor takes the plain version.

Mesh scenes the in-kernel sweep takes (``bounce_pallas.py:1637-1671``, the
in-kernel branch) pass its tables as ``mesh=``: the bounce sweeps the
triangles for its nearest hit and its shadow ray.  Participating media
(``volumetric``, ``hg``): the medium is read and written, ``[N, 4]``
(sigma_a rgb, sigma_s) or ``[N, 5]`` with the phase g when ``hg`` is on
(:func:`medium_width`; ``bounce_pallas.py:1485-1488,1661,1737``), and the
kernel runs its ``kVol`` / ``kHg`` instance; in vacuum the medium passes
through.  The replay variant runs in vacuum and in ``volumetric`` media
without ``hg``, with or without the surface features (the per-bounce
differentiable engine's scope, as in JAX).  The surface features
(``texture``, ``bump``, ``microfacet``, ``ward``) run the kernel's ``kSurf``
instance (``surf_launches``).  A scene with image textures runs the
deferred-texel variant (``bounce_pallas.py:1076-1119,1772-1793``): both
versions, with ``tex_defer=True``, also return the texture-scaled UV and the
atlas slot of each lane, and :func:`bounce_fused` multiplies the bilinear
texel (``ops/texture.sample_atlas``) into ``contrib`` and, on diffuse
events, the throughput multiplier (``tex_launches``); with in-kernel meshes
it is kernel 2m's UV sweep (2mt, ``mesh_tex_launches``): a mesh lane's UV
is the box map of its object-space normal or its authored ``vt``.

Meshes above the in-kernel cap run the mesh-merge variant (2mm,
``bounce_pallas.py:1637-1830``, ``merge_launches``): :func:`bounce_fused`
finds each lane's mesh winner first (``ops/mesh.mesh_only_hit``: kernel 9
per mesh, or the LBVH traversal above 8,192 triangles) and hands it to both
versions as ``mesh_in``, 8 planes ``[8, N]`` (t, the hit point in the
mesh's object space, the unit world normal, the material id), with image
textures and authored ``vt`` also ``mesh_uv``, 3 planes ``[3, N]`` (u, v,
1.0 where the UV exists).  Under NEE the kernel traces the shadow ray
against the analytic geoms only and returns it with its pending term, 11
planes ``[11, N]`` (x, wi, distance, the NEE rgb, 1.0 where the candidate
is analytically visible); :func:`bounce_fused` then tests the triangles
(``ops/mesh.mesh_only_occlusion``: kernel 10 per mesh) and adds the term
where both clear it, times the texel where there is one
(``:1794-1811``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.bounce import bounce_physics, check_features, pack_tables
from pathtracer_tpu_torch.ops.bsdf import RAY_BIAS
from pathtracer_tpu_torch.ops.intersect import T_MIN
from pathtracer_tpu_torch.ops.mesh import mesh_only_hit, mesh_only_occlusion
from pathtracer_tpu_torch.ops.mesh_tables import mesh_inkernel_eligible
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes
from pathtracer_tpu_torch.ops.texture import sample_atlas
from pathtracer_tpu_torch.ops.trace import (
    MEDIA_ARGTYPES,
    MESH_ARGTYPES,
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
replay_launches = 0  # launches of its emit_replay variant, vacuum scenes
replay_vol_launches = 0  # launches of its emit_replay variant's volumetric instance (2r-v)
# launches of its emit_replay variant's surface instances (2r-s), vacuum or volumetric
replay_surf_launches = 0
mesh_launches = 0  # launches of its variant with in-kernel mesh tables, media or not
surf_launches = 0  # launches of its surface instances (no deferred texel), any mesh or media
tex_launches = 0  # launches of its deferred-texel variant (surface blocks, any media case)
mesh_tex_launches = 0  # launches of the deferred-texel variant with in-kernel meshes (2mt)
merge_launches = 0  # launches of csrc/bounce_merge.cu, the mesh-merge variant (2mm), any case

MERGE_PLANES = 8  # mesh_in: t, hit point (object space) xyz, world normal xyz, material id
MESH_UV_PLANES = 3  # mesh_uv: u, v, 1.0 where the UV exists
DEFERRED_PLANES = 11  # the deferred shadow ray: x xyz, wi xyz, dist, NEE rgb, cand_vis


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


def _check_variants(emit_replay: bool, tex_defer: bool, mesh, mesh_in, mesh_uv) -> None:
    if emit_replay and tex_defer:
        raise NotImplementedError("winner replay of image textures: later slice")
    if emit_replay and (mesh is not None or mesh_in is not None):
        raise NotImplementedError("winner replay of mesh scenes: later slice")
    if mesh is not None and mesh_in is not None:
        raise ValueError("mesh (the in-kernel tables) and mesh_in (an outside winner) exclude "
                         "each other")
    if mesh_uv is not None and (mesh_in is None or not tex_defer):
        raise ValueError("mesh_uv serves the deferred texel of a mesh_in launch")


def _mesh_in_dict(mesh_in, mesh_uv) -> dict:
    """``bounce_physics``'s ``mesh_in`` from the planes."""
    out = dict(et=mesh_in[0], epo=tuple(mesh_in[1:4]), en=tuple(mesh_in[4:7]),
               emid=mesh_in[7].to(torch.int64))
    if mesh_uv is not None:
        out.update(muv_u=mesh_uv[0], muv_v=mesh_uv[1], muvv=mesh_uv[2])
    return out


def bounce_fused_plain(tables, origin, direction, throughput, sample_idx, depth,
                       prev_specular, medium_sigma, seed: int, *, nee: bool,
                       features=frozenset(), emit_replay: bool = False, mesh=None,
                       vol_nee: bool = True, tex_defer: bool = False, mesh_in=None,
                       mesh_uv=None):
    """Plain version of kernel 2.  ``depth`` is an int or a per-lane
    tensor; ``medium_sigma`` ``[N, 4]`` or, with ``hg``, ``[N, 5]``; ``mesh``
    the scene's in-kernel triangle tables or None; ``mesh_in`` / ``mesh_uv``
    the mesh-merge variant's planes, as the module docstring says.  The
    output medium has the input's width: with ``volumetric`` the medium
    entered (its g column zero without ``hg``), without it the input passed
    through.  Returns a :class:`BounceResult`, with ``emit_replay`` the
    tuple ``(BounceResult, replay_gid [N], replay_nee_add [N])``; with
    ``tex_defer`` the tuple ``(BounceResult, tex_u [N], tex_v [N],
    tex_slot [N])``: the deferred texel's texture-scaled UV and atlas slot
    (-1: no texel); with ``mesh_in`` under NEE one more element at the end,
    the deferred shadow ray ``[11, N]``."""
    _check_variants(emit_replay, tex_defer, mesh, mesh_in, mesh_uv)
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
        mesh_in=None if mesh_in is None else _mesh_in_dict(mesh_in, mesh_uv),
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
    if emit_replay:
        return res, out["replay_gid"], out["replay_nee_add"]
    extra = []
    if tex_defer:
        tex = out["tex_out"]
        extra += [tex["u"], tex["v"], tex["slot"]]
    if "nee_deferred" in out:
        nd = out["nee_deferred"]
        extra.append(torch.stack([*nd["x"], *nd["wi"], nd["dist"], *nd["nee_rgb"],
                                  nd["cand_vis"]]))
    return (res, *extra) if extra else res


def _lib():
    fn = _build.load("bounce").bounce_launch
    if fn.argtypes is None:  # without argtypes ctypes would cut pointers to 32 bits
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [
            *_COMMON_ARGTYPES,
            P, P,  # replay gid, replay NEE bit (null: not written)
            *MEDIA_ARGTYPES, I,  # volumetric, hg, vol_nee; the medium's width
            SURF_ARGTYPE, P, P, P,  # surface bits; deferred texel u, v, slot (null: none)
            *MESH_ARGTYPES,
            P,  # stream
        ]
    return fn


def _merge_lib():
    fn = _build.load("bounce_merge").bounce_merge_launch
    if fn.argtypes is None:  # without argtypes ctypes would cut pointers to 32 bits
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = ctypes.c_int
        fn.argtypes = [
            *_COMMON_ARGTYPES,
            *MEDIA_ARGTYPES, I,  # volumetric, hg, vol_nee; the medium's width
            SURF_ARGTYPE, P, P, P,  # surface bits; deferred texel u, v, slot (null: none)
            P, P, P,  # mesh_in [8, N], mesh_uv [3, N] (null: none), deferred [11, N] (null: no NEE)
            P,  # stream
        ]
    return fn


_COMMON_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,  # geom table, G, materials, M
    ctypes.c_void_p, ctypes.c_void_p,  # light table, scalars
    ctypes.c_uint, ctypes.c_int, ctypes.c_int,  # seed, nee, n
    *[ctypes.c_void_p] * 7,  # origin, direction, throughput, sample, depth, state, medium
    *[ctypes.c_void_p] * 8,  # contrib, next o, next d, thr mult, terminate, state, rru, medium
]


def bounce_fused_cuda(tables, origin, direction, throughput, sample_idx, depth,
                      prev_specular, medium_sigma, seed: int, *, nee: bool,
                      features=frozenset(), emit_replay: bool = False, mesh=None,
                      vol_nee: bool = True, tex_defer: bool = False, mesh_in=None,
                      mesh_uv=None):
    """Launch kernel 2 on the rays' CUDA device, on the current stream
    (``csrc/bounce.cu``, or with ``mesh_in`` ``csrc/bounce_merge.cu``);
    the arguments and the result as in :func:`bounce_fused_plain`."""
    global launches, replay_launches, replay_vol_launches, replay_surf_launches, mesh_launches
    global vol_launches, hg_launches
    global surf_launches, tex_launches, mesh_tex_launches, merge_launches
    check_features(features)
    _check_variants(emit_replay, tex_defer, mesh, mesh_in, mesh_uv)
    gtab, mtab, ltab, scal = tables
    device = origin.device
    n = origin.shape[0]
    media = media_args(features, vol_nee)
    surf = surface_bits(features)
    width = _checked_width(medium_sigma, media[1])
    if media[1] and emit_replay:
        raise NotImplementedError("winner replay of the hg instance: the lean engine "
                                  "differentiates Henyey-Greenstein media")
    g, m, bits = check_launch(gtab, mtab, ltab, scal, sample_idx, n, device)
    f32 = dict(dtype=torch.float32, device=device)
    depth = _per_lane_depth(depth, n, device)
    prev = prev_specular.to(torch.float32).contiguous()
    for t, name, shape in ((origin, "origin", (n, 3)), (direction, "direction", (n, 3)),
                           (throughput, "throughput", (n, 3)), (prev, "prev_specular", (n,)),
                           (medium_sigma, "medium", (n, width))):
        check_tensor(t, name, torch.float32, shape, device)
    if mesh_in is not None:
        check_tensor(mesh_in, "mesh_in", torch.float32, (MERGE_PLANES, n), device)
    if mesh_uv is not None:
        check_tensor(mesh_uv, "mesh_uv", torch.float32, (MESH_UV_PLANES, n), device)

    contrib, next_o, next_d, thr_mult = (torch.empty((n, 3), **f32) for _ in range(4))
    terminate = torch.empty(n, dtype=torch.uint8, device=device)
    wspec, rru = torch.empty(n, **f32), torch.empty(n, **f32)
    medium = torch.empty((n, width), **f32)
    replay = (torch.empty(n, **f32), torch.empty(n, **f32)) if emit_replay else (None, None)
    tex = tuple(torch.empty(n, **f32) for _ in range(3)) if tex_defer else (None,) * 3
    deferred = (torch.empty((DEFERRED_PLANES, n), **f32)
                if mesh_in is not None and nee else None)
    common = (
        gtab.data_ptr(), g, mtab.data_ptr(), m, ltab.data_ptr(), scal.data_ptr(),
        int(seed) & 0xFFFFFFFF, int(bool(nee)), n,
        origin.data_ptr(), direction.data_ptr(), throughput.data_ptr(), bits.data_ptr(),
        depth.data_ptr(), prev.data_ptr(), medium_sigma.data_ptr(),
        contrib.data_ptr(), next_o.data_ptr(), next_d.data_ptr(), thr_mult.data_ptr(),
        terminate.data_ptr(), wspec.data_ptr(), rru.data_ptr(), medium.data_ptr(),
    )
    tex_ptrs = tuple(None if t is None else t.data_ptr() for t in tex)
    stream = torch.cuda.current_stream(device).cuda_stream
    if mesh_in is not None:
        err = _merge_lib()(
            *common, *media, width, surf, *tex_ptrs, mesh_in.data_ptr(),
            None if mesh_uv is None else mesh_uv.data_ptr(),
            None if deferred is None else deferred.data_ptr(), stream,
        )
    else:
        err = _lib()(
            *common, *(None if r is None else r.data_ptr() for r in replay), *media, width,
            surf, *tex_ptrs, *mesh_launch_args(mesh, device), stream,
        )
    if err != 0:
        raise RuntimeError(f"bounce kernel launch failed: CUDA error {err}")
    res = BounceResult(contrib=contrib, next_origin=next_o, next_direction=next_d,
                       throughput_mult=thr_mult, terminate=terminate.view(torch.bool),
                       was_specular=wspec, rr_uniform=rru, next_medium=medium)
    if emit_replay:
        if surf:
            replay_surf_launches += 1
        elif media[0]:
            replay_vol_launches += 1
        else:
            replay_launches += 1
        return (res, *replay)
    if mesh_in is not None:
        merge_launches += 1
    elif tex_defer and mesh is not None:
        mesh_tex_launches += 1
    elif tex_defer:
        tex_launches += 1
    elif surf:
        surf_launches += 1
    elif mesh is not None:
        mesh_launches += 1
    elif media[1]:
        hg_launches += 1
    elif media[0]:
        vol_launches += 1
    else:
        launches += 1
    extra = (tex if tex_defer else ()) + (() if deferred is None else (deferred,))
    return (res, *extra) if extra else res


def merge_planes(scene, origin, direction, gtab, with_uv: bool):
    """The mesh-merge variant's inputs: ``mesh_in [8, N]`` and, with
    ``with_uv``, ``mesh_uv [3, N]`` (else None) from
    ``ops/mesh.mesh_only_hit`` over the scene's meshes (``bounce_pallas.py:
    1694-1720``)."""
    from pathtracer_tpu_torch.scene.structs import Rays

    t, pobj, nrm, mid, _, uv, uv_valid = mesh_only_hit(Rays(origin, direction), gtab,
                                                       scene.meshes)
    mesh_in = torch.cat([t[None], pobj.T, nrm.T, mid[None].to(torch.float32)]).contiguous()
    mesh_uv = (torch.cat([uv.T, uv_valid[None].to(torch.float32)]).contiguous()
               if with_uv else None)
    return mesh_in, mesh_uv


def bounce_fused(scene, origin, direction, throughput, sample_idx, depth, prev_specular,
                 medium_sigma, seed: int, cfg, tables=None) -> BounceResult:
    """One bounce for a wavefront of lanes (mask-free: callers gate with
    their alive masks).  ``tables`` are :func:`pack_tables` of the scene
    (packed here when not given); ``medium_sigma`` ``[N, medium_width]`` or
    None (vacuum)."""
    check_features(cfg.features)
    if not cfg.fast_rng:
        raise NotImplementedError(
            "the per-bounce kernel draws the counter hash: fast_rng=False takes "
            "render/common.shade_bounce's split route, as in JAX")
    tables = tables if tables is not None else pack_tables(scene)
    if medium_sigma is None:
        medium_sigma = torch.zeros((origin.shape[0], medium_width(cfg.features)),
                                   dtype=torch.float32, device=origin.device)
    device_type = origin.device.type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"no per-bounce kernel for device type {device_type!r}")
    tex_defer = scene.textures is not None
    kw = dict(nee=cfg.nee, features=frozenset(cfg.features), vol_nee=cfg.vol_nee,
              tex_defer=tex_defer)
    merge = bool(scene.meshes) and not mesh_inkernel_eligible(scene.meshes)
    if merge:
        with_uv = tex_defer and any(m.tri_uv is not None for m in scene.meshes)
        kw["mesh_in"], kw["mesh_uv"] = merge_planes(scene, origin, direction, tables[0], with_uv)
    else:
        kw["mesh"] = scene.mesh_tables
    args = (tables, origin, direction, throughput, sample_idx, depth, prev_specular,
            medium_sigma, seed)
    out = (bounce_fused_cuda if device_type == "cuda" else bounce_fused_plain)(*args, **kw)
    if not isinstance(out, tuple):
        return out
    res, *extra = out
    tmul = None
    if tex_defer:
        res, tmul = apply_texel(scene.textures, res, *extra[:3])
    if merge and cfg.nee:
        res = resolve_deferred(scene, tables[0], res, extra[-1], tmul)
    return res


def resolve_deferred(scene, gtab, res: BounceResult, deferred, tmul=None) -> BounceResult:
    """The deferred NEE term (``bounce_pallas.py:1794-1811``): the shadow
    ray's triangle occlusion (``ops/mesh.mesh_only_occlusion``); where the
    analytic geoms and the triangles both leave it clear, ``nee_rgb`` (times
    the texel ``tmul`` where given) is added to ``contrib``."""
    from pathtracer_tpu_torch.scene.structs import Rays

    shadow = Rays(origin=deferred[0:3].T.contiguous(), direction=deferred[3:6].T.contiguous())
    occ = mesh_only_occlusion(shadow, gtab, scene.meshes)
    visible = (deferred[10] > 0.5) & (occ >= deferred[6] - 4.0 * RAY_BIAS)
    nee_add = torch.where(visible[:, None], deferred[7:10].T, 0.0)
    if tmul is not None:
        nee_add = nee_add * tmul
    return dataclasses.replace(res, contrib=res.contrib + nee_add)


def apply_texel(atlas, res: BounceResult, tex_u, tex_v, tex_slot):
    """The deferred texel (``bounce_pallas.py:1772-1793``): the albedo enters
    ``contrib`` (emittance or NEE, never both on a lane) and the diffuse
    multiplier linearly, so one bilinear texel multiplies in what the split
    route folds into the albedo; only diffuse events (emit state 0) carry
    the albedo in their multiplier.  Returns the result and the per-lane
    multiplier ``[N, 3]`` (the texel, 1 where there is none)."""
    texel = sample_atlas(atlas, tex_slot, torch.stack([tex_u, tex_v], dim=-1))
    on = tex_slot >= 0.0
    tmul = torch.where(on[:, None], texel, 1.0)
    diffuse = (on & (res.was_specular < 0.5))[:, None]
    return dataclasses.replace(
        res,
        contrib=res.contrib * tmul,
        throughput_mult=torch.where(diffuse, res.throughput_mult * texel, res.throughput_mult),
    ), tmul
