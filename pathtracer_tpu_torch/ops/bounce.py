"""One bounce of path-tracing physics, in plain PyTorch.

Port of ``pathtracer_tpu/ops/bounce_pallas.py`` for the base physics: the
vector helpers (``:60-98``), the table packers (``:143-188``: 28-column
material table, 19-column light table, 2 scalars), ``_material_fetch``
(``:544``), ``_not_axis_frame`` / ``_cosine_hemisphere`` /
``_rotate_about`` (``:607-644``), ``_sample_bsdf_planes`` (``:709-795``),
``_sample_lights_planes`` (``:798-861``) and ``bounce_physics``
(``:881-1470``), with ``RAY_BIAS`` from ``pathtracer_tpu/ops/bsdf.py:33``.

This is the plain version of the kernels' one bounce
(``csrc/trace_common.cuh:pt::bounce``: the trace loops' body, and with a
per-lane ``depth`` the per-bounce kernel ``csrc/bounce.cu``): nearest hit
with the first minimum winning,
argmax-|coord| cube normals, inverse-transpose world normals, emittance
under the 0/1/2 emit-state code, Lambert / Phong-glossy / mirror / Fresnel
dielectric sampling, and area-light NEE with a shadow sweep.  Vectors are
tuples of three ``[N]`` tensors.  The JAX kernel selects table rows with
where-chains over every geom and material (the TPU has no vector gather);
here they are gathers with the same result.  Everything here is
differentiable in its tensor inputs: autograd of it is the reference of the
reverse trace kernel (``csrc/trace_grad.cu``), and winner replay
(``bounce_physics(replay=...)``) is its recompute.

Triangle meshes whose tables the kernels take (``ops/mesh_tables.py``)
enter through ``mesh=``: the in-kernel sweep's winner is merged into the
analytic one (``bounce_pallas.py:1027-1036``: where the mesh is nearer its
distance, material, hit point and normal win, while the analytic geom id
stays), and the shadow ray sweeps the triangles too (``:1251-1254``).
Larger meshes enter through ``mesh_in=`` (kernel 2's mesh-merge variant,
2mm): a winner found outside the bounce is merged the same way, and under
NEE the shadow ray and its pending term leave as ``nee_deferred``
(``:1263-1275``) for the caller's triangle occlusion test.
Participating media (``volumetric``, ``hg``: ``bounce_pallas.py:1140-1168,
1323-1470``) are modelled forward, with ``mesh_occ_split`` for volumetric
NEE's shadow ray through in-kernel meshes.  The optional surface blocks
(``texture``: the checker / stripes albedo, ``:1054-1074``; ``bump``: the
sinusoidal bump of the shading normal, ``:1121-1138``; ``microfacet`` and
``ward``: the Cook-Torrance GGX and Ward lobes, ``:645-706,756-783``) run in
JAX's order: texture before the bump, the bump before the free path, the
emittance, NEE and the BSDF.  ``tex_defer`` adds the deferred image texel's
UV and atlas slot (``:1076-1119``, with the polynomial ``atan2_planes`` /
``asin_planes`` of ``:580-605``).  The differentiable engines take media
and the surface features (:func:`check_diff_features`).  ``glossy`` is not
gated in the JAX kernel either.
"""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.ops.bsdf import sqrt0
from pathtracer_tpu_torch.ops.intersect import (
    BIG,
    geom_t,
    geom_t_lanes,
    object_normal,
    pack_geom_table,
    sweep,
    world_normal,
)
from pathtracer_tpu_torch.ops.lights import axis_scales, light_areas
from pathtracer_tpu_torch.ops.mesh_tables import mesh_occ, mesh_occ_split, mesh_sweep
from pathtracer_tpu_torch.scene.structs import SPHERE, Scene
from pathtracer_tpu_torch.utils.metrics import span

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
RAY_BIAS = 2e-4
SQRT_ONE_THIRD = 0.5773502691896257

MAT_COLS = 28
LIGHT_COLS = 19

# features the forward bounce models; "glossy" is always on in the kernel body
SUPPORTED_FEATURES = frozenset(
    {"glossy", "volumetric", "hg", "texture", "bump", "microfacet", "ward"})
# winner replay (the fused differentiable engines) stops at meshes and image
# textures, as JAX's fused_diff_eligible does: such scenes take the lean engine
MESH_REPLAY_REFUSAL = ("winner replay of mesh scenes: the lean engine "
                       "(RenderConfig(grad_fused=False)) differentiates them")
TEX_REPLAY_REFUSAL = ("winner replay of image textures: the lean engine "
                      "(RenderConfig(grad_fused=False)) differentiates them")
# the optional surface blocks, compiled into the kernels' kSurf instance
SURFACE_FEATURES = ("texture", "bump", "microfacet", "ward")


def check_features(features, supported=SUPPORTED_FEATURES, what="the bounce physics") -> None:
    missing = sorted(set(features) - supported)
    if missing:
        raise NotImplementedError(
            f"feature(s) {', '.join(missing)} of {what}: not modelled; the lean engine "
            "(RenderConfig(grad_fused=False)) takes the scenes the fused kernels do not")


def check_diff_features(features, engine: str) -> None:
    """The differentiable engines' gate: ``engine`` is ``"fused"`` (the
    full-depth and per-bounce engines) or ``"lean"``.  Every engine models
    every feature of the bounce but ``hg``, which runs on the lean engine
    only, as in JAX (``trace_grad.py:472``; ``render/diff`` sends such
    scenes there)."""
    if engine == "fused" and "hg" in features:
        raise NotImplementedError(
            "feature(s) hg of the fused differentiable engines: the lean engine "
            "(RenderConfig(grad_fused=False)) differentiates them")
    check_features(features, what="the differentiable engines")


# ---------------------------------------------------------------------------
# vec3-as-tensors helpers
# ---------------------------------------------------------------------------

def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vscale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vwhere(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def vnormalize(a, eps=1e-24):
    return vscale(torch.rsqrt(torch.clamp(vdot(a, a), min=eps)), a)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def pack_material_table(m) -> torch.Tensor:
    """``[M, 28]`` float32 in the JAX kernel's column order."""
    return torch.cat(
        [
            m.color, m.specular_color,
            m.has_reflective[:, None], m.has_refractive[:, None],
            m.index_of_refraction[:, None], m.emittance[:, None],
            m.specular_exponent[:, None], m.absorption_coefficient,
            m.has_scatter[:, None], m.reduced_scatter_coefficient[:, None],
            m.texture_type[:, None], m.texture_scale[:, None],
            m.texture_color2, m.bump_scale[:, None], m.bump_amp[:, None],
            m.texture_image[:, None], m.brdf_model[:, None],
            m.roughness[:, None], m.roughness_y[:, None],
            m.phase_g[:, None],
        ],
        dim=-1,
    ).contiguous()


def pack_light_table(geoms, materials) -> torch.Tensor:
    """``[G, 19]`` float32 per geom: forward-transform rows 0..2 (12),
    light-pick CDF (1), emitted rgb (3), world per-axis scales (3)."""
    fwd12 = geoms.transform.reshape(geoms.count, 16)[:, :12]
    areas = light_areas(geoms, materials)
    total = torch.clamp(torch.sum(areas), min=1e-20)
    cdf = torch.cumsum(areas, dim=0) / total
    mid = geoms.material_id.long()
    emit = materials.color[mid] * materials.emittance[mid][:, None]
    return torch.cat(
        [fwd12, cdf[:, None], emit, axis_scales(geoms.transform)], dim=-1
    ).contiguous()


def pack_scalars(scene: Scene) -> torch.Tensor:
    """``[2]`` float32: total light area, any-light flag."""
    total = torch.sum(light_areas(scene.geoms, scene.materials))
    return torch.stack([total, (total > 0).to(torch.float32)])


def pack_tables(scene: Scene):
    """``(geom [G,14], material [M,28], light [G,19], scalars [2])``.
    Raises if a geom names a material the table does not have (the trace
    kernel indexes its material table by that id unchecked)."""
    with span("pack_tables"):
        mid = scene.geoms.material_id
        if bool(((mid < 0) | (mid >= scene.materials.count)).any()):
            raise ValueError(
                f"geom material ids {mid.tolist()} outside [0, {scene.materials.count})"
            )
        return (
            pack_geom_table(scene.geoms),
            pack_material_table(scene.materials),
            pack_light_table(scene.geoms, scene.materials),
            pack_scalars(scene),
        )


def material_fetch(mtab: torch.Tensor, mid: torch.Tensor) -> dict:
    cols = mtab[mid.long()].unbind(-1)
    return dict(
        color=(cols[0], cols[1], cols[2]),
        spec_color=(cols[3], cols[4], cols[5]),
        has_reflective=cols[6],
        has_refractive=cols[7],
        ior=cols[8],
        emittance=cols[9],
        spec_exp=cols[10],
        absorption=(cols[11], cols[12], cols[13]),
        has_scatter=cols[14],
        scatter_coeff=cols[15],
        texture_type=cols[16],
        texture_scale=cols[17],
        texture_color2=(cols[18], cols[19], cols[20]),
        bump_scale=cols[21],
        bump_amp=cols[22],
        texture_image=cols[23],
        brdf_model=cols[24],
        roughness=cols[25],
        roughness_y=cols[26],
        phase_g=cols[27],
    )


def atan2_planes(y, x):
    """JAX's plane atan2 (``bounce_pallas.py:580-601``): an octant-reduced
    minimax polynomial on [0, 1], within about 2e-7 rad of libm."""
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ay > ax
    num = torch.minimum(ax, ay)
    den = torch.clamp(torch.maximum(ax, ay), min=1e-30)
    r = num / den
    z = r * r
    p = r * (0.99997726 + z * (-0.33262347 + z * (0.19354346 + z * (
        -0.11643287 + z * (0.05265332 + z * -0.01172120)))))
    a = torch.where(swap, 0.5 * math.pi - p, p)
    a = torch.where(x < 0.0, math.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def asin_planes(x):
    """``atan2_planes(x, sqrt(1 - x^2))``; ``x`` in [-1, 1]."""
    return atan2_planes(x, torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)))


# ---------------------------------------------------------------------------
# sampling blocks
# ---------------------------------------------------------------------------

def not_axis_frame(n):
    """Tangent frame (p1, p2) about ``n``."""
    use_x = torch.abs(n[0]) < SQRT_ONE_THIRD
    use_y = (~use_x) & (torch.abs(n[1]) < SQRT_ONE_THIRD)
    one, zero = torch.ones_like(n[0]), torch.zeros_like(n[0])
    not_n = (
        torch.where(use_x, one, zero),
        torch.where(use_y, one, zero),
        torch.where(use_x | use_y, zero, one),
    )
    p1 = vnormalize(vcross(n, not_n))
    p2 = vnormalize(vcross(n, p1))
    return p1, p2


def cosine_hemisphere(n, xi1, xi2):
    up = torch.sqrt(xi1)
    over = torch.sqrt(torch.clamp(1.0 - xi1, min=0.0))
    around = xi2 * TWO_PI
    p1, p2 = not_axis_frame(n)
    return vadd(
        vscale(up, n),
        vadd(vscale(torch.cos(around) * over, p1), vscale(torch.sin(around) * over, p2)),
    )


def rotate_about(axis_dir, cos_angle, phi):
    sin_angle = sqrt0(1.0 - cos_angle * cos_angle)
    p1, p2 = not_axis_frame(axis_dir)
    return vadd(
        vscale(cos_angle, axis_dir),
        vadd(
            vscale(torch.cos(phi) * sin_angle, p1),
            vscale(torch.sin(phi) * sin_angle, p2),
        ),
    )


def ggx_planes(mat, n, d_in, cos_i, u0, u1):
    """The Cook-Torrance GGX lobe (``bounce_pallas.py:645-672``):
    direction and weight; ``x ** 5`` as JAX lowers it."""
    alpha = torch.clamp(mat["roughness"] * mat["roughness"], 1e-4, 1.0)
    a2 = alpha * alpha
    xi1 = torch.clamp(u0, 1e-7, 1.0 - 1e-7)
    cos_h = torch.sqrt(torch.clamp((1.0 - xi1) / (1.0 + (a2 - 1.0) * xi1), 0.0, 1.0))
    h = rotate_about(n, cos_h, u1 * TWO_PI)
    d = vsub(d_in, vscale(2.0 * vdot(d_in, h), h))
    wo_dot_h = -vdot(d_in, h)
    cos_o = vdot(d, n)
    valid = (cos_o > 0.0) & (wo_dot_h > 0.0)

    def g1(c):
        c = torch.clamp(c, 1e-6, 1.0)
        return 2.0 * c / (c + torch.sqrt(a2 + (1.0 - a2) * c * c))

    g = g1(torch.clamp(cos_i, 1e-6, 1.0)) * g1(cos_o)
    x = torch.clamp(1.0 - wo_dot_h, min=0.0)
    f5 = x * ((x * x) * (x * x))
    f = tuple(s + (1.0 - s) * f5 for s in mat["spec_color"])
    w = g * wo_dot_h / torch.clamp(torch.clamp(cos_i, 1e-6, 1.0) * cos_h, min=1e-6)
    return d, vwhere(valid, vscale(w, f), (0.0 * w,) * 3)


def ward_planes(mat, n, d_in, cos_i, u0, u1):
    """The Ward lobe (``bounce_pallas.py:674-706``): direction and weight;
    ``1 / sqrt`` is a division, ``cos_th ** 3`` as JAX lowers it."""
    ax_ = torch.clamp(mat["roughness"], 1e-3, 1.0)
    ay_ = torch.clamp(torch.where(mat["roughness_y"] > 0.0, mat["roughness_y"], mat["roughness"]),
                      1e-3, 1.0)
    xi1 = torch.clamp(u0, 1e-7, 1.0 - 1e-7)
    beta = TWO_PI * u1
    cb, sb = torch.cos(beta), torch.sin(beta)
    d_inv = ax_ * ax_ * cb * cb + ay_ * ay_ * sb * sb
    inv_len = 1.0 / torch.sqrt(torch.clamp(d_inv, min=1e-12))
    cos_phi = ax_ * cb * inv_len
    sin_phi = ay_ * sb * inv_len
    tan2 = -torch.log(xi1) * d_inv
    cos_th = 1.0 / torch.sqrt(1.0 + tan2)
    sin_th = sqrt0(1.0 - cos_th * cos_th)
    t1, t2 = not_axis_frame(n)
    h = vadd(vscale(cos_th, n), vadd(vscale(sin_th * cos_phi, t1), vscale(sin_th * sin_phi, t2)))
    d = vsub(d_in, vscale(2.0 * vdot(d_in, h), h))
    wi_dot_h = -vdot(d_in, h)
    cos_o = vdot(d, n)
    valid = (cos_o > 0.0) & (wi_dot_h > 0.0)
    w = (wi_dot_h * (cos_th * (cos_th * cos_th))
         * sqrt0(torch.clamp(cos_o, min=0.0) / torch.clamp(cos_i, 1e-6, 1.0)))
    return d, vwhere(valid, vscale(w, mat["spec_color"]), (0.0 * w,) * 3)


def sample_bsdf(mat, p, n_raw, d_in, u0, u1, u2, features=frozenset()):
    """Continuation ray: diffuse, Phong glossy, mirror or Fresnel glass, and
    with ``microfacet`` (``ward``) the Cook-Torrance (and Ward) lobe on the
    reflective lanes whose BRDF model is 1 (2)."""
    cos_raw = vdot(d_in, n_raw)
    entering = cos_raw < 0.0
    n = vwhere(entering, n_raw, vscale(-1.0, n_raw))
    cos_i = torch.abs(cos_raw)

    d_diffuse = cosine_hemisphere(n, u0, u1)
    d_mirror = vsub(d_in, vscale(2.0 * vdot(d_in, n), n))

    exp_n = torch.clamp(mat["spec_exp"], min=1e-6)
    cos_alpha = torch.exp(torch.log(torch.clamp(u0, min=1e-9)) / (exp_n + 1.0))
    d_glossy = rotate_about(d_mirror, cos_alpha, u1 * TWO_PI)
    glossy_cos_out = vdot(d_glossy, n)
    glossy_weight = torch.where(
        glossy_cos_out > 0.0,
        (exp_n + 2.0) / (exp_n + 1.0) * torch.clamp(glossy_cos_out, 0.0, 1.0),
        0.0,
    )

    ior = mat["ior"]
    ior_i = torch.where(entering, 1.0, ior)
    ior_t = torch.where(entering, ior, 1.0)
    eta = ior_i / torch.clamp(ior_t, min=1e-6)
    r_cos_i = -vdot(d_in, n)
    sin2_t = eta * eta * torch.clamp(1.0 - r_cos_i * r_cos_i, min=0.0)
    refr_valid = sin2_t <= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    d_refr = vnormalize(vadd(vscale(eta, d_in), vscale(eta * r_cos_i - cos_t, n)))
    f_cos_i = torch.clamp(cos_i, 0.0, 1.0)
    f_sin2t = eta * eta * (1.0 - f_cos_i * f_cos_i)
    tir = f_sin2t > 1.0
    f_cos_t = torch.sqrt(torch.clamp(1.0 - f_sin2t, min=1e-12))
    r_par = (ior_t * f_cos_i - ior_i * f_cos_t) / (ior_t * f_cos_i + ior_i * f_cos_t)
    r_perp = (ior_i * f_cos_i - ior_t * f_cos_t) / (ior_i * f_cos_i + ior_t * f_cos_t)
    fres_r = torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))
    fres_r = torch.where(refr_valid, fres_r, 1.0)
    choose_reflect = u2 < fres_r
    d_dielectric = vwhere(choose_reflect, d_mirror, d_refr)

    is_refractive = mat["has_refractive"] > 0.0
    is_reflective = (~is_refractive) & (mat["has_reflective"] > 0.0)
    microfacet = "microfacet" in features
    is_ct = torch.zeros_like(is_reflective)
    if microfacet:
        is_ct = is_reflective & (mat["brdf_model"] > 0.5)
        d_ct, ct_weight = ggx_planes(mat, n, d_in, cos_i, u0, u1)
        if "ward" in features:
            is_ward = mat["brdf_model"] > 1.5
            d_wd, wd_weight = ward_planes(mat, n, d_in, cos_i, u0, u1)
            d_ct = vwhere(is_ward, d_wd, d_ct)
            ct_weight = vwhere(is_ward, wd_weight, ct_weight)
    is_glossy = is_reflective & (mat["spec_exp"] > 0.0) & (~is_ct)
    is_mirror = is_reflective & (~is_glossy) & (~is_ct)
    is_specular = is_refractive | is_reflective

    direction = vwhere(
        is_refractive,
        d_dielectric,
        vwhere(is_glossy, d_glossy, vwhere(is_mirror, d_mirror, d_diffuse)),
    )
    thr = vwhere(is_specular, mat["spec_color"], mat["color"])
    thr = vwhere(is_glossy, vscale(glossy_weight, thr), thr)
    if microfacet:
        direction = vwhere(is_refractive, d_dielectric, vwhere(is_ct, d_ct, direction))
        thr = vwhere(is_ct, ct_weight, thr)
    transmitted = is_refractive & (~choose_reflect) & refr_valid
    bias = torch.where(transmitted, -RAY_BIAS, RAY_BIAS)
    return dict(
        direction=direction,
        origin=vadd(p, vscale(bias, n)),
        throughput_mult=thr,
        is_specular=is_specular,
        transmitted=transmitted,
        entering=entering,
    )


def sample_lights(gtab, ltab, svals, u0, u1, u2, u3):
    """Area-weighted point on a light: position and normal in world space,
    emitted rgb, and the validity flag."""
    n_geoms = ltab.shape[0]
    lid = torch.zeros(u0.shape, dtype=torch.int64, device=u0.device)
    for c in ltab[:, 12].tolist():
        lid = lid + (u0 > c).to(torch.int64)
    lid = torch.clamp(lid, 0, n_geoms - 1)
    lrow = ltab[lid].unbind(-1)
    f, emit = lrow[0:12], lrow[13:16]
    sx, sy, sz = lrow[16:19]

    fa = (2.0 * sy * sz, 2.0 * sx * sz, 2.0 * sx * sy)
    ftot = torch.clamp(fa[0] + fa[1] + fa[2], min=1e-20)
    c0 = fa[0] / ftot
    c1 = (fa[0] + fa[1]) / ftot
    axis = (u1 > c0).to(torch.int64) + (u1 > c1).to(torch.int64)
    lo = u2 < 0.5
    side = torch.where(lo, -0.5, 0.5)
    cc1 = torch.where(lo, u2 * 2.0, (u2 - 0.5) * 2.0) - 0.5
    cc2 = u3 - 0.5
    ax0, ax1, ax2 = axis == 0, axis == 1, axis == 2
    p_cube = (
        torch.where(ax0, side, torch.where(ax1, cc2, cc1)),
        torch.where(ax1, side, torch.where(ax2, cc2, cc1)),
        torch.where(ax2, side, torch.where(ax0, cc2, cc1)),
    )
    sgn = torch.sign(side)
    n_cube = (
        torch.where(ax0, sgn, 0.0),
        torch.where(ax1, sgn, 0.0),
        torch.where(ax2, sgn, 0.0),
    )

    z = 1.0 - 2.0 * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u3
    n_s = (r * torch.cos(phi), r * torch.sin(phi), z)

    grow = gtab[lid].unbind(-1)
    l_is_sph = grow[12] == float(SPHERE)
    lp_obj = vwhere(l_is_sph, vscale(0.5, n_s), p_cube)
    ln_obj = vwhere(l_is_sph, n_s, n_cube)
    position = (
        f[0] * lp_obj[0] + f[1] * lp_obj[1] + f[2] * lp_obj[2] + f[3],
        f[4] * lp_obj[0] + f[5] * lp_obj[1] + f[6] * lp_obj[2] + f[7],
        f[8] * lp_obj[0] + f[9] * lp_obj[1] + f[10] * lp_obj[2] + f[11],
    )
    li = grow
    normal = vnormalize(
        (
            li[0] * ln_obj[0] + li[4] * ln_obj[1] + li[8] * ln_obj[2],
            li[1] * ln_obj[0] + li[5] * ln_obj[1] + li[9] * ln_obj[2],
            li[2] * ln_obj[0] + li[6] * ln_obj[1] + li[10] * ln_obj[2],
        )
    )
    return dict(position=position, normal=normal, emit=emit, valid=svals[1] > 0.5)


# ---------------------------------------------------------------------------
# the physics
# ---------------------------------------------------------------------------

def bounce_physics(
    o, d, throughput, sigma_a, sigma_s,
    gtab, mtab, ltab, svals,
    u, depth, prev_state,
    *, nee: bool, t_min: float, features=frozenset(),
    replay=None, emit_replay: bool = False, mesh=None,
    medium_g=None, vol_nee: bool = True, tex_defer: bool = False, mesh_in=None,
):
    """One bounce for a wavefront of lanes (mask-free: the caller gates with
    its alive mask).  ``o``/``d``/``throughput``/``sigma_a`` are 3-tuples
    of ``[N]`` float32, ``sigma_s`` and ``prev_state`` ``[N]``; ``gtab``,
    ``mtab``, ``ltab``, ``svals`` the packed tables; ``u`` the 11 uniform
    tensors of this (sample, depth); ``depth`` is the bounce index, an int
    or a per-lane ``[N]`` tensor (the wavefront engines' lanes are at mixed
    depths).

    Differentiable in the carries and in every table value: the sweep reads
    the geom rows as tensors, so the winner's distance, object-space ray and
    normal carry gradients to its row (the where-chain routes cotangents to
    the winner only).  The uniforms, ``depth``, ``prev_state``, the geom
    types and material ids, and every comparison are discrete.

    Winner replay (``bounce_pallas.py:929-966``): ``emit_replay=True`` adds
    ``replay_gid`` (winner geom as float, -1 = miss) and ``replay_nee_add``
    (the resolved NEE candidate-and-visible bit) to the result; passing
    them back as ``replay={"gid", "nee_add"}`` recomputes only the winner's
    intersection and skips the shadow sweep.  Both are comparisons, so the
    gradients are those of the sweep, and the recompute gives the sweep's
    values bit for bit.  Only the surface NEE is replayed: with
    ``volumetric`` the free path and the in-medium scatter follow from the
    recomputed winner, and the volumetric NEE's detached split sweep runs
    again, as JAX's vjp re-runs it (``:1375-1411``).

    ``mesh`` is the scene's ``ops/mesh_tables.KernelMeshes`` (or None): the
    in-kernel triangle sweep, as the module docstring says.  It takes no
    gradients and no replay.  ``mesh_in`` (or None) is a mesh winner found
    outside the bounce (kernel 2mm, ``bounce_pallas.py:1027-1036``): a dict
    of ``et`` (BIG = none), ``epo`` and ``en`` (3-tuples: the hit point in
    the mesh's object space, the unit world normal), ``emid`` and, with
    image textures, ``muv_u``, ``muv_v``, ``muvv`` (the authored UV and
    1.0 where it exists).  Under NEE the result then holds
    ``nee_deferred``: the shadow ray ``x``, ``wi``, its length ``dist``,
    the pending ``nee_rgb`` and ``cand_vis`` (1.0 where the connection is a
    candidate the analytic geoms leave visible), in place of the added
    term; volumetric NEE is not modelled there (the callers send such
    scenes to the split route).  With ``tex_defer`` and either mesh input,
    a mesh lane's UV is the box map of ``M^T n_world``, ``M`` the forward
    transform of the lane's analytic winner (geom 0 on an analytic miss),
    as JAX's kernel takes it (``:1088-1113``), and its authored UV where it
    has one.

    Participating media (``features`` with ``volumetric``,
    ``bounce_pallas.py:1140-1168,1323-1470``): ``sigma_a``/``sigma_s`` are
    the medium the ray travels through.  An exponential free path (from
    ``u[8]``) that ends before the surface is an in-medium scatter: no
    surface event, the continuation leaves the scatter point in the phase
    function's direction (``u[9]``, ``u[10]``: isotropic, or with ``hg``
    Henyey-Greenstein about ``d`` with the carried ``medium_g`` wherever it
    is nonzero), and with ``nee`` and ``vol_nee`` the light sample connects
    to the scatter point through the straight-line transmittance, with
    refractive geoms bounding the segment and opaque ones blocking (the
    shadow ray runs detached).  The segment travelled attenuates by
    Beer-Lambert either way, before emittance and NEE; a transmission into
    a material takes its medium, out of one back to vacuum.  Without
    ``volumetric`` the medium passes through.

    The surface features (``texture``, ``bump``, ``microfacet``, ``ward``)
    are selected per lane on the material columns, as the module docstring
    says; ``tex_defer`` (a scene with image textures, kernel 2's
    deferred-texel variant) adds ``tex_out``: the texture-scaled UV ``u``,
    ``v`` and the atlas ``slot`` (-1 where the lane has no image-textured
    surface event), whose texel the caller multiplies in.

    Returns a dict: contrib(3), next_o(3), next_d(3), thr_mult(3),
    terminate (bool), wspec (emit-state code), rru, out_ma(3), out_ms
    [, out_mg when ``medium_g`` is given] [, replay_gid, replay_nee_add]
    [, tex_out]."""
    check_features(features)
    if mesh is not None and mesh_in is not None:
        raise ValueError("mesh (the in-kernel tables) and mesh_in (an outside winner) exclude "
                         "each other")
    if (mesh is not None or mesh_in is not None) and (replay is not None or emit_replay):
        raise NotImplementedError(MESH_REPLAY_REFUSAL)
    has_vol = "volumetric" in features  # "hg" without "volumetric" is inert
    hg = has_vol and "hg" in features
    if hg and medium_g is None:
        raise ValueError("the hg feature needs the medium's phase g (medium_g)")
    gtypes = gtab[:, 12].tolist()  # host-side types: the sweep dispatches on them

    if replay is not None:
        rhit = replay["gid"] >= 0.0
        gid = torch.clamp(replay["gid"], min=0.0).to(torch.int64)
        win = gtab[gid].unbind(-1)
        t_win, obj = geom_t_lanes(win, *o, *d, t_min)
        best_t = torch.where(rhit, t_win, BIG)
        w = [torch.where(rhit, ob, 0.0) for ob in obj]
    else:
        best_t, gid, w = sweep(gtab, o, d, t_min)
        win = gtab[gid].unbind(-1)
    hit = best_t < BIG
    mid = torch.where(hit, win[13].to(torch.int64), 0)
    sph = hit & (win[12] == float(SPHERE))
    t_safe = torch.where(hit, best_t, 1.0)
    p = vadd(o, vscale(t_safe, d))
    p_obj = (w[0] + t_safe * w[3], w[1] + t_safe * w[4], w[2] + t_safe * w[5])

    normal = world_normal(win, object_normal(sph, p_obj))
    mh = mesh_in
    if mesh is not None:
        mh = mesh_sweep(mesh, gtab, o, d, want_uv=tex_defer and mesh.has_uv)
    if mh is not None:
        mb = mh["et"] < best_t
        best_t = torch.where(mb, mh["et"], best_t)
        mid = torch.where(mb, mh["emid"], mid)
        hit = best_t < BIG
        t_safe = torch.where(hit, best_t, 1.0)
        p = vadd(o, vscale(t_safe, d))
        p_obj = vwhere(mb, mh["epo"], p_obj)
        normal = vwhere(mb, mh["en"], normal)

    mat = material_fetch(mtab, mid)
    emissive = mat["emittance"] > 0.0

    # ---- procedural checker / stripes albedo in the object space (the
    # image-textured type 3 is the deferred texel's)
    if "texture" in features:
        cells = tuple(torch.floor(c * mat["texture_scale"]) for c in p_obj)
        checker = torch.remainder(cells[0] + cells[1] + cells[2], 2.0)
        stripes = torch.remainder(cells[0], 2.0)
        ttype = mat["texture_type"]
        pattern = torch.where(ttype > 1.5, stripes, checker)
        textured = (ttype > 0.5) & (ttype < 2.5) & (pattern > 0.5)
        mat["color"] = vwhere(textured, mat["texture_color2"], mat["color"])

    tex_out = None
    if tex_defer:
        # the deferred image texel's UV: the sphere's longitude / latitude,
        # the cube's face-local planar map (dominant |p_obj| axis)
        u_sph = atan2_planes(p_obj[2], p_obj[0]) * (1.0 / TWO_PI) + 0.5
        v_sph = asin_planes(torch.clamp(p_obj[1] * 2.0, -1.0, 1.0)) * INV_PI + 0.5
        sx, sy, sz = (torch.abs(c) for c in p_obj)
        if mh is not None:
            # a mesh lane's box map takes the dominant axis of M^T n_world,
            # M the forward rows of the analytic winner's light-table row
            f = ltab[gid].unbind(-1)
            nt = tuple(f[k] * normal[0] + f[4 + k] * normal[1] + f[8 + k] * normal[2]
                       for k in range(3))
            sx, sy, sz = (torch.where(mb, torch.abs(a), b) for a, b in zip(nt, (sx, sy, sz)))
        ax0 = (sx >= sy) & (sx >= sz)
        ax1 = (~ax0) & (sy >= sz)
        ax2 = (~ax0) & (~ax1)
        u_box = torch.where(ax0, p_obj[2], p_obj[0]) + 0.5
        v_box = torch.where(ax2, p_obj[1], torch.where(ax0, p_obj[1], p_obj[2])) + 0.5
        uv_u, uv_v = torch.where(sph, u_sph, u_box), torch.where(sph, v_sph, v_box)
        if mh is not None and "muvv" in mh:
            # the authored vt wins on the mesh lanes that have one
            auth = mb & (mh["muvv"] > 0.5)
            uv_u = torch.where(auth, mh["muv_u"], uv_u)
            uv_v = torch.where(auth, mh["muv_v"], uv_v)
        is_img = (mat["texture_type"] > 2.5) & hit
        tex_out = dict(
            u=uv_u * mat["texture_scale"],
            v=uv_v * mat["texture_scale"],
            slot=torch.where(is_img, mat["texture_image"], -1.0),
        )

    # ---- sinusoidal bump of the shading normal
    if "bump" in features:
        bump_on = mat["bump_scale"] > 0.0
        t1, t2 = not_axis_frame(normal)
        ph1 = p_obj[0] * 12.9898 + p_obj[1] * 78.233 + p_obj[2] * 37.719
        ph2 = p_obj[0] * 93.989 + p_obj[1] * 26.651 + p_obj[2] * 61.312
        amp = torch.where(bump_on, mat["bump_amp"], 0.0)
        n_bumped = vnormalize(vadd(normal, vadd(
            vscale(amp * torch.sin(mat["bump_scale"] * ph1), t1),
            vscale(amp * torch.sin(mat["bump_scale"] * ph2), t2))))
        normal = vwhere(bump_on, n_bumped, normal)

    # ---- volumetric free path and Beer-Lambert attenuation of the segment
    if has_vol:
        free_path = torch.where(
            sigma_s > 0.0,
            -torch.log(torch.clamp(1.0 - u[8], 1e-7, 1.0)) / torch.clamp(sigma_s, min=1e-12),
            1e30,
        )
        vol_scatter = hit & (free_path < best_t)
        if tex_out is not None:
            # a lane that scatters before its surface has no surface event
            tex_out["slot"] = torch.where(vol_scatter, -1.0, tex_out["slot"])
        seg = torch.where(vol_scatter, free_path, torch.where(hit, best_t, 0.0))
        atten = tuple(torch.exp(-a * seg) for a in sigma_a)
        throughput = vmul(throughput, atten)
        surface = ~vol_scatter
    else:
        surface = torch.ones_like(hit)

    emitted = vscale(mat["emittance"], vmul(throughput, mat["color"]))
    emit_mask = hit & emissive & surface
    if nee:
        # with NEE a light hit counts on primary rays and in state 1 (after
        # a specular event) only; ``depth`` is an int or a per-lane tensor
        after_specular = torch.abs(prev_state - 1.0) < 0.5
        if isinstance(depth, torch.Tensor):
            emit_mask = emit_mask & ((depth == 0) | after_specular)
        elif depth != 0:
            emit_mask = emit_mask & after_specular
    contrib = vwhere(emit_mask, emitted, (0.0, 0.0, 0.0))

    sc = sample_bsdf(mat, p, normal, d, u[0], u[1], u[2], features)

    add = ls = deferred = None
    if nee:
        ls = sample_lights(gtab, ltab, svals, u[4], u[5], u[6], u[7])
        n_shade = vscale(torch.sign(-vdot(normal, d)), normal)
        x = vadd(p, vscale(RAY_BIAS, n_shade))
        to_light = vsub(ls["position"], x)
        dist2 = vdot(to_light, to_light)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = vscale(1.0 / dist, to_light)
        cos_x = vdot(n_shade, wi)
        cos_y = -vdot(ls["normal"], wi)
        if replay is not None:
            add = replay["nee_add"] > 0.5
        else:
            diffuse_lane = hit & (~emissive) & (~sc["is_specular"]) & surface
            candidate = diffuse_lane & ls["valid"] & (cos_x > 0) & (cos_y > 0)
            # visibility is a comparison: the sweep runs detached
            occ_t = torch.full_like(o[0], BIG)
            xd, wd = tuple(c.detach() for c in x), tuple(c.detach() for c in wi)
            for g, row in enumerate(gtab.detach().unbind(0)):
                t_g, _ = geom_t(row, *xd, *wd, t_min, gtypes[g])
                occ_t = torch.minimum(occ_t, t_g)
            if mesh is not None:
                occ_t = torch.minimum(occ_t, mesh_occ(mesh, gtab.detach(), xd, wd))
            visible = occ_t >= dist.detach() - 4.0 * RAY_BIAS
            add = candidate & visible

        gterm = cos_x * cos_y / torch.clamp(dist2, min=1e-12)
        pdf_area = 1.0 / torch.clamp(svals[0], min=1e-20)
        nee_scale = gterm / torch.clamp(pdf_area, min=1e-20) * INV_PI
        nee_rgb = vscale(nee_scale, vmul(vmul(throughput, mat["color"]), ls["emit"]))
        if mesh_in is not None:
            # the triangles' occlusion is the caller's: min(analytic, mesh)
            # clears the bar exactly when both do
            deferred = dict(x=x, wi=wi, dist=dist, nee_rgb=nee_rgb,
                            cand_vis=torch.where(add, 1.0, 0.0))
            add = None
        else:
            contrib = vadd(contrib, vwhere(add, nee_rgb, (0.0, 0.0, 0.0)))

    surf_state = torch.where(
        sc["is_specular"],
        torch.where(torch.abs(prev_state - 2.0) < 0.5, 2.0, 1.0),
        0.0,
    )
    out = dict(
        contrib=contrib,
        next_o=sc["origin"],
        next_d=sc["direction"],
        thr_mult=sc["throughput_mult"],
        terminate=(~hit) | emissive,
        wspec=surf_state,
        rru=u[3],
        out_ma=sigma_a,
        out_ms=sigma_s,
    )
    if medium_g is not None:
        out["out_mg"] = medium_g
    if tex_out is not None:
        out["tex_out"] = tex_out
    if deferred is not None:
        out["nee_deferred"] = deferred
    if emit_replay:
        zero = torch.zeros_like(o[0])
        out["replay_gid"] = torch.where(hit, gid.to(torch.float32), -1.0)
        out["replay_nee_add"] = torch.where(add, 1.0, zero) if add is not None else zero
    if not has_vol:
        # vacuum transport: surface events only, the medium passes through
        return out

    # ---- in-medium scatter: the continuation from the scatter point
    vol_pos = vadd(o, vscale(free_path, d))
    vz = 1.0 - 2.0 * u[9]
    vr = torch.sqrt(torch.clamp(1.0 - vz * vz, min=0.0))
    vphi = TWO_PI * u[10]
    vol_dir = (vr * torch.cos(vphi), vr * torch.sin(vphi), vz)
    if hg:
        # Henyey-Greenstein about d, selected per lane against the uniform
        # sphere so that g == 0 lanes scatter as without the feature
        g_c = torch.clamp(medium_g, -0.999, 0.999)
        near0 = torch.abs(g_c) < 1e-3
        safe_g = torch.where(near0, 1.0, g_c)
        frac = (1.0 - g_c * g_c) / (1.0 - g_c + 2.0 * g_c * u[9])
        cos_hg = (1.0 + g_c * g_c - frac * frac) / (2.0 * safe_g)
        cos_t = torch.clamp(torch.where(near0, 1.0 - 2.0 * u[9], cos_hg), -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        hg_phi = TWO_PI * u[10]
        t1h, t2h = not_axis_frame(d)
        hg_dir = vadd(
            vscale(cos_t, d),
            vadd(vscale(sin_t * torch.cos(hg_phi), t1h), vscale(sin_t * torch.sin(hg_phi), t2h)),
        )
        vol_dir = vwhere(medium_g != 0.0, hg_dir, vol_dir)

    vol_state = torch.ones_like(o[0])
    if nee and vol_nee and mesh_in is None:
        # a lane that does not scatter has a ~1e30 free path: its NEE
        # geometry starts at the (finite) ray origin instead, and is masked
        vp = vwhere(vol_scatter, vol_pos, o)
        to_l = vsub(ls["position"], vp)
        d2v = vdot(to_l, to_l)
        distv = torch.sqrt(torch.clamp(d2v, min=1e-12))
        wiv = vscale(1.0 / distv, to_l)
        cos_yv = -vdot(ls["normal"], wiv)
        cand_v = vol_scatter & ls["valid"] & (cos_yv > 0)
        # the occlusion split runs detached: visibility is a comparison and
        # the boundary distance a constant of the transmittance
        vpd, wvd = tuple(c.detach() for c in vp), tuple(c.detach() for c in wiv)
        gtd, mtd = gtab.detach(), mtab.detach()
        refr = (mtd[gtd[:, 13].long(), 7] > 0.0).tolist()
        occ_op = torch.full_like(o[0], BIG)
        occ_re = torch.full_like(o[0], BIG)
        for g, row in enumerate(gtd.unbind(0)):
            t_g, _ = geom_t(row, *vpd, *wvd, t_min, gtypes[g])
            if refr[g]:
                occ_re = torch.minimum(occ_re, t_g)
            else:
                occ_op = torch.minimum(occ_op, t_g)
        if mesh is not None:
            m_op, m_re = mesh_occ_split(mesh, gtd, mtd, vpd, wvd)
            occ_op = torch.minimum(occ_op, m_op)
            occ_re = torch.minimum(occ_re, m_re)
        visible_v = occ_op >= distv.detach() - 4.0 * RAY_BIAS
        seg_v = torch.minimum(occ_re, distv)
        transmit = tuple(torch.exp(-(a + sigma_s) * seg_v) for a in sigma_a)
        cos_th = vdot(d, wiv)
        if hg:
            g_c = torch.clamp(medium_g, -0.999, 0.999)
            denomp = torch.clamp(1.0 + g_c * g_c - 2.0 * g_c * cos_th, min=1e-6)
            phase = (1.0 - g_c * g_c) / (4.0 * math.pi * denomp * torch.sqrt(denomp))
        else:
            phase = torch.full_like(cos_th, 1.0 / (4.0 * math.pi))
        pdf_area_v = 1.0 / torch.clamp(svals[0], min=1e-20)
        scale_v = (phase * cos_yv / torch.clamp(d2v, min=1e-12)
                   / torch.clamp(pdf_area_v, min=1e-20))
        vol_rgb = vscale(scale_v, vmul(vmul(throughput, transmit), ls["emit"]))
        add_v = cand_v & visible_v
        contrib = vadd(contrib, vwhere(add_v, vol_rgb, (0.0, 0.0, 0.0)))
        vol_state = torch.where(add_v, 2.0, 1.0)

    # a transmission enters the material's medium or leaves to vacuum
    tr, ent = sc["transmitted"], sc["entering"]
    surf_a = vwhere(tr, vwhere(ent, mat["absorption"], (0.0, 0.0, 0.0)), sigma_a)
    surf_s = torch.where(tr, torch.where(ent, mat["has_scatter"] * mat["scatter_coeff"], 0.0),
                         sigma_s)
    out.update(
        next_o=vwhere(vol_scatter, vol_pos, sc["origin"]),
        next_d=vwhere(vol_scatter, vol_dir, sc["direction"]),
        thr_mult=vwhere(vol_scatter, atten, vmul(atten, sc["throughput_mult"])),
        terminate=(~hit) | (emissive & (~vol_scatter)),
        out_ma=vwhere(vol_scatter, sigma_a, surf_a),
        out_ms=torch.where(vol_scatter, sigma_s, surf_s),
    )
    if medium_g is not None:
        surf_g = torch.where(tr, torch.where(ent, mat["phase_g"], 0.0), medium_g)
        out["out_mg"] = torch.where(vol_scatter, medium_g, surf_g)
    out.update(contrib=contrib, wspec=torch.where(vol_scatter, vol_state, surf_state))
    return out
