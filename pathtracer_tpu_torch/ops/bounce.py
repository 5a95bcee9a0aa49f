"""One bounce of path-tracing physics, in plain PyTorch.

Port of ``pathtracer_tpu/ops/bounce_pallas.py`` for the base physics: the
vector helpers (``:60-98``), the table packers (``:143-188``: 28-column
material table, 19-column light table, 2 scalars), ``_material_fetch``
(``:544``), ``_not_axis_frame`` / ``_cosine_hemisphere`` /
``_rotate_about`` (``:607-644``), ``_sample_bsdf_planes`` (``:709-795``),
``_sample_lights_planes`` (``:798-861``) and ``bounce_physics``
(``:881-1321``), with ``RAY_BIAS`` from ``pathtracer_tpu/ops/bsdf.py:33``.

This is the plain version of the trace kernel's loop body
(``csrc/trace.cu``): nearest hit with the first minimum winning,
argmax-|coord| cube normals, inverse-transpose world normals, emittance
under the 0/1/2 emit-state code, Lambert / Phong-glossy / mirror / Fresnel
dielectric sampling, and area-light NEE with a shadow sweep.  Vectors are
tuples of three ``[N]`` tensors.  The JAX kernel selects table rows with
where-chains over every geom and material (the TPU has no vector gather);
here they are gathers with the same result.

The optional blocks (texture, bump, volumetric, microfacet, ward, hg),
meshes, deferred texels and winner replay belong to later slices and raise
``NotImplementedError``.  ``glossy`` is not gated in the JAX kernel either.
"""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.ops.intersect import BIG, geom_t, pack_geom_table
from pathtracer_tpu_torch.ops.lights import axis_scales, light_areas
from pathtracer_tpu_torch.scene.structs import SPHERE, Scene

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
RAY_BIAS = 2e-4
SQRT_ONE_THIRD = 0.5773502691896257

MAT_COLS = 28
LIGHT_COLS = 19

# features this slice models; "glossy" is always on in the kernel body
SUPPORTED_FEATURES = frozenset({"glossy"})


def check_features(features) -> None:
    missing = sorted(set(features) - SUPPORTED_FEATURES)
    if missing:
        raise NotImplementedError(
            f"feature(s) {', '.join(missing)} of the bounce physics: later slice"
        )


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
    )


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
    sin_angle = torch.sqrt(torch.clamp(1.0 - cos_angle * cos_angle, min=0.0))
    p1, p2 = not_axis_frame(axis_dir)
    return vadd(
        vscale(cos_angle, axis_dir),
        vadd(
            vscale(torch.cos(phi) * sin_angle, p1),
            vscale(torch.sin(phi) * sin_angle, p2),
        ),
    )


def sample_bsdf(mat, p, n_raw, d_in, u0, u1, u2):
    """Continuation ray: diffuse, Phong glossy, mirror or Fresnel glass."""
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
    is_glossy = is_reflective & (mat["spec_exp"] > 0.0)
    is_mirror = is_reflective & (~is_glossy)
    is_specular = is_refractive | is_reflective

    direction = vwhere(
        is_refractive,
        d_dielectric,
        vwhere(is_glossy, d_glossy, vwhere(is_mirror, d_mirror, d_diffuse)),
    )
    thr = vwhere(is_specular, mat["spec_color"], mat["color"])
    thr = vwhere(is_glossy, vscale(glossy_weight, thr), thr)
    transmitted = is_refractive & (~choose_reflect) & refr_valid
    bias = torch.where(transmitted, -RAY_BIAS, RAY_BIAS)
    return dict(
        direction=direction,
        origin=vadd(p, vscale(bias, n)),
        throughput_mult=thr,
        is_specular=is_specular,
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
    u, depth: int, prev_state,
    *, nee: bool, t_min: float, features=frozenset(),
):
    """One bounce for a wavefront of lanes (mask-free: the caller gates with
    its alive mask).  ``o``/``d``/``throughput``/``sigma_a`` are 3-tuples
    of ``[N]`` float32, ``sigma_s`` and ``prev_state`` ``[N]``; ``gtab``,
    ``mtab``, ``ltab``, ``svals`` the packed tables; ``u`` the 11 uniform
    tensors of this (sample, depth).

    Returns a dict: contrib(3), next_o(3), next_d(3), thr_mult(3),
    terminate (bool), wspec (emit-state code), rru, out_ma(3), out_ms."""
    check_features(features)
    gvals = gtab.tolist()

    best_t = torch.full_like(o[0], BIG)
    gid = torch.zeros(o[0].shape, dtype=torch.int64, device=o[0].device)
    w = [torch.zeros_like(o[0]) for _ in range(6)]
    for g in range(len(gvals)):
        t_g, obj = geom_t(gvals[g], *o, *d, t_min)
        better = t_g < best_t
        best_t = torch.where(better, t_g, best_t)
        gid = torch.where(better, g, gid)
        w = [torch.where(better, ob, prev) for ob, prev in zip(obj, w)]
    hit = best_t < BIG
    win = gtab[gid].unbind(-1)
    mid = torch.where(hit, win[13].to(torch.int64), 0)
    sph = hit & (win[12] == float(SPHERE))
    t_safe = torch.where(hit, best_t, 1.0)
    p = vadd(o, vscale(t_safe, d))
    p_obj = (w[0] + t_safe * w[3], w[1] + t_safe * w[4], w[2] + t_safe * w[5])

    axx, axy, axz = (torch.abs(c) for c in p_obj)
    fx = (axx >= axy) & (axx >= axz)
    fy = (~fx) & (axy >= axz)
    inv_len = torch.rsqrt(torch.clamp(vdot(p_obj, p_obj), min=1e-24))
    n_obj = (
        torch.where(sph, p_obj[0] * inv_len, torch.where(fx, torch.sign(p_obj[0]), 0.0)),
        torch.where(sph, p_obj[1] * inv_len, torch.where(fy, torch.sign(p_obj[1]), 0.0)),
        torch.where(
            sph, p_obj[2] * inv_len,
            torch.where((~fx) & (~fy), torch.sign(p_obj[2]), 0.0),
        ),
    )
    m = win
    normal = vnormalize(
        (
            m[0] * n_obj[0] + m[4] * n_obj[1] + m[8] * n_obj[2],
            m[1] * n_obj[0] + m[5] * n_obj[1] + m[9] * n_obj[2],
            m[2] * n_obj[0] + m[6] * n_obj[1] + m[10] * n_obj[2],
        )
    )

    mat = material_fetch(mtab, mid)
    emissive = mat["emittance"] > 0.0

    emitted = vscale(mat["emittance"], vmul(throughput, mat["color"]))
    emit_mask = hit & emissive
    if nee and depth != 0:
        # with NEE only state 1 (after a specular event) counts a light hit
        emit_mask = emit_mask & (torch.abs(prev_state - 1.0) < 0.5)
    contrib = vwhere(emit_mask, emitted, (0.0, 0.0, 0.0))

    sc = sample_bsdf(mat, p, normal, d, u[0], u[1], u[2])

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
        diffuse_lane = hit & (~emissive) & (~sc["is_specular"])
        candidate = diffuse_lane & ls["valid"] & (cos_x > 0) & (cos_y > 0)

        occ_t = torch.full_like(o[0], BIG)
        for g in range(len(gvals)):
            t_g, _ = geom_t(gvals[g], *x, *wi, t_min)
            occ_t = torch.minimum(occ_t, t_g)
        visible = occ_t >= dist - 4.0 * RAY_BIAS

        gterm = cos_x * cos_y / torch.clamp(dist2, min=1e-12)
        pdf_area = 1.0 / torch.clamp(svals[0], min=1e-20)
        nee_scale = gterm / torch.clamp(pdf_area, min=1e-20) * INV_PI
        nee_rgb = vscale(nee_scale, vmul(vmul(throughput, mat["color"]), ls["emit"]))
        contrib = vadd(contrib, vwhere(candidate & visible, nee_rgb, (0.0, 0.0, 0.0)))

    surf_state = torch.where(
        sc["is_specular"],
        torch.where(torch.abs(prev_state - 2.0) < 0.5, 2.0, 1.0),
        0.0,
    )
    return dict(
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
