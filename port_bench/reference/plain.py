"""Plain reference: camera rays, the counter-hash RNG and the path tracer.

The benchmark's yardstick of what the program computes, in plain PyTorch
operations (one operation at a time, no kernel, no cache), in the order of
operations of the scene language's published path tracer: jittered pinhole
camera rays; per path and bounce eleven uniforms of the murmur3-finalizer
counter hash over (seed, sample index, bounce, slot); the nearest hit over
unit spheres and cubes placed by their inverse transforms; emittance under
the 0/1/2 emit-state code; Lambert, Phong-glossy, mirror and Fresnel
dielectric sampling; area-light next-event estimation with a shadow sweep;
and, with media, the exponential free path, Beer-Lambert attenuation,
isotropic in-medium scattering and its light connection through the
straight-line transmittance.  Analytic scenes of those materials only.

Every function takes the working float type ``dt``: float32 is the
reference, and a lower precision (bfloat16) is the control that the
comparison must fail.  The RNG's integer hash stays exact in int64 and its
24-bit uniforms are cast to ``dt``.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.scene import SPHERE

BIG = 1e30
T_MIN = 1e-4
RAY_BIAS = 2e-4
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
SQRT_ONE_THIRD = 0.5773502691896257
MASK32 = 0xFFFFFFFF
CAMERA_STREAM = 0x10000  # the RNG's depth slot of the camera draws
N_UNIFORMS = 11  # per path and bounce


# ---------------------------------------------------------------------------
# the counter-hash RNG (int64 holding uint32 values)
# ---------------------------------------------------------------------------

def _u32mul(x, c: int):
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _avalanche(x):
    x = x ^ (x >> 16)
    x = _u32mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _u32mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def key_seed(key) -> int:
    """The uint32 seed of a two-word key."""
    w0, w1 = (int(w) & MASK32 for w in key)
    return _avalanche(_u32mul(w0, 0x9E3779B9) ^ w1)


def uniforms(seed: int, sample_idx, depth: int, n: int, dt) -> list:
    """``n`` uniform planes in [0, 1) (24-bit) of (seed, sample, depth):
    bounce ``depth`` of a path, or ``CAMERA_STREAM`` for the camera's."""
    s = sample_idx.to(torch.int64) & MASK32
    d1 = (int(depth) + 1) & MASK32
    base = _avalanche((int(seed) & MASK32) ^ _u32mul(s, 0x85EBCA6B) ^ _u32mul(d1, 0xC2B2AE35))
    out = []
    for k in range(n):
        bits = _avalanche(base ^ ((k * 0x27D4EB2F) & MASK32))
        out.append(((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dt))
    return out


# ---------------------------------------------------------------------------
# vectors as 3-tuples of [N] tensors
# ---------------------------------------------------------------------------

def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


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


def sqrt0(x):
    """``sqrt(max(x, 0))`` with a zero gradient where ``x <= 0``."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _normalize3(v):
    return v / _norm3(v).clamp(min=1e-12)[..., None]


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def camera_rays(cam: dict, width: int, height: int, pixel, iteration, seed: int, dt,
                jitter: bool = True):
    """Primary rays ``(origin [N, 3], direction [N, 3])`` of ``pixel``
    (``x + y * width``) at progressive ``iteration`` (an int, or an int64
    tensor per lane), and the global sample indices
    ``iteration * W * H + pixel``.  ``cam`` holds tensors ``position``,
    ``view``, ``up``, ``fov`` (degrees), ``aperture``, ``focal``; the draws
    are the camera stream's four uniforms."""
    sample_idx = iteration * (width * height) + pixel.to(torch.int64)
    u4 = torch.stack(uniforms(seed, sample_idx, CAMERA_STREAM, 4, dt), dim=-1)
    x = (pixel % width).to(dt)
    y = torch.div(pixel, width, rounding_mode="floor").to(dt)
    if jitter:
        x = x + (u4[:, 0] - 0.5)
        y = y + (u4[:, 1] - 0.5)
    sx = x / (width - 1)
    sy = y / (height - 1)
    eye, view, up = (cam[k].to(dt) for k in ("position", "view", "up"))
    a = _cross3(view, up)
    b = _cross3(a, view)
    view_len = _norm3(view)
    fov_rad = cam["fov"].to(dt) * (math.pi / 180.0)
    a_hat = _normalize3(a)
    b_hat = _normalize3(b)
    half_x = a_hat * view_len * torch.tan(fov_rad[0])
    half_y = b_hat * view_len * torch.tan(-fov_rad[1])
    mid = eye + view
    point = (mid[None, :] + (2.0 * sx - 1.0)[:, None] * half_x[None, :]
             + (2.0 * sy - 1.0)[:, None] * half_y[None, :])
    direction = _normalize3(point - eye[None, :])
    origin = eye[None, :].expand_as(direction)
    aperture, focal_d = cam["aperture"].to(dt), cam["focal"].to(dt)
    focal = torch.where(focal_d > 0, focal_d, view_len)
    r = torch.sqrt(u4[:, 2]) * aperture
    theta = (2.0 * math.pi) * u4[:, 3]
    lens = ((r * torch.cos(theta))[:, None] * a_hat[None, :]
            + (r * torch.sin(theta))[:, None] * b_hat[None, :])
    cos_to_view = (direction * _normalize3(view)[None, :]).unbind(-1)
    cos_to_view = cos_to_view[0] + cos_to_view[1] + cos_to_view[2]
    focus = origin + direction * (focal / cos_to_view)[:, None]
    origin_dof = origin + lens
    dir_dof = _normalize3(focus - origin_dof)
    use_dof = aperture > 0
    origin = torch.where(use_dof, origin_dof, origin)
    direction = torch.where(use_dof, dir_dof, direction)
    return origin.contiguous(), direction.contiguous(), sample_idx


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------

def _safe_recip(x, eps=1e-12):
    return 1.0 / torch.where(torch.abs(x) < eps, torch.where(x >= 0, eps, -eps).to(x.dtype), x)


def _sphere_t(ox, oy, oz, dx, dy, dz):
    a = dx * dx + dy * dy + dz * dz
    b = ox * dx + oy * dy + oz * dz
    c = ox * ox + oy * oy + oz * oz - 0.25
    disc = b * b - a * c
    valid = disc > 0.0
    sq = torch.sqrt(torch.where(valid, disc, 1.0))
    inv_a = _safe_recip(a)
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    t = torch.where(t0 > T_MIN, t0, t1)
    return torch.where(valid & (t > T_MIN), t, BIG)


def _cube_t(ox, oy, oz, dx, dy, dz):
    ix, iy, iz = _safe_recip(dx), _safe_recip(dy), _safe_recip(dz)
    tlx, thx = (-0.5 - ox) * ix, (0.5 - ox) * ix
    tly, thy = (-0.5 - oy) * iy, (0.5 - oy) * iy
    tlz, thz = (-0.5 - oz) * iz, (0.5 - oz) * iz
    t_near = torch.maximum(torch.maximum(torch.minimum(tlx, thx), torch.minimum(tly, thy)),
                           torch.minimum(tlz, thz))
    t_far = torch.minimum(torch.minimum(torch.maximum(tlx, thx), torch.maximum(tly, thy)),
                          torch.maximum(tlz, thz))
    valid = (t_far >= t_near) & (t_far > T_MIN)
    t = torch.where(t_near > T_MIN, t_near, t_far)
    return torch.where(valid & (t > T_MIN), t, BIG)


def _to_object(m, ox, oy, oz, dx, dy, dz):
    return (m[0] * ox + m[1] * oy + m[2] * oz + m[3], m[4] * ox + m[5] * oy + m[6] * oz + m[7],
            m[8] * ox + m[9] * oy + m[10] * oz + m[11], m[0] * dx + m[1] * dy + m[2] * dz,
            m[4] * dx + m[5] * dy + m[6] * dz, m[8] * dx + m[9] * dy + m[10] * dz)


def geom_t(row, gtype: int, o, d):
    """One geom's distance (BIG = miss) and the object-space ray."""
    obj = _to_object(row.unbind(-1), *o, *d)
    return (_sphere_t if gtype == SPHERE else _cube_t)(*obj), obj


def nearest(gtab, gtypes, o, d):
    """``(best_t, gid, winner's object ray)``: strict ``<`` keeps the first
    minimum."""
    best_t = torch.full_like(o[0], BIG)
    gid = torch.zeros(o[0].shape, dtype=torch.int64, device=o[0].device)
    w = [torch.zeros_like(o[0]) for _ in range(6)]
    for g, row in enumerate(gtab.unbind(0)):
        t_g, obj = geom_t(row, gtypes[g], o, d)
        better = t_g < best_t
        best_t = torch.where(better, t_g, best_t)
        gid = torch.where(better, g, gid)
        w = [torch.where(better, ob, prev) for ob, prev in zip(obj, w)]
    return best_t, gid, w


def _object_normal(sph, p):
    ax, ay, az = (torch.abs(c) for c in p)
    fx = (ax >= ay) & (ax >= az)
    fy = (~fx) & (ay >= az)
    inv_len = torch.rsqrt(torch.clamp(p[0] * p[0] + p[1] * p[1] + p[2] * p[2], min=1e-24))
    return (torch.where(sph, p[0] * inv_len, torch.where(fx, torch.sign(p[0]), 0.0)),
            torch.where(sph, p[1] * inv_len, torch.where(fy, torch.sign(p[1]), 0.0)),
            torch.where(sph, p[2] * inv_len, torch.where((~fx) & (~fy), torch.sign(p[2]), 0.0)))


def _world_normal(m, n):
    w = (m[0] * n[0] + m[4] * n[1] + m[8] * n[2], m[1] * n[0] + m[5] * n[1] + m[9] * n[2],
         m[2] * n[0] + m[6] * n[1] + m[10] * n[2])
    inv = torch.rsqrt(torch.clamp(w[0] * w[0] + w[1] * w[1] + w[2] * w[2], min=1e-24))
    return (w[0] * inv, w[1] * inv, w[2] * inv)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _frame(n):
    use_x = torch.abs(n[0]) < SQRT_ONE_THIRD
    use_y = (~use_x) & (torch.abs(n[1]) < SQRT_ONE_THIRD)
    one, zero = torch.ones_like(n[0]), torch.zeros_like(n[0])
    not_n = (torch.where(use_x, one, zero), torch.where(use_y, one, zero),
             torch.where(use_x | use_y, zero, one))
    p1 = vnormalize(vcross(n, not_n))
    return p1, vnormalize(vcross(n, p1))


def _cosine_hemisphere(n, xi1, xi2):
    up = torch.sqrt(xi1)
    over = torch.sqrt(torch.clamp(1.0 - xi1, min=0.0))
    around = xi2 * TWO_PI
    p1, p2 = _frame(n)
    return vadd(vscale(up, n), vadd(vscale(torch.cos(around) * over, p1),
                                    vscale(torch.sin(around) * over, p2)))


def _rotate_about(axis, cos_angle, phi):
    sin_angle = sqrt0(1.0 - cos_angle * cos_angle)
    p1, p2 = _frame(axis)
    return vadd(vscale(cos_angle, axis), vadd(vscale(torch.cos(phi) * sin_angle, p1),
                                              vscale(torch.sin(phi) * sin_angle, p2)))


def rows(table, idx):
    """``table[idx]`` as a product with the one-hot rows of ``idx``: the
    same values exactly (one product by 1, the rest by 0), and a backward
    that sums each row's cotangent in a matrix product, where an indexed
    gather's backward serializes the many lanes that share a row.  Float32
    products stay float32 (TF32 off)."""
    return torch.nn.functional.one_hot(idx, table.shape[0]).to(table.dtype) @ table


def _material(mtab, mid):
    c = rows(mtab, mid).unbind(-1)
    return dict(color=(c[0], c[1], c[2]), spec_color=(c[3], c[4], c[5]), reflective=c[6],
                refractive=c[7], ior=c[8], emittance=c[9], spec_exp=c[10],
                absorption=(c[11], c[12], c[13]), scatter=c[14], scatter_coeff=c[15])


def _bsdf(mat, p, n_raw, d_in, u0, u1, u2):
    cos_raw = vdot(d_in, n_raw)
    entering = cos_raw < 0.0
    n = vwhere(entering, n_raw, vscale(-1.0, n_raw))
    cos_i = torch.abs(cos_raw)
    d_diffuse = _cosine_hemisphere(n, u0, u1)
    d_mirror = vsub(d_in, vscale(2.0 * vdot(d_in, n), n))
    exp_n = torch.clamp(mat["spec_exp"], min=1e-6)
    cos_alpha = torch.exp(torch.log(torch.clamp(u0, min=1e-9)) / (exp_n + 1.0))
    d_glossy = _rotate_about(d_mirror, cos_alpha, u1 * TWO_PI)
    glossy_cos = vdot(d_glossy, n)
    glossy_w = torch.where(glossy_cos > 0.0,
                           (exp_n + 2.0) / (exp_n + 1.0) * torch.clamp(glossy_cos, 0.0, 1.0), 0.0)
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
    fres = torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))
    fres = torch.where(refr_valid, fres, 1.0)
    reflect = u2 < fres
    d_dielectric = vwhere(reflect, d_mirror, d_refr)
    refractive = mat["refractive"] > 0.0
    reflective = (~refractive) & (mat["reflective"] > 0.0)
    glossy = reflective & (mat["spec_exp"] > 0.0)
    mirror = reflective & (~glossy)
    specular = refractive | reflective
    direction = vwhere(refractive, d_dielectric,
                       vwhere(glossy, d_glossy, vwhere(mirror, d_mirror, d_diffuse)))
    thr = vwhere(specular, mat["spec_color"], mat["color"])
    thr = vwhere(glossy, vscale(glossy_w, thr), thr)
    transmitted = refractive & (~reflect) & refr_valid
    bias = torch.where(transmitted, -RAY_BIAS, RAY_BIAS).to(u0.dtype)
    return dict(direction=direction, origin=vadd(p, vscale(bias, n)), thr=thr,
                specular=specular, transmitted=transmitted, entering=entering)


def _light_sample(gtab, ltab, svals, cdf, u0, u1, u2, u3):
    lid = torch.zeros(u0.shape, dtype=torch.int64, device=u0.device)
    for c in cdf:
        lid = lid + (u0 > c).to(torch.int64)
    lid = torch.clamp(lid, 0, ltab.shape[0] - 1)
    lrow = rows(ltab, lid).unbind(-1)
    f, emit = lrow[0:12], lrow[13:16]
    sx, sy, sz = lrow[16:19]
    fa = (2.0 * sy * sz, 2.0 * sx * sz, 2.0 * sx * sy)
    ftot = torch.clamp(fa[0] + fa[1] + fa[2], min=1e-20)
    c0 = fa[0] / ftot
    c1 = (fa[0] + fa[1]) / ftot
    axis = (u1 > c0).to(torch.int64) + (u1 > c1).to(torch.int64)
    lo = u2 < 0.5
    side = torch.where(lo, -0.5, 0.5).to(u2.dtype)
    cc1 = torch.where(lo, u2 * 2.0, (u2 - 0.5) * 2.0) - 0.5
    cc2 = u3 - 0.5
    ax0, ax1, ax2 = axis == 0, axis == 1, axis == 2
    p_cube = (torch.where(ax0, side, torch.where(ax1, cc2, cc1)),
              torch.where(ax1, side, torch.where(ax2, cc2, cc1)),
              torch.where(ax2, side, torch.where(ax0, cc2, cc1)))
    sgn = torch.sign(side)
    n_cube = (torch.where(ax0, sgn, 0.0), torch.where(ax1, sgn, 0.0), torch.where(ax2, sgn, 0.0))
    z = 1.0 - 2.0 * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u3
    n_s = (r * torch.cos(phi), r * torch.sin(phi), z)
    li = rows(gtab, lid).unbind(-1)
    sph = li[12] == float(SPHERE)
    lp = vwhere(sph, vscale(0.5, n_s), p_cube)
    ln = vwhere(sph, n_s, n_cube)
    position = (f[0] * lp[0] + f[1] * lp[1] + f[2] * lp[2] + f[3],
                f[4] * lp[0] + f[5] * lp[1] + f[6] * lp[2] + f[7],
                f[8] * lp[0] + f[9] * lp[1] + f[10] * lp[2] + f[11])
    normal = vnormalize((li[0] * ln[0] + li[4] * ln[1] + li[8] * ln[2],
                         li[1] * ln[0] + li[5] * ln[1] + li[9] * ln[2],
                         li[2] * ln[0] + li[6] * ln[1] + li[10] * ln[2]))
    return dict(position=position, normal=normal, emit=emit, valid=svals[1] > 0.5)


# ---------------------------------------------------------------------------
# one bounce and the path loop
# ---------------------------------------------------------------------------

def _occluded_t(gtab, gtypes, x, wi, keep):
    """Nearest distance along shadow rays over the geoms ``keep`` selects
    (all when None); runs detached, visibility being a comparison."""
    xd, wd = tuple(c.detach() for c in x), tuple(c.detach() for c in wi)
    t = torch.full_like(xd[0], BIG)
    for g, row in enumerate(gtab.detach().unbind(0)):
        if keep is None or keep[g]:
            t = torch.minimum(t, geom_t(row, gtypes[g], xd, wd)[0])
    return t


def bounce(o, d, thr, sig_a, sig_s, tabs, info, u, depth: int, prev_state, *, nee: bool,
           vol: bool, vol_nee: bool):
    """One bounce of every lane given (mask-free); returns the radiance
    increment, the continuation, the throughput factor, whether the path
    ends, the emit state and the medium carried on."""
    gtab, mtab, ltab, svals = tabs
    gtypes = info["gtypes"]
    best_t, gid, w = nearest(gtab, gtypes, o, d)
    win = rows(gtab, gid).unbind(-1)
    hit = best_t < BIG
    mid = torch.where(hit, win[13].to(torch.int64), 0)
    sph = hit & (win[12] == float(SPHERE))
    t_safe = torch.where(hit, best_t, 1.0)
    p = vadd(o, vscale(t_safe, d))
    p_obj = (w[0] + t_safe * w[3], w[1] + t_safe * w[4], w[2] + t_safe * w[5])
    normal = _world_normal(win, _object_normal(sph, p_obj))
    mat = _material(mtab, mid)
    emissive = mat["emittance"] > 0.0
    if vol:
        free_path = torch.where(
            sig_s > 0.0,
            -torch.log(torch.clamp(1.0 - u[8], 1e-7, 1.0)) / torch.clamp(sig_s, min=1e-12), 1e30)
        scatter = hit & (free_path < best_t)
        seg = torch.where(scatter, free_path, torch.where(hit, best_t, 0.0))
        atten = tuple(torch.exp(-a * seg) for a in sig_a)
        thr = vmul(thr, atten)
        surface = ~scatter
    else:
        surface = torch.ones_like(hit)
    emitted = vscale(mat["emittance"], vmul(thr, mat["color"]))
    emit_mask = hit & emissive & surface
    if nee and depth != 0:
        emit_mask = emit_mask & (torch.abs(prev_state - 1.0) < 0.5)
    contrib = vwhere(emit_mask, emitted, (0.0, 0.0, 0.0))
    sc = _bsdf(mat, p, normal, d, u[0], u[1], u[2])
    ls = None
    if nee:
        ls = _light_sample(gtab, ltab, svals, info["cdf"], u[4], u[5], u[6], u[7])
        n_shade = vscale(torch.sign(-vdot(normal, d)), normal)
        x = vadd(p, vscale(RAY_BIAS, n_shade))
        to_light = vsub(ls["position"], x)
        dist2 = vdot(to_light, to_light)
        dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
        wi = vscale(1.0 / dist, to_light)
        cos_x = vdot(n_shade, wi)
        cos_y = -vdot(ls["normal"], wi)
        diffuse = hit & (~emissive) & (~sc["specular"]) & surface
        candidate = diffuse & ls["valid"] & (cos_x > 0) & (cos_y > 0)
        visible = _occluded_t(gtab, gtypes, x, wi, None) >= dist.detach() - 4.0 * RAY_BIAS
        add = candidate & visible
        gterm = cos_x * cos_y / torch.clamp(dist2, min=1e-12)
        pdf_area = 1.0 / torch.clamp(svals[0], min=1e-20)
        scale = gterm / torch.clamp(pdf_area, min=1e-20) * INV_PI
        rgb = vscale(scale, vmul(vmul(thr, mat["color"]), ls["emit"]))
        contrib = vadd(contrib, vwhere(add, rgb, (0.0, 0.0, 0.0)))
    surf_state = torch.where(sc["specular"],
                             torch.where(torch.abs(prev_state - 2.0) < 0.5, 2.0, 1.0), 0.0)
    surf_state = surf_state.to(prev_state.dtype)
    out = dict(contrib=contrib, next_o=sc["origin"], next_d=sc["direction"], thr_mult=sc["thr"],
               terminate=(~hit) | emissive, wspec=surf_state, rru=u[3], sig_a=sig_a, sig_s=sig_s)
    if not vol:
        return out
    vol_pos = vadd(o, vscale(free_path, d))
    vz = 1.0 - 2.0 * u[9]
    vr = torch.sqrt(torch.clamp(1.0 - vz * vz, min=0.0))
    vphi = TWO_PI * u[10]
    vol_dir = (vr * torch.cos(vphi), vr * torch.sin(vphi), vz)
    vol_state = torch.ones_like(o[0])
    if nee and vol_nee:
        vp = vwhere(scatter, vol_pos, o)
        to_l = vsub(ls["position"], vp)
        d2v = vdot(to_l, to_l)
        distv = torch.sqrt(torch.clamp(d2v, min=1e-12))
        wiv = vscale(1.0 / distv, to_l)
        cos_yv = -vdot(ls["normal"], wiv)
        cand_v = scatter & ls["valid"] & (cos_yv > 0)
        refr = info["refr"]
        occ_op = _occluded_t(gtab, gtypes, vp, wiv, [not r for r in refr])
        occ_re = _occluded_t(gtab, gtypes, vp, wiv, refr)
        visible_v = occ_op >= distv.detach() - 4.0 * RAY_BIAS
        seg_v = torch.minimum(occ_re, distv)
        transmit = tuple(torch.exp(-(a + sig_s) * seg_v) for a in sig_a)
        phase = torch.full_like(d2v, 1.0 / (4.0 * math.pi))
        pdf_v = 1.0 / torch.clamp(svals[0], min=1e-20)
        scale_v = phase * cos_yv / torch.clamp(d2v, min=1e-12) / torch.clamp(pdf_v, min=1e-20)
        vol_rgb = vscale(scale_v, vmul(vmul(thr, transmit), ls["emit"]))
        add_v = cand_v & visible_v
        contrib = vadd(contrib, vwhere(add_v, vol_rgb, (0.0, 0.0, 0.0)))
        vol_state = torch.where(add_v, 2.0, 1.0).to(vol_state.dtype)
    tr, ent = sc["transmitted"], sc["entering"]
    surf_a = vwhere(tr, vwhere(ent, mat["absorption"], (0.0, 0.0, 0.0)), sig_a)
    surf_s = torch.where(tr, torch.where(ent, mat["scatter"] * mat["scatter_coeff"], 0.0), sig_s)
    out.update(next_o=vwhere(scatter, vol_pos, sc["origin"]),
               next_d=vwhere(scatter, vol_dir, sc["direction"]),
               thr_mult=vwhere(scatter, atten, vmul(atten, sc["thr"])),
               terminate=(~hit) | (emissive & (~scatter)),
               sig_a=vwhere(scatter, sig_a, surf_a), sig_s=torch.where(scatter, sig_s, surf_s),
               contrib=contrib, wspec=torch.where(scatter, vol_state, surf_state))
    return out


def table_info(tabs) -> dict:
    """Host copies of what the sweeps dispatch on: each geom's type, the
    light-pick CDF, and which geoms are refractive."""
    gtab, mtab, ltab, _ = (t.detach().float() for t in tabs)
    return dict(gtypes=[int(t) for t in gtab[:, 12].tolist()],
                cdf=ltab[:, 12].tolist(),
                refr=(mtab[gtab[:, 13].long(), 7] > 0.0).tolist())


def trace(tabs, info, seed: int, origin, direction, sample_idx, *, max_depth: int, nee: bool,
          vol: bool, vol_nee: bool):
    """Paths of every primary ray to their end: ``(radiance [N, 3],
    rays traced int64 [])``, the rays counted as the live lanes of each
    bounce, twice that with NEE (the shadow ray).  Each bounce runs on the
    lanes still alive; a path that ends keeps what it gathered."""
    dt = origin.dtype
    n = origin.shape[0]
    o, d = tuple(origin.unbind(-1)), tuple(direction.unbind(-1))
    ones = torch.ones(n, dtype=dt, device=origin.device)
    thr = (ones, ones, ones)
    prev_state = torch.zeros_like(ones)
    sig_a = (torch.zeros_like(ones),) * 3
    sig_s = torch.zeros_like(ones)
    radiance = torch.zeros((n, 3), dtype=dt, device=origin.device)
    lanes = torch.arange(n, device=origin.device)
    nrays = torch.zeros((), dtype=torch.int64, device=origin.device)
    for dep in range(max_depth):
        if lanes.numel() == 0:
            break
        nrays = nrays + lanes.numel() * (2 if nee else 1)
        u = uniforms(seed, sample_idx[lanes], dep, N_UNIFORMS, dt)
        out = bounce(o, d, thr, sig_a, sig_s, tabs, info, u, dep, prev_state, nee=nee, vol=vol,
                     vol_nee=vol_nee)
        alive = ~out["terminate"]
        radiance = radiance.index_add(0, lanes, torch.stack(out["contrib"], dim=-1))
        thr = tuple(torch.where(alive, t * m, t) for t, m in zip(thr, out["thr_mult"]))
        keep = alive.nonzero()[:, 0]
        lanes = lanes[keep]
        prev_state = out["wspec"][keep]
        o = tuple(c[keep] for c in out["next_o"])
        d = tuple(c[keep] for c in out["next_d"])
        thr = tuple(c[keep] for c in thr)
        sig_a = tuple(c[keep] for c in out["sig_a"])
        sig_s = out["sig_s"][keep]
    return radiance, nrays


GAMMA = 1.0 / 2.2


def tonemap(accum, iterations: int):
    """The progressive average, gamma 1/2.2, clamped to [0, 1]."""
    img = torch.clamp(accum / max(float(iterations), 1.0), min=0.0) ** GAMMA
    return torch.clamp(img, 0.0, 1.0)
