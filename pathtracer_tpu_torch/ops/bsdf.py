"""BSDF sampling of the split per-bounce route: diffuse, Phong glossy,
mirror, Fresnel glass and the Cook-Torrance GGX and Ward lobes.

Port of ``pathtracer_tpu/ops/bsdf.py``: ``RAY_BIAS``, ``MaterialLookup``
and ``gather_materials`` (``:33-118``), ``cosine_hemisphere``,
``_rotate_about``, the in-medium phase functions ``uniform_sphere``,
``hg_phase_value`` and ``henyey_greenstein`` (``:178-223``), ``reflect``,
``refract``, ``fresnel_dielectric`` (``:125-262``), ``ggx_sample``,
``_kutz_frame`` and ``ward_sample`` (``:276-377``) and ``sample_bsdf``
(``:378-512``) on ``[N, 3]`` tensors,
in the JAX package's order of operations.  The JAX gather is a one-hot
matmul at full precision; here it is a row gather with the same values.
JAX's integer powers (``x ** 5``, ``x ** 3``) lower to repeated
multiplication, ``x * ((x * x) * (x * x))`` and ``x * (x * x)``; they are
written out so.  Discrete choices (the dielectric's reflect-or-transmit) are
taken on detached values, as there.  A lobe's square root of a clamped
quantity is :func:`sqrt0`: the same value, and a zero gradient where the
quantity is not positive.

The fused route's plain version (``ops/bounce.py:sample_bsdf``, on
component tuples) computes the same lobes in the TPU kernel's order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

SQRT_ONE_THIRD = 0.5773502691896257
RAY_BIAS = 2e-4


def sqrt0(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(x, 0))`` with a zero gradient where ``x <= 0``.

    The value is ``torch.sqrt(torch.clamp(x, min=0))``'s.  Their gradient
    there is infinite, and NaN under a zero cotangent.  The lobes meet such
    points on a lane the lobe did not take (a self-shadowed Ward sample: a
    zero ``cos_o``; a miss's zero normal), where the NaN reaches the
    tables through the lane's normal.  They meet them on a lane it took
    where the sampled angle rounds to zero (``sin_th`` of Ward, the sine
    of ``_rotate_about``).  The kernels' adjoints pass zero there too."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


@dataclasses.dataclass(frozen=True)
class MaterialLookup:
    """Per-ray material fields, gathered from the ``[M, 28]`` table of
    ``ops/bounce.pack_material_table``."""

    color: torch.Tensor  # [N, 3]
    specular_color: torch.Tensor  # [N, 3]
    has_reflective: torch.Tensor  # [N]
    has_refractive: torch.Tensor  # [N]
    ior: torch.Tensor  # [N]
    emittance: torch.Tensor  # [N]
    specular_exponent: torch.Tensor  # [N] Phong exponent (0 => ideal mirror)
    absorption: torch.Tensor  # [N, 3]
    has_scatter: torch.Tensor  # [N]
    scatter_coeff: torch.Tensor  # [N]
    texture_type: torch.Tensor  # [N]
    texture_scale: torch.Tensor  # [N]
    texture_color2: torch.Tensor  # [N, 3]
    bump_scale: torch.Tensor  # [N]
    bump_amp: torch.Tensor  # [N]
    texture_image: torch.Tensor  # [N]
    brdf_model: torch.Tensor  # [N]
    roughness: torch.Tensor  # [N]
    roughness_y: torch.Tensor  # [N]
    phase_g: torch.Tensor  # [N]


class _GatherRows(torch.autograd.Function):
    """``torch.index_select(table, 0, idx)`` whose backward adds the lanes'
    cotangents into their rows with ``index_add_`` in float64 and rounds
    once.  Hundreds of thousands of lanes share a row: added in float32
    (``index_select``'s own backward, atomics on the card) they round at
    every add, in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros((ctx.rows, *grad.shape[1:]), dtype=torch.float64, device=grad.device)
        return acc.index_add_(0, idx, grad.double()).to(grad.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each lane's row ``table[idx]`` (``idx`` detached), its backward
    summed per row in float64 (:class:`_GatherRows`)."""
    return _GatherRows.apply(table, idx.detach().long())


def gather_materials(mtab: torch.Tensor, material_id: torch.Tensor) -> MaterialLookup:
    """Rows of the material table per ray (``material_id`` detached),
    gathered with :func:`gather_rows`."""
    rows = gather_rows(mtab, material_id)
    return MaterialLookup(
        color=rows[:, 0:3],
        specular_color=rows[:, 3:6],
        has_reflective=rows[:, 6],
        has_refractive=rows[:, 7],
        ior=rows[:, 8],
        emittance=rows[:, 9],
        specular_exponent=rows[:, 10],
        absorption=rows[:, 11:14],
        has_scatter=rows[:, 14],
        scatter_coeff=rows[:, 15],
        texture_type=rows[:, 16],
        texture_scale=rows[:, 17],
        texture_color2=rows[:, 18:21],
        bump_scale=rows[:, 21],
        bump_amp=rows[:, 22],
        texture_image=rows[:, 23],
        brdf_model=rows[:, 24],
        roughness=rows[:, 25],
        roughness_y=rows[:, 26],
        phase_g=rows[:, 27],
    )


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=1e-12)[..., None]


def _kutz_frame(axis_dir):
    """Tangent frame about ``axis_dir`` by the not-normal-axis trick."""
    ax = torch.abs(axis_dir)
    use_x = ax[..., 0] < SQRT_ONE_THIRD
    use_y = (~use_x) & (ax[..., 1] < SQRT_ONE_THIRD)
    one, zero = torch.ones_like(ax[..., 0]), torch.zeros_like(ax[..., 0])
    not_axis = torch.stack(
        [torch.where(use_x, one, zero), torch.where(use_y, one, zero),
         torch.where(use_x | use_y, zero, one)],
        dim=-1,
    )
    t1 = _normalize(torch.linalg.cross(axis_dir, not_axis, dim=-1))
    t2 = _normalize(torch.linalg.cross(axis_dir, t1, dim=-1))
    return t1, t2


def cosine_hemisphere(normal, xi1, xi2):
    """Cosine-weighted direction about ``normal``."""
    up = torch.sqrt(xi1)
    over = torch.sqrt(torch.clamp(1.0 - xi1, min=0.0))
    around = xi2 * 2.0 * math.pi
    perp1, perp2 = _kutz_frame(normal)
    return (
        up[..., None] * normal
        + (torch.cos(around) * over)[..., None] * perp1
        + (torch.sin(around) * over)[..., None] * perp2
    )


def _rotate_about(axis_dir, cos_angle, phi):
    """Direction at ``acos(cos_angle)`` from ``axis_dir``, azimuth ``phi``."""
    sin_angle = sqrt0(1.0 - cos_angle**2)
    p1, p2 = _kutz_frame(axis_dir)
    return (
        cos_angle[..., None] * axis_dir
        + (torch.cos(phi) * sin_angle)[..., None] * p1
        + (torch.sin(phi) * sin_angle)[..., None] * p2
    )


def uniform_sphere(xi1, xi2):
    """Uniform direction on the unit sphere, ``[N, 3]``: the isotropic
    in-medium scatter."""
    z = 1.0 - 2.0 * xi1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * xi2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def hg_phase_value(g, cos_theta):
    """Henyey-Greenstein phase function value (1/sr); the isotropic
    ``1 / (4 pi)`` at g = 0.  Volumetric NEE weighs the light connection
    with it."""
    g = torch.clamp(g, -0.999, 0.999)
    denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_theta, min=1e-6)
    return (1.0 - g * g) / (4.0 * math.pi * denom * torch.sqrt(denom))


def henyey_greenstein(direction, g, xi1, xi2):
    """Direction sampled from the Henyey-Greenstein phase function about
    the propagation ``direction`` (``[N, 3]``), by exact inversion of its
    cosine; below |g| < 1e-3 the uniform sphere's ``1 - 2 xi1`` stands in
    for the division that loses precision there.  The sample follows the
    phase function exactly, so the throughput does not change."""
    g = torch.clamp(g, -0.999, 0.999)
    near0 = torch.abs(g) < 1e-3
    safe_g = torch.where(near0, 1.0, g)  # divisor placeholder
    frac = (1.0 - g * g) / (1.0 - g + 2.0 * g * xi1)
    cos_hg = (1.0 + g * g - frac * frac) / (2.0 * safe_g)
    cos_t = torch.clamp(torch.where(near0, 1.0 - 2.0 * xi1, cos_hg), -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * xi2
    t1, t2 = _kutz_frame(direction)
    return (
        cos_t[..., None] * direction
        + (sin_t * torch.cos(phi))[..., None] * t1
        + (sin_t * torch.sin(phi))[..., None] * t2
    )


def reflect(incident, normal):
    return incident - 2.0 * _dot(incident, normal)[..., None] * normal


def refract(incident, normal, eta):
    """Snell transmission: ``(direction, valid)``, ``valid`` False under
    total internal reflection.  ``normal`` opposes ``incident``."""
    cos_i = -_dot(incident, normal)
    sin2_t = (eta**2) * torch.clamp(1.0 - cos_i**2, min=0.0)
    valid = sin2_t <= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    d = eta[..., None] * incident + (eta * cos_i - cos_t)[..., None] * normal
    return _normalize(d), valid


def fresnel_dielectric(cos_i, ior_i, ior_t):
    """Unpolarized Fresnel reflectance in [0, 1]; 1 under total internal
    reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    eta = ior_i / ior_t
    sin2_t = (eta**2) * (1.0 - cos_i**2)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=1e-12))
    r_par = (ior_t * cos_i - ior_i * cos_t) / (ior_t * cos_i + ior_i * cos_t)
    r_perp = (ior_i * cos_i - ior_t * cos_t) / (ior_i * cos_i + ior_t * cos_t)
    return torch.where(tir, 1.0, 0.5 * (r_par**2 + r_perp**2))


@dataclasses.dataclass(frozen=True)
class ScatterSample:
    direction: torch.Tensor  # [N, 3] next ray direction
    origin: torch.Tensor  # [N, 3] next ray origin (bias applied)
    throughput_mult: torch.Tensor  # [N, 3]
    is_specular: torch.Tensor  # [N] bool (mirror / glossy / dielectric)
    transmitted: torch.Tensor  # [N] bool: dielectric transmission
    entering: torch.Tensor  # [N] bool: the ray came from outside


def ggx_sample(n, incident, cos_i, roughness, spec_color, xi1, xi2):
    """Cook-Torrance lobe (GGX distribution, Smith G, Schlick Fresnel):
    ``(direction [N, 3], weight [N, 3])``, the half-vector sampling
    estimator ``F G (wo.h) / (cos_i cos_h)``, zero for self-shadowed
    samples; ``alpha = roughness^2``."""
    alpha = torch.clamp(roughness * roughness, 1e-4, 1.0)
    a2 = alpha * alpha
    xi1 = torch.clamp(xi1, 1e-7, 1.0 - 1e-7)
    cos_h = torch.sqrt(torch.clamp((1.0 - xi1) / (1.0 + (a2 - 1.0) * xi1), 0.0, 1.0))
    h = _rotate_about(n, cos_h, xi2 * 2.0 * math.pi)
    d = reflect(incident, h)
    wo_dot_h = -_dot(incident, h)
    cos_o = _dot(d, n)
    valid = (cos_o > 0.0) & (wo_dot_h > 0.0)

    def g1(c):
        c = torch.clamp(c, 1e-6, 1.0)
        return 2.0 * c / (c + torch.sqrt(a2 + (1.0 - a2) * c * c))

    g = g1(torch.clamp(cos_i, 1e-6, 1.0)) * g1(cos_o)
    x = torch.clamp(1.0 - wo_dot_h, min=0.0)
    f5 = x * ((x * x) * (x * x))
    f = spec_color + (1.0 - spec_color) * f5[..., None]
    w = g * wo_dot_h / torch.clamp(torch.clamp(cos_i, 1e-6, 1.0) * cos_h, min=1e-6)
    return d, torch.where(valid[..., None], f * w[..., None], 0.0)


def ward_sample(n, incident, cos_i, alpha_x, alpha_y, spec_color, xi1, xi2):
    """Ward anisotropic lobe with Walter's half-vector sampling (TR
    nvrt-2005, eqs. 6-9): ``(direction, weight)``, weight ``rho_s (wi.h)
    (n.h)^3 sqrt(cos_o / cos_i)``.  The anisotropy axes are the Kutz frame
    of ``n``; ``alpha_y <= 0`` is the isotropic case."""
    ax_ = torch.clamp(alpha_x, 1e-3, 1.0)
    ay_ = torch.clamp(torch.where(alpha_y > 0.0, alpha_y, alpha_x), 1e-3, 1.0)
    xi1 = torch.clamp(xi1, 1e-7, 1.0 - 1e-7)
    beta = 2.0 * math.pi * xi2
    cb, sb = torch.cos(beta), torch.sin(beta)
    d_inv = ax_ * ax_ * cb * cb + ay_ * ay_ * sb * sb
    inv_len = 1.0 / torch.sqrt(torch.clamp(d_inv, min=1e-12))
    cos_phi = ax_ * cb * inv_len
    sin_phi = ay_ * sb * inv_len
    tan2 = -torch.log(xi1) * d_inv
    cos_th = 1.0 / torch.sqrt(1.0 + tan2)
    sin_th = sqrt0(1.0 - cos_th * cos_th)
    t1, t2 = _kutz_frame(n)
    h = (cos_th[..., None] * n + (sin_th * cos_phi)[..., None] * t1
         + (sin_th * sin_phi)[..., None] * t2)
    d = reflect(incident, h)
    wi_dot_h = -_dot(incident, h)
    cos_o = _dot(d, n)
    valid = (cos_o > 0.0) & (wi_dot_h > 0.0)
    w = (wi_dot_h * (cos_th * (cos_th * cos_th))
         * sqrt0(torch.clamp(cos_o, min=0.0) / torch.clamp(cos_i, 1e-6, 1.0)))
    return d, torch.where(valid[..., None], spec_color * w[..., None], 0.0)


def sample_bsdf(mat: MaterialLookup, position, normal, incident, u, glossy: bool = True,
                microfacet: bool = False, ward: bool = False) -> ScatterSample:
    """Outgoing direction and throughput multiplier per ray.  ``u`` is
    ``[N, 3]`` (two hemisphere uniforms, one Fresnel choice); ``normal``
    the geometric world normal, either way round.  ``glossy``,
    ``microfacet`` and ``ward`` put the Phong, Cook-Torrance and Ward lobes
    in the graph, as the feature gates of ``RenderConfig.features``."""
    cos_raw = _dot(incident, normal)
    entering = cos_raw < 0.0
    n = torch.where(entering[..., None], normal, -normal)
    cos_i = torch.abs(cos_raw)

    d_diffuse = cosine_hemisphere(n, u[..., 0], u[..., 1])
    d_mirror = reflect(incident, n)

    if glossy:
        exp_n = torch.clamp(mat.specular_exponent, min=1e-6)
        cos_alpha = torch.clamp(u[..., 0], min=1e-9) ** (1.0 / (exp_n + 1.0))
        d_glossy = _rotate_about(d_mirror, cos_alpha, u[..., 1] * 2.0 * math.pi)
        glossy_cos_out = _dot(d_glossy, n)
        glossy_weight = torch.where(
            glossy_cos_out > 0.0,
            (exp_n + 2.0) / (exp_n + 1.0) * torch.clamp(glossy_cos_out, 0.0, 1.0),
            0.0,
        )
        is_glossy_mat = mat.specular_exponent > 0.0
    else:
        d_glossy, glossy_weight = d_mirror, torch.ones_like(mat.specular_exponent)
        is_glossy_mat = torch.zeros_like(entering)

    ior_i = torch.where(entering, 1.0, mat.ior)
    ior_t = torch.where(entering, mat.ior, 1.0)
    eta = ior_i / torch.clamp(ior_t, min=1e-6)
    d_refr, refr_valid = refract(incident, n, eta)
    fres_r = torch.where(refr_valid, fresnel_dielectric(cos_i, ior_i, ior_t), 1.0)
    choose_reflect = u[..., 2] < fres_r.detach()
    d_dielectric = torch.where(choose_reflect[..., None], d_mirror, d_refr)

    is_refractive = mat.has_refractive > 0.0
    is_reflective = (~is_refractive) & (mat.has_reflective > 0.0)
    if microfacet:
        # the microfacet family (1 = Cook-Torrance GGX, 2 = Ward) rides one
        # lane, with each model's direction and weight
        is_ct = is_reflective & (mat.brdf_model > 0.5)
        d_ct, ct_weight = ggx_sample(n, incident, cos_i, mat.roughness, mat.specular_color,
                                     u[..., 0], u[..., 1])
        if ward:
            is_ward = (mat.brdf_model > 1.5)[..., None]
            d_wd, wd_weight = ward_sample(n, incident, cos_i, mat.roughness, mat.roughness_y,
                                          mat.specular_color, u[..., 0], u[..., 1])
            d_ct = torch.where(is_ward, d_wd, d_ct)
            ct_weight = torch.where(is_ward, wd_weight, ct_weight)
    else:
        is_ct = torch.zeros_like(is_reflective)
        d_ct, ct_weight = d_mirror, torch.ones_like(mat.specular_color)
    is_glossy = is_reflective & is_glossy_mat & (~is_ct)
    is_mirror = is_reflective & (~is_glossy) & (~is_ct)
    is_specular = is_refractive | is_reflective

    direction = torch.where(
        is_refractive[..., None], d_dielectric,
        torch.where(is_ct[..., None], d_ct,
                    torch.where(is_glossy[..., None], d_glossy,
                                torch.where(is_mirror[..., None], d_mirror, d_diffuse))),
    )
    throughput_mult = torch.where(is_specular[..., None], mat.specular_color, mat.color)
    throughput_mult = torch.where(
        is_glossy[..., None], throughput_mult * glossy_weight[..., None], throughput_mult
    )
    throughput_mult = torch.where(is_ct[..., None], ct_weight, throughput_mult)
    transmitted = is_refractive & (~choose_reflect) & refr_valid
    origin = position + torch.where(transmitted[..., None], -RAY_BIAS * n, RAY_BIAS * n)
    return ScatterSample(direction=direction, origin=origin, throughput_mult=throughput_mult,
                         is_specular=is_specular, transmitted=transmitted, entering=entering)
