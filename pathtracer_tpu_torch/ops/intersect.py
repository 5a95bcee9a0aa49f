"""Analytic primitive intersection on component tensors.

Port of ``pathtracer_tpu/ops/intersect.py:37-111`` (``BIG``, ``T_MIN``,
``sphere_t_planes``, ``cube_t_planes``) and
``pathtracer_tpu/ops/intersect_pallas.py:58-80,206-216`` (``_geom_t``,
``_pack_gdata``).  Unit primitives live in object space (sphere r = 0.5,
cube side 1) and are tested through the inverse transform; the
object-space direction stays unnormalized, so ``t`` is the world-space
distance.  A miss is ``BIG``.  The CUDA kernel (``csrc/trace.cu``)
repeats this arithmetic in the same order.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.scene.structs import CUBE, SPHERE, Geoms

BIG = 1e30  # miss sentinel (finite)
T_MIN = 1e-4  # min accepted hit distance

GEOM_COLS = 14  # inverse-transform rows 0..2 (12), type, material id


def _safe_recip(x, eps=1e-12):
    return 1.0 / torch.where(
        torch.abs(x) < eps, torch.where(x >= 0, eps, -eps), x
    )


def sphere_t_planes(ox, oy, oz, dx, dy, dz, t_min=T_MIN):
    """Nearest t > t_min on the r = 0.5 object-space sphere, else BIG."""
    a = dx * dx + dy * dy + dz * dz
    b = ox * dx + oy * dy + oz * dz
    c = ox * ox + oy * oy + oz * oz - 0.25
    disc = b * b - a * c
    valid = disc > 0.0
    sq = torch.sqrt(torch.where(valid, disc, 1.0))
    inv_a = _safe_recip(a)
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    t = torch.where(t0 > t_min, t0, t1)
    return torch.where(valid & (t > t_min), t, BIG)


def cube_t_planes(ox, oy, oz, dx, dy, dz, t_min=T_MIN):
    """Unit-cube slab test: nearest t > t_min, else BIG."""
    ix, iy, iz = _safe_recip(dx), _safe_recip(dy), _safe_recip(dz)
    tlx, thx = (-0.5 - ox) * ix, (0.5 - ox) * ix
    tly, thy = (-0.5 - oy) * iy, (0.5 - oy) * iy
    tlz, thz = (-0.5 - oz) * iz, (0.5 - oz) * iz
    t_near = torch.maximum(
        torch.maximum(torch.minimum(tlx, thx), torch.minimum(tly, thy)),
        torch.minimum(tlz, thz),
    )
    t_far = torch.minimum(
        torch.minimum(torch.maximum(tlx, thx), torch.maximum(tly, thy)),
        torch.maximum(tlz, thz),
    )
    valid = (t_far >= t_near) & (t_far > t_min)
    t = torch.where(t_near > t_min, t_near, t_far)
    return torch.where(valid & (t > t_min), t, BIG)


def geom_t(grow, ox, oy, oz, dx, dy, dz, t_min=T_MIN):
    """Distance for one geom from its 14 table values, plus its
    object-space ray ``(oox, ooy, ooz, odx, ody, odz)``."""
    m = grow
    oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
    ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
    ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
    odx = m[0] * dx + m[1] * dy + m[2] * dz
    ody = m[4] * dx + m[5] * dy + m[6] * dz
    odz = m[8] * dx + m[9] * dy + m[10] * dz
    gtype = float(m[12])
    if gtype == float(SPHERE):
        t = sphere_t_planes(oox, ooy, ooz, odx, ody, odz, t_min)
    elif gtype == float(CUBE):
        t = cube_t_planes(oox, ooy, ooz, odx, ody, odz, t_min)
    else:  # mesh slots never hit in the analytic sweep
        t = torch.full_like(ox, BIG)
    return t, (oox, ooy, ooz, odx, ody, odz)


def pack_geom_table(geoms: Geoms) -> torch.Tensor:
    """``[G, 14]`` float32: inverse-transform rows 0..2, type, material id."""
    inv12 = geoms.inv_transform.reshape(geoms.count, 16)[:, :12]
    return torch.cat(
        [
            inv12,
            geoms.type.to(torch.float32)[:, None],
            geoms.material_id.to(torch.float32)[:, None],
        ],
        dim=-1,
    ).contiguous()
