"""A padded world-box cull of kernel 8's sweep, in plain PyTorch: a model
for counting, not the kernel.

Kernel 8 (``csrc/intersect.cu:occlusion_kernel``) runs every sphere's and
cube's exact test for every shadow ray.  Its only output is the minimum t,
and a geom whose exact test returns ``BIG`` cannot change it, so a kernel
may skip any geom that the ray provably misses.  This module is such a
proof: each geom's unit primitive through its forward transform, a world
box padded by a bound of the float32 exact test's rounding, and the ray's
slab test against it.  Kernel 8 ran it on the H100 and lost to the full
sweep (``PERF.md``, section 6); ``tools/kernel_split --parts intersect``
and ``chip_smoke.py`` use it to count what such a cull leaves on the rays
the routes launch kernel 8 on (the bound of kernel 8 counts the box tests
and the exact tests that hit), and ``tests/test_torch_tools.py`` holds it
conservative: no geom whose exact test hits is ever culled.

A ray is culled only when it is sane: every origin component within
``r0`` (twice the largest extent of the cullable boxes plus one), every
direction component finite and at most :data:`CULL_D_MAX`, the largest at
least :data:`CULL_D_MIN`; any other ray runs every test.  A geom whose
transform is singular, non-finite or scales beyond :data:`CULL_F_MAX` is
never culled (its box is all of space).  The boxes are computed in
float64 and rounded outward to float32; the slab test runs in float32.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.scene.structs import CUBE, SPHERE, Rays

CULL_D_MIN = 0.25
CULL_D_MAX = 1e6
CULL_D_FLOOR = 1e-30  # a zero direction component's stand-in in the ray's 1/d
CULL_F_MAX = 1e4
CULL_T = 5e-5  # the box must reach past this t (half of T_MIN)
_U = 2.0**-24  # float32's unit roundoff
_SQRT3 = 1.7320508075688772


def _round_out(x: torch.Tensor, up: bool) -> torch.Tensor:
    """float64 -> float32 rounded away from the box: down for a low end,
    up for a high end."""
    f = x.float()
    inf = torch.tensor(float("inf") if up else -float("inf"), dtype=torch.float32)
    off = (f.double() < x) if up else (f.double() > x)
    return torch.where(off, torch.nextafter(f, inf.expand_as(f)), f)


def cull_boxes(gtab: torch.Tensor):
    """The padded world boxes: ``(boxes [G, 6] float32 CPU (lo xyz, hi
    xyz), r0)``, computed in float64.

    A geom's box is its unit primitive (cube +-0.5, sphere radius 0.5)
    through the forward transform F, the inverse of the table's rows A, c,
    padded by a bound of the float32 exact test's rounding mapped to world
    space: for a ray with |o| <= r0 (every component), an object-space point
    off the primitive by delta_i maps to a world point off its box by sum_i
    |F_ji| delta_i.  delta_i adds the object-space origin's rounding (4 u
    (|A_i| r0 + |c_i|)), the direction's times the hit's distance (3 u |A_i|
    L, L = r0 + the box's extent + 1), the slab test's (3 u (0.5 + |oo_i|))
    and, on cubes, safe_recip's clamp of components below 1e-12 over the
    longest t a sane ray can hit (tmax); a sphere's radius rounds by at most
    64 u (0.5 + |oo|)^2.  The pad is twice that, plus the world slab test's
    own rounding (8 u L) and the 1e-30 stand-in of a zero component over
    tmax.  ``r0`` is twice the largest extent of the cullable boxes plus
    one."""
    m = gtab.detach().double().cpu()
    a00, a01, a02, c0 = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    a10, a11, a12, c1 = m[:, 4], m[:, 5], m[:, 6], m[:, 7]
    a20, a21, a22, c2 = m[:, 8], m[:, 9], m[:, 10], m[:, 11]
    k00 = a11 * a22 - a12 * a21
    k01 = a12 * a20 - a10 * a22
    k02 = a10 * a21 - a11 * a20
    det = a00 * k00 + a01 * k01 + a02 * k02
    inv_det = 1.0 / det
    f = [[k00 * inv_det, (a02 * a21 - a01 * a22) * inv_det, (a01 * a12 - a02 * a11) * inv_det],
         [k01 * inv_det, (a00 * a22 - a02 * a20) * inv_det, (a02 * a10 - a00 * a12) * inv_det],
         [k02 * inv_det, (a01 * a20 - a00 * a21) * inv_det, (a00 * a11 - a01 * a10) * inv_det]]
    sphere = m[:, 12] == float(SPHERE)
    center = [-(fj[0] * c0 + fj[1] * c1 + fj[2] * c2) for fj in f]
    rowabs = [torch.abs(fj[0]) + torch.abs(fj[1]) + torch.abs(fj[2]) for fj in f]
    half = [torch.where(sphere, 0.5 * torch.sqrt(fj[0] * fj[0] + fj[1] * fj[1] + fj[2] * fj[2]),
                        0.5 * ra) for fj, ra in zip(f, rowabs)]
    fn = torch.maximum(torch.maximum(rowabs[0], rowabs[1]), rowabs[2])
    ext = torch.maximum(torch.maximum(torch.abs(center[0]) + half[0],
                                      torch.abs(center[1]) + half[1]),
                        torch.abs(center[2]) + half[2])
    ok = (sphere | (m[:, 12] == float(CUBE))) & torch.isfinite(ext) & (fn <= CULL_F_MAX)
    for fj in f:
        for x in fj:
            ok &= torch.isfinite(x)
    r0 = 2.0 * float(ext[ok].max()) + 1.0 if bool(ok.any()) else 1.0
    arow = [torch.abs(a00) + torch.abs(a01) + torch.abs(a02),
            torch.abs(a10) + torch.abs(a11) + torch.abs(a12),
            torch.abs(a20) + torch.abs(a21) + torch.abs(a22)]
    oo = [ai * r0 + torch.abs(ci) for ai, ci in zip(arow, (c0, c1, c2))]
    oom = torch.maximum(torch.maximum(oo[0], oo[1]), oo[2])
    am = torch.maximum(torch.maximum(arow[0], arow[1]), arow[2])
    span = r0 + ext + 1.0
    tmax = 2.0 * (0.5 + oom) * fn / CULL_D_MIN
    w = 0.5 + _SQRT3 * oom
    d_sph = _U * (64.0 * w * w + 4.0 * oom + 3.0 * am * span)
    delta = [torch.where(sphere, d_sph,
                         _U * (4.0 * ooi + 3.0 * ai * span + 3.0 * (0.5 + ooi)) + 2e-12 * tmax)
             for ooi, ai in zip(oo, arow)]
    lo, hi = [], []
    for j in range(3):
        world = (torch.abs(f[j][0]) * delta[0] + torch.abs(f[j][1]) * delta[1]
                 + torch.abs(f[j][2]) * delta[2])
        pad = 2.0 * world + 8.0 * _U * span + 2e-30 * tmax
        lo.append(_round_out(center[j] - half[j] - pad, up=False))
        hi.append(_round_out(center[j] + half[j] + pad, up=True))
    boxes = torch.stack(lo + hi, dim=-1)
    inf = torch.tensor(float("inf"))
    boxes = torch.where(ok[:, None], boxes, torch.cat([-inf.expand(3), inf.expand(3)]))
    return boxes.contiguous(), r0


def box_entries(rays: Rays, boxes: torch.Tensor, r0: float):
    """Each ray's world slab test against each padded box, in float32:
    ``(enters [N, G] bool, t_near [N, G], sane [N] bool)``, ``t_near``
    where the ray enters the box (no hit of its geom lies nearer).  A ray
    that is not sane (the module's docstring) enters every box."""
    o, d = rays.origin.float(), rays.direction.float()
    boxes = boxes.to(o.device)
    r0f = _round_out(torch.tensor([r0], dtype=torch.float64), up=False).to(o.device)
    ad = torch.abs(d)
    sane = ((torch.abs(o) <= r0f).all(-1) & (ad <= CULL_D_MAX).all(-1)
            & (ad.amax(-1) >= CULL_D_MIN))
    floor = torch.tensor(CULL_D_FLOOR, dtype=torch.float32, device=o.device)
    dd = torch.where(d >= 0, torch.maximum(d, floor), torch.minimum(d, -floor))
    inv = 1.0 / dd
    t1 = (boxes[None, :, :3] - o[:, None, :]) * inv[:, None, :]
    t2 = (boxes[None, :, 3:] - o[:, None, :]) * inv[:, None, :]
    t_near = torch.minimum(t1, t2).amax(-1)
    t_far = torch.maximum(t1, t2).amin(-1)
    enters = (t_far >= t_near) & (t_far >= CULL_T)
    return enters | ~sane[:, None], t_near, sane


def needed_tests(rays: Rays, gtab: torch.Tensor) -> torch.Tensor:
    """``[N, G]`` bool: the exact tests the cull leaves, a sphere or cube
    whose padded box the ray enters (:func:`cull_boxes`); the others return
    ``BIG`` and cannot lower the ray's minimum."""
    boxes, r0 = cull_boxes(gtab)
    analytic = (gtab[:, 12] == float(SPHERE)) | (gtab[:, 12] == float(CUBE))
    return box_entries(rays, boxes, r0)[0] & analytic.to(rays.origin.device)[None, :]
