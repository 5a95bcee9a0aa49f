"""The per-bounce differentiable engine's bounce: kernel 2 with replay planes
forward, kernel 3 backward.

Port of ``pathtracer_tpu/ops/bounce_grad.py`` for analytic scenes.  The
forward is one bounce (``ops/bounce_fused.py``, kernel 2) that also emits
the two discrete outcomes it resolved: the winner geom and the NEE bit.
The backward replays them (no sweep, no shadow ray: both are comparisons
and carry no cotangent) and differentiates ``ops/bounce.py:bounce_physics``
for that bounce alone.

* :func:`bounce_bwd_plain` is the plain version: ``torch.autograd.grad`` of
  ``bounce_physics(replay=...)`` (``jax.vjp`` inside the TPU kernel), in
  float32, or in float64 at the float32 bounce's own values (the reference
  kernel 3 is held to, as ``ops/trace_grad.py:tbwd_plain``'s).
* :func:`bounce_bwd_cuda` launches ``csrc/bounce_grad.cu`` (kernel 3: one
  thread per lane, the tables in shared memory, the adjoint of
  ``csrc/bounce_adj.cuh`` that kernel 5 shares, one table row per block,
  the rows summed by ``bounce_adj.cuh:row_sum`` in a fixed tree; a lane
  whose cotangents are all zero writes zeros and adds nothing).  In 3 and
  3s each lane sums its winner's geom and material columns in double and
  its warp adds them to the row once; 3s runs its lanes grouped by the
  branch their adjoint takes (:func:`bounce_bwd_keys_plain` is the plain
  version of the key; two short kernels order them first).
* :class:`BounceDiff` is the ``torch.autograd.Function`` (the
  ``jax.custom_vjp`` of ``bounce_grad.py:380-428``): its forward saves the
  inputs and the replay planes, its backward runs kernel 3 on a CUDA
  tensor and the plain version on a CPU tensor.
* :func:`bounce_fused_diff` returns a ``BounceResult`` whose contribution,
  continuation and throughput multiplier carry gradients to the tables and
  the carries.

The medium ``[N, 4]`` (sigma_a rgb, sigma_s) is an input and
``next_medium`` an output of the Function, as in JAX's kernel pair
(``bounce_grad.py:97-117``).  With ``volumetric`` the forward is kernel 2's
volumetric instance with replay planes (2r-v) and the backward kernel 3's
(3v), which takes the medium and its output cotangent and returns the
medium's cotangent; in vacuum the medium passes through the bounce, and so
does its cotangent.  ``hg`` raises: the lean engine differentiates it, as
in JAX.  The surface features (``texture``, ``bump``, ``microfacet``,
``ward``) run kernel 2's surface instance with replay planes (2r-s) and
kernel 3's (3s), with ``volumetric`` the same templates' ``kVol`` x
``kSurf`` instances.

Output contract of both backwards: mask-free, as kernel 2's forward.  Any
cotangents on any lane, misses and light hits included, give the adjoint of
the bounce kernel 2 computed on that lane.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.bounce import bounce_physics, check_diff_features, pack_tables
from pathtracer_tpu_torch.ops.bounce_fused import (
    BounceResult,
    _per_lane_depth,
    bounce_fused_cuda,
    bounce_fused_plain,
)
from pathtracer_tpu_torch.ops.intersect import T_MIN
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes
from pathtracer_tpu_torch.ops.trace import check_launch, check_tensor, surface_bits
from pathtracer_tpu_torch.ops.trace_grad import (
    _Float32Values,
    fused_diff_eligible,
    grad_row_len,
    split_grad_row,
)

launches = 0  # launches of csrc/bounce_grad.cu (its kernel and its row sum), vacuum scenes
vol_launches = 0  # launches of its volumetric instance (3v)
surf_launches = 0  # launches of its surface instances (3s), vacuum or volumetric


def bounce_bwd_plain(tables, origin, direction, throughput, sample_idx, depth, prev_specular,
                     replay_gid, replay_nee, g_contrib, g_next_o, g_next_d, g_thr_mult,
                     seed: int, *, nee: bool, features=frozenset(), medium=None, g_medium=None,
                     vol_nee: bool = True, dtype=torch.float32):
    """Plain version of kernel 3: ``(d_gtab, d_mtab, d_ltab, d_scal,
    d_origin [N, 3], d_direction [N, 3], d_throughput [N, 3])`` of one
    bounce, from the cotangents of its contribution, next origin, next
    direction and throughput multiplier (``[N, 3]`` each).  With
    ``volumetric`` in ``features`` it also takes the ``medium`` ``[N, 4]``
    and its output's cotangent ``g_medium`` ``[N, 4]``, and returns
    ``d_medium`` ``[N, 4]`` last.

    ``dtype=torch.float64`` returns the float64 reference: the bounce's
    values are the float32 bounce's own (``ops/trace_grad._Float32Values``)
    and autograd's products and sums run in float64, as kernel 3's adjoint
    does."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    values = _Float32Values() if dtype == torch.float64 else contextlib.nullcontext()
    vol = "volumetric" in features
    tabs = [t.detach().to(dtype).requires_grad_(True) for t in tables]
    carries = (origin, direction, throughput) + ((medium,) if vol else ())
    leaves = [x[:, k].detach().to(dtype).requires_grad_(True)
              for x in carries for k in range(x.shape[1])]
    depth = _per_lane_depth(depth, origin.shape[0], origin.device)
    u = hash_uniforms_planes(seed, sample_idx, depth, 11)
    zero = torch.zeros_like(leaves[0])
    sigma_a, sigma_s = (tuple(leaves[9:12]), leaves[12]) if vol else ((zero,) * 3, zero)
    replay = {"gid": replay_gid.to(dtype), "nee_add": replay_nee.to(dtype)}
    with torch.enable_grad():
        with values:
            out = bounce_physics(
                tuple(leaves[0:3]), tuple(leaves[3:6]), tuple(leaves[6:9]), sigma_a, sigma_s,
                *tabs, u, depth, prev_specular.to(dtype), nee=nee, t_min=T_MIN,
                features=features, replay=replay, vol_nee=vol_nee,
            )
        outs = [c for key in ("contrib", "next_o", "next_d", "thr_mult") for c in out[key]]
        g_outs = (g_contrib, g_next_o, g_next_d, g_thr_mult)
        if vol:
            outs += [*out["out_ma"], out["out_ms"]]
            g_outs += (g_medium,)
        cots = [g.to(dtype)[:, k] for g in g_outs for k in range(g.shape[1])]
        grads = torch.autograd.grad(outs, [*tabs, *leaves], grad_outputs=cots,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, tabs + leaves)]
    d_carries = [torch.stack(grads[4 + 3 * i:7 + 3 * i], dim=-1) for i in range(3)]
    if vol:
        d_carries.append(torch.stack(grads[13:17], dim=-1))
    return (*grads[:4], *d_carries)


# kernel 3s's lane keys (csrc/bounce_grad.cu: KEY_*): the branch of the
# replayed winner; a lane whose cotangents are all zero takes the last key
KEY_MISS, KEY_LIGHT, KEY_NEE, KEY_DIFFUSE, KEY_MIRROR, KEY_LOBE, KEY_GLASS = range(7)
KEY_ZERO = 255


def bounce_bwd_keys_plain(gtab, mtab, replay_gid, replay_nee, cotangents):
    """The plain version of kernel 3s's lane keys (int32 ``[N]``):
    ``cotangents`` are those of contrib, next origin, next direction and the
    throughput multiplier (``[N, 3]`` each)."""
    zero = torch.stack([(c == 0).all(-1) for c in cotangents]).all(0)
    gid = replay_gid.long()
    mat = mtab[gtab[gid.clamp(min=0), 13].long()]
    key = torch.where(replay_nee > 0.5, KEY_NEE, KEY_DIFFUSE)
    key = torch.where(mat[:, 6] > 0, torch.where(mat[:, 24] > 0.5, KEY_LOBE, KEY_MIRROR), key)
    key = torch.where(mat[:, 7] > 0, KEY_GLASS, key)
    key = torch.where(mat[:, 9] > 0, KEY_LIGHT, key)
    key = torch.where(gid < 0, KEY_MISS, key)
    return torch.where(zero, KEY_ZERO, key).to(torch.int32)


def _lib():
    lib = _build.load("bounce_grad")
    if lib.bounce_bwd_launch.argtypes is None:  # ctypes would cut pointers to 32 bits
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bounce_bwd_launch.restype = ctypes.c_int
        lib.bounce_bwd_launch.argtypes = [
            P, I, P, I, P, P,  # geom table, G, material table, M, light table, scalars
            ctypes.c_uint, I, I,  # seed, nee, n
            P, P, P, P, P, P,  # origin, direction, throughput, sample, depth, emit state
            P, P,  # replay gid, replay NEE bit
            P, P, P, P,  # cotangents: contrib, next origin, next direction, thr mult
            P, P, P,  # d_origin, d_direction, d_throughput
            P, P,  # block partials with the row sum's scratch, table row
            I, I, I,  # volumetric, vol_nee, surface bits
            P, P, P,  # medium, its cotangent, d_medium (null: vacuum)
            P,  # the lane order's scratch (null: the lanes in index order)
            P,  # stream
        ]
        lib.bounce_bwd_rows.restype = ctypes.c_int
        lib.bounce_bwd_rows.argtypes = [I]
        lib.bounce_bwd_order_ints.restype = ctypes.c_int
        lib.bounce_bwd_order_ints.argtypes = [I, I, I]
    return lib


def bounce_bwd_cuda(tables, origin, direction, throughput, sample_idx, depth, prev_specular,
                    replay_gid, replay_nee, g_contrib, g_next_o, g_next_d, g_thr_mult,
                    seed: int, *, nee: bool, features=frozenset(), medium=None, g_medium=None,
                    vol_nee: bool = True, ordered: bool = True):
    """Launch kernel 3 (3v with ``volumetric``, 3s with a surface feature)
    and its fixed-order row sum on the rays' CUDA device, on the current
    stream: what :func:`bounce_bwd_plain` returns.  The instances that
    order their lanes (3s) run them grouped by their key, ``ordered=False``
    in index order (one thread per lane); the per-lane outputs are the
    same."""
    global launches, vol_launches, surf_launches
    check_diff_features(features, "fused")
    vol = "volumetric" in features
    surf = surface_bits(features)
    gtab, mtab, ltab, scal = tables
    device = origin.device
    n = origin.shape[0]
    g, m, bits = check_launch(gtab, mtab, ltab, scal, sample_idx, n, device)
    depth = _per_lane_depth(depth, n, device)
    prev = prev_specular.to(torch.float32).contiguous()
    f32 = torch.float32
    for t, name, shape in ((origin, "origin", (n, 3)), (direction, "direction", (n, 3)),
                           (throughput, "throughput", (n, 3)), (prev, "prev_specular", (n,)),
                           (replay_gid, "replay_gid", (n,)), (replay_nee, "replay_nee", (n,)),
                           (g_contrib, "contrib cotangent", (n, 3)),
                           (g_next_o, "next origin cotangent", (n, 3)),
                           (g_next_d, "next direction cotangent", (n, 3)),
                           (g_thr_mult, "throughput multiplier cotangent", (n, 3))):
        check_tensor(t, name, f32, shape, device)
    med = (None, None, None)
    if vol:
        check_tensor(medium, "medium", f32, (n, 4), device)
        check_tensor(g_medium, "medium cotangent", f32, (n, 4), device)
        d_m = torch.empty((n, 4), dtype=f32, device=device)
        med = (medium.data_ptr(), g_medium.data_ptr(), d_m.data_ptr())

    lib = _lib()
    k = grad_row_len(g, m)
    d_o, d_d, d_t = (torch.empty((n, 3), dtype=f32, device=device) for _ in range(3))
    partial = torch.empty((lib.bounce_bwd_rows(n), k), dtype=f32, device=device)
    row = torch.empty((k,), dtype=f32, device=device)
    order_ints = lib.bounce_bwd_order_ints(n, int(vol), surf) if ordered else 0
    order = torch.empty(order_ints, dtype=torch.int32, device=device) if order_ints else None
    err = lib.bounce_bwd_launch(
        gtab.data_ptr(), g, mtab.data_ptr(), m, ltab.data_ptr(), scal.data_ptr(),
        int(seed) & 0xFFFFFFFF, int(bool(nee)), n,
        origin.data_ptr(), direction.data_ptr(), throughput.data_ptr(), bits.data_ptr(),
        depth.data_ptr(), prev.data_ptr(), replay_gid.data_ptr(), replay_nee.data_ptr(),
        g_contrib.data_ptr(), g_next_o.data_ptr(), g_next_d.data_ptr(), g_thr_mult.data_ptr(),
        d_o.data_ptr(), d_d.data_ptr(), d_t.data_ptr(), partial.data_ptr(), row.data_ptr(),
        int(vol), int(bool(vol_nee)), surf, *med, None if order is None else order.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bounce backward kernel launch failed: CUDA error {err}")
    if surf:
        surf_launches += 1
    elif vol:
        vol_launches += 1
    else:
        launches += 1
    grads = (*split_grad_row(row, g, m), d_o, d_d, d_t)
    return (*grads, d_m) if vol else grads


class BounceDiff(torch.autograd.Function):
    """One bounce with kernel 3 as its backward: ``(contrib, next_origin,
    next_direction, throughput_mult, next_medium, terminate, was_specular,
    rr_uniform, replay_gid, replay_nee_add)``; the last five are not
    differentiable.  ``opts`` holds ``nee``, ``features`` and ``vol_nee``."""

    @staticmethod
    def forward(ctx, gtab, mtab, ltab, scal, origin, direction, throughput, medium, sample_idx,
                depth, prev_specular, seed, opts):
        depth = _per_lane_depth(depth, origin.shape[0], origin.device)
        args = ((gtab, mtab, ltab, scal), origin, direction, throughput, sample_idx, depth,
                prev_specular, medium, seed)
        kw = dict(nee=opts["nee"], features=opts["features"], vol_nee=opts["vol_nee"],
                  emit_replay=True)
        if origin.device.type == "cuda":
            res, rgid, rnee = bounce_fused_cuda(*args, **kw)
        elif origin.device.type == "cpu":
            res, rgid, rnee = bounce_fused_plain(*args, **kw)
        else:
            raise ValueError(f"no differentiable bounce for device {origin.device}")
        ctx.save_for_backward(gtab, mtab, ltab, scal, origin, direction, throughput, sample_idx,
                              depth, prev_specular, rgid, rnee, medium)
        ctx.seed, ctx.opts = seed, opts
        terminate = res.terminate.clone()  # a view of the kernel's byte plane
        ctx.mark_non_differentiable(terminate, res.was_specular, res.rr_uniform, rgid, rnee)
        return (res.contrib, res.next_origin, res.next_direction, res.throughput_mult,
                res.next_medium, terminate, res.was_specular, res.rr_uniform, rgid, rnee)

    @staticmethod
    def backward(ctx, g_contrib, g_next_o, g_next_d, g_thr_mult, g_medium, *_):
        *saved, medium = ctx.saved_tensors
        g_medium = torch.zeros_like(medium) if g_medium is None else g_medium.contiguous()
        args = ((*saved[:4],), *saved[4:],
                *(g.contiguous() for g in (g_contrib, g_next_o, g_next_d, g_thr_mult)), ctx.seed)
        opts = ctx.opts
        kw = dict(nee=opts["nee"], features=opts["features"], vol_nee=opts["vol_nee"])
        if "volumetric" in opts["features"]:
            kw.update(medium=medium, g_medium=g_medium)
        bwd = bounce_bwd_cuda if medium.device.type == "cuda" else bounce_bwd_plain
        grads = bwd(*args, **kw)
        if "volumetric" not in opts["features"]:
            grads = (*grads, g_medium)  # vacuum: the medium passes through the bounce
        d_gtab, d_mtab, d_ltab, d_scal, d_o, d_d, d_t, d_m = grads
        return (d_gtab, d_mtab, d_ltab, d_scal, d_o, d_d, d_t, d_m, None, None, None, None,
                None)


def bounce_fused_diff(scene, origin, direction, throughput, sample_idx, depth, prev_specular,
                      medium_sigma, seed: int, cfg, tables=None) -> BounceResult:
    """Differentiable bounce (``bounce_grad.py:348``): forward kernel 2 with
    replay planes, backward kernel 3 (their plain versions on the CPU), the
    volumetric instances with ``volumetric``.  ``tables`` are
    :func:`pack_tables` of the scene, whose graph carries the table
    cotangents on to the scene's tensors."""
    check_diff_features(cfg.features, "fused")
    if not fused_diff_eligible(scene, cfg):
        raise NotImplementedError(
            "the per-bounce differentiable engine takes no meshes, image textures or HG media (the "
            "lean engine, RenderConfig(grad_fused=False), runs them) and no fast_rng=False: "
            "later slice"
        )
    gtab, mtab, ltab, scal = tables if tables is not None else pack_tables(scene)
    if medium_sigma is None:
        medium_sigma = torch.zeros((origin.shape[0], 4), dtype=torch.float32,
                                   device=origin.device)
    opts = dict(nee=cfg.nee, features=frozenset(cfg.features), vol_nee=cfg.vol_nee)
    out = BounceDiff.apply(gtab, mtab, ltab, scal, origin, direction, throughput,
                           medium_sigma.contiguous(), sample_idx, depth, prev_specular,
                           int(seed), opts)
    return BounceResult(
        contrib=out[0], next_origin=out[1], next_direction=out[2], throughput_mult=out[3],
        next_medium=out[4], terminate=out[5], was_specular=out[6], rr_uniform=out[7],
    )
