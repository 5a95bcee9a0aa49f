"""Full-depth differentiable trace: the forward with residuals, the reverse
loop, and the autograd Function around them.

Port of ``pathtracer_tpu/ops/trace_grad.py``.  The forward traces a
wavefront through all bounces as the trace kernel does, and also stores,
per bounce and lane, the carries that enter the bounce and the two discrete
outcomes the bounce resolved (the winner geom and the NEE bit): the
residuals.  The reverse loop walks the bounces newest first; for each it
replays the winner (no sweep, no shadow ray), differentiates the bounce and
:func:`ops.trace.step_update`, and chains the carry cotangents.

* :func:`tfwd_plain` / :func:`tbwd_plain` are the plain PyTorch versions;
  the reverse loop differentiates each bounce with ``torch.autograd.grad``
  (``jax.vjp`` in the TPU kernel), in float32, or in float64 at the float32
  bounce's own values: the reference the reverse kernel is held to.
* :func:`tfwd_cuda` / :func:`tbwd_cuda` launch ``csrc/trace_grad.cu``: one
  thread per lane; the reverse kernel is a hand-written adjoint of the
  replayed bounce, with per-block table partials and a fixed-order sum.
  Its media and surface instances take their lanes grouped by a key of
  the residuals (:func:`lane_keys_plain`; :func:`lane_order_cuda`), so
  that a warp's lanes take the costly branches together.
* :class:`TraceDiff` is the ``torch.autograd.Function`` (the
  ``jax.custom_vjp`` of ``trace_grad.py:487-511``): the forward saves the
  tables, the samples and the residuals, the backward runs the reverse
  loop, and the ray count is not differentiable.
* :func:`trace_fused_diff` is the drop-in for ``trace_paths`` under
  ``grad_lean``; :func:`trace_replay` is the lean engine's forward in the
  fused scope, the forward with residuals keeping only each bounce's
  winner, NEE bit and entering ray for the backward's re-trace to replay.
  Rays on a CUDA device launch the kernels or raise; rays on the CPU take
  the plain versions.

Residuals are ``[depth, n_resid(features), N]`` float32, lane-contiguous so
that the kernel's stores coalesce.  With ``volumetric`` they are JAX's 17
planes in JAX's order (``trace_grad.py:74-76``): o(3) d(3) thr(3)
sigma_a(3) sigma_s prev_state alive replay_gid replay_nee_add; in vacuum
the medium planes are left out (13 planes).  A lane that has died stores
the carries it died with, its medium too, alive 0, gid -1 and NEE bit 0.
JAX's ``_step_update`` passes the medium on unconditionally (``:107-110``),
so a dead lane's medium there follows the bounces it no longer takes; the
two differ on dead lanes only, which neither the radiance nor the reverse
loop reads, so the gradients are the same.

Participating media (``volumetric``, with or without ``vol_nee``): the
forward carries the medium as ``ops/trace.trace_plain`` does and stores it;
the reverse loop differentiates the medium carries too (the cotangents of
sigma_a and sigma_s flow back through the bounce's ``out_ma`` / ``out_ms``
and on to the material table's absorption and scattering columns).  The
kernels run their ``kVol`` instances.  ``hg`` stays on the lean engine
(``fused_diff_eligible``), as in JAX.

The optional surface features (``texture``, ``bump``, ``microfacet``,
``ward``): both plain versions run ``bounce_physics`` with them, and the
kernels their ``kSurf`` instances (4s and 5s; with ``volumetric`` the same
template's ``kVol`` x ``kSurf`` instances), with the feature bits of
``ops/trace.surface_bits``.  JAX adds no residual planes for them.

Gradient semantics are those of the JAX engines: detached sampling,
winner-only intersection cotangents, zero-cotangent visibility, detached
russian-roulette probability.  The table cotangents come back as
``d_gtab [G, 14]``, ``d_mtab [M, 28]``, ``d_ltab [G, 19]``, ``d_scal [2]``;
autograd of :func:`ops.bounce.pack_tables` carries them on to the scene.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch
from torch.overrides import TorchFunctionMode

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.bounce import (
    LIGHT_COLS,
    MAT_COLS,
    bounce_physics,
    check_diff_features,
    pack_tables,
)
from pathtracer_tpu_torch.ops.intersect import GEOM_COLS, T_MIN, winner_t_gid_plain
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes
from pathtracer_tpu_torch.ops.trace import (
    check_launch,
    check_tensor,
    fused_trace_eligible,
    init_carries,
    step_update,
    surface_bits,
)
from pathtracer_tpu_torch.scene.structs import Rays
from pathtracer_tpu_torch.utils.metrics import span

N_RESID = 13  # vacuum: o(3) d(3) thr(3), then the tail: prev_state alive gid nee_add
N_RESID_VOL = 17  # volumetric: sigma_a(3) sigma_s before the tail, as JAX's N_RESID
R_SA, R_SS = 9, 12  # the medium's planes, in the volumetric layout only
ORDER_BOUNCES = 8  # the bounces a lane's key looks at (csrc/trace_grad.cu)

fwd_launches = 0  # launches of tfwd_cuda in this process, vacuum scenes
bwd_launches = 0  # launches of tbwd_cuda (its kernel and its block sum), vacuum scenes
fwd_vol_launches = 0  # launches of tfwd_cuda's volumetric instance (4v)
bwd_vol_launches = 0  # launches of tbwd_cuda's volumetric instance (5v)
fwd_surf_launches = 0  # launches of tfwd_cuda's surface instances (4s), vacuum or volumetric
bwd_surf_launches = 0  # launches of tbwd_cuda's surface instances (5s), vacuum or volumetric


def n_resid(features) -> int:
    """Residual planes per bounce: 17 with ``volumetric``, 13 without."""
    return N_RESID_VOL if "volumetric" in features else N_RESID


def tail_plane(features) -> int:
    """Index of the emit-state plane, which alive, gid and the NEE bit
    follow: 9 in vacuum, 13 with ``volumetric``."""
    return n_resid(features) - 4


def lane_events(gtab, seed: int, sample_idx, resid, lane: int, features=frozenset()) -> str:
    """A check's account of lane ``lane``'s path in a residual stack, one
    ``bounce:event gid g`` per bounce it lived: the event is ``miss``,
    ``surface``, ``scatter`` (an in-medium scatter before the winner) or
    ``cross`` (a medium crossed to the winner), with ``+nee`` where the
    surface NEE added light."""
    tail = tail_plane(features)
    r = resid[..., lane:lane + 1].float()
    events = []
    for dep in range(r.shape[0]):
        if float(r[dep, tail + 1]) <= 0.5:
            break
        gid = int(r[dep, tail + 2])
        event = "miss" if gid < 0 else "surface"
        if gid >= 0 and "volumetric" in features and float(r[dep, R_SS]) > 0:
            u8 = hash_uniforms_planes(seed, sample_idx[lane:lane + 1], dep, 11)[8]
            free = -torch.log(torch.clamp(1.0 - u8, 1e-7, 1.0)) / r[dep, R_SS]
            t, _ = winner_t_gid_plain(Rays(r[dep, 0:3].T, r[dep, 3:6].T), gtab.float())
            event = "scatter" if float(free) < float(t) else "cross"
        events.append(f"{dep}:{event} gid {gid}" + (" +nee" if float(r[dep, tail + 3]) else ""))
    return ", ".join(events)


def _medium_update(out, alive, sigma_a, sigma_s):
    """The medium carries after a bounce: the one entered where the lane
    lives on, the old one where it died (as its other carries)."""
    return (tuple(torch.where(alive, a, b) for a, b in zip(out["out_ma"], sigma_a)),
            torch.where(alive, out["out_ms"], sigma_s))


def grad_row_len(n_geoms: int, n_materials: int) -> int:
    """Length of the flat table-cotangent row: geom, material, light
    tables and the two scalars (``bounce_grad.py:76``)."""
    return n_geoms * GEOM_COLS + n_materials * MAT_COLS + n_geoms * LIGHT_COLS + 2


def split_grad_row(row, n_geoms: int, n_materials: int):
    """``row [K]`` -> ``(d_gtab [G, 14], d_mtab [M, 28], d_ltab [G, 19],
    d_scal [2])``."""
    sizes = (n_geoms * GEOM_COLS, n_materials * MAT_COLS, n_geoms * LIGHT_COLS, 2)
    dg, dm, dl, ds = torch.split(row, sizes)
    return (
        dg.reshape(n_geoms, GEOM_COLS),
        dm.reshape(n_materials, MAT_COLS),
        dl.reshape(n_geoms, LIGHT_COLS),
        ds,
    )


def fused_diff_eligible(scene, cfg) -> bool:
    """Scope of the differentiable trace (``render/common.py:80``): that of
    the forward trace, without meshes or Henyey-Greenstein media (the lean
    engine takes those), unless the caller turned the fused engine off."""
    return (
        cfg.grad_fused is not False
        and not scene.meshes
        and fused_trace_eligible(scene, cfg)
        and "hg" not in cfg.features
    )


def replay_scope(scene, cfg) -> bool:
    """Whether the lean engine's forward is :func:`trace_replay` and its
    backward replays the forward's winners, NEE bits and rays: the fused
    scope (:func:`fused_diff_eligible` whatever ``grad_fused`` says) on the
    fused route (``cfg.fused`` not False)."""
    return cfg.fused is not False and fused_diff_eligible(
        scene, dataclasses.replace(cfg, grad_fused=None))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def tfwd_plain(
    gtab, mtab, ltab, scal, seed: int, origin, direction, sample_idx,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int, features=frozenset(),
    vol_nee: bool = True,
):
    """``(radiance [N, 3], rays_traced int64 [], residuals [depth,
    n_resid(features), N])``: :func:`ops.trace.trace_plain`'s loop plus the
    residual stores."""
    o, d, thr, prev_state, alive = init_carries(origin, direction)
    zero = torch.zeros_like(prev_state)
    sigma_a, sigma_s = (zero,) * 3, zero
    vol = "volumetric" in features
    tail = tail_plane(features)
    radiance = (zero,) * 3
    nrays = torch.zeros((), dtype=torch.int64, device=origin.device)
    ray_mult = 2 if nee else 1
    resid = torch.empty((max_depth, n_resid(features), origin.shape[0]), dtype=torch.float32,
                        device=origin.device)

    for dep in range(max_depth):
        medium = [*sigma_a, sigma_s] if vol else []
        resid[dep, :tail + 2] = torch.stack(
            [*o, *d, *thr, *medium, prev_state, alive.to(torch.float32)])
        nrays = nrays + alive.sum() * ray_mult
        u = hash_uniforms_planes(seed, sample_idx, dep, 11)
        out = bounce_physics(
            o, d, thr, sigma_a, sigma_s, gtab, mtab, ltab, scal,
            u, dep, prev_state, nee=nee, t_min=T_MIN, features=features,
            emit_replay=True, vol_nee=vol_nee,
        )
        resid[dep, tail + 2] = torch.where(alive, out["replay_gid"], -1.0)
        resid[dep, tail + 3] = torch.where(alive, out["replay_nee_add"], 0.0)
        rad_inc, alive, thr, o, d, prev_state = step_update(
            out, o, d, thr, prev_state, alive, dep, rr=rr, rr_start=rr_start
        )
        sigma_a, sigma_s = _medium_update(out, alive, sigma_a, sigma_s)
        radiance = tuple(r + c for r, c in zip(radiance, rad_inc))
    return torch.stack(radiance, dim=-1), nrays, resid


class _Float32Values(TorchFunctionMode):
    """Runs each float64 op twice: in float64, which autograd records and
    differentiates, and on float32 copies of its inputs, whose result
    becomes the op's value.  A float64 bounce under this mode takes the
    float32 bounce's values exactly, and autograd differentiates it at
    those values in float64."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _any_f64(out):
            return out
        name = getattr(func, "__name__", "")
        if name.endswith("_") and not name.endswith("__"):
            raise NotImplementedError(f"in-place {name} under float32 values")
        return _with_values(out, func(*_to_f32(args), **_to_f32(kwargs)))


def _any_f64(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.float64
    return isinstance(x, (tuple, list)) and any(_any_f64(v) for v in x)


def _to_f32(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float64:
        return x.float()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_f32(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_f32(v) for k, v in x.items()}
    return x


def _with_values(x, low):
    """``x`` with the values of ``low`` and the graph of ``x``."""
    if isinstance(x, torch.Tensor):
        return x + (low.to(x.dtype) - x).detach() if x.dtype == torch.float64 else x
    return type(x)([_with_values(a, b) for a, b in zip(x, low)])


def tbwd_plain(
    gtab, mtab, ltab, scal, seed: int, sample_idx, resid, g_rad,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int, features=frozenset(),
    vol_nee: bool = True, dtype=torch.float32,
):
    """Reverse loop, newest bounce first (``trace_grad.py:190-318``):
    ``(d_gtab, d_mtab, d_ltab, d_scal, d_origin [N, 3], d_direction [N, 3])``.

    Each bounce reloads its residuals, recomputes the replayed bounce and
    :func:`step_update` on leaf tensors, and takes ``torch.autograd.grad``
    with the radiance cotangent and the carry cotangents of the bounce
    after it (with ``volumetric`` the medium's too); the table cotangents
    are summed across bounces.

    ``dtype=torch.float64`` returns the float64 reference: the bounce's
    values are the float32 bounce's own (:class:`_Float32Values`) and
    autograd's products and sums run in float64, as the reverse kernel's
    adjoint does.  Where a gradient component is the small
    difference of large terms, float32 autograd rounds those terms and this
    reference does not."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    values = _Float32Values() if dtype == torch.float64 else contextlib.nullcontext()
    tabs = [t.detach().to(dtype).requires_grad_(True) for t in (gtab, mtab, ltab, scal)]
    acc = [torch.zeros_like(t) for t in tabs]
    resid = resid.to(dtype)
    g_rad = tuple(g_rad.to(dtype).unbind(-1))
    zero = torch.zeros_like(resid[0, 0])
    vol = "volumetric" in features
    tail = tail_plane(features)
    # the loop's final carries are discarded: the medium's cotangents too
    g_carry = [zero] * tail

    for dep in reversed(range(max_depth)):
        r = resid[dep]
        leaves = [r[k].detach().requires_grad_(True) for k in range(tail)]
        o, d, thr = tuple(leaves[0:3]), tuple(leaves[3:6]), tuple(leaves[6:9])
        sigma_a, sigma_s = (tuple(leaves[9:12]), leaves[12]) if vol else ((zero,) * 3, zero)
        alive = r[tail + 1] > 0.5
        u = hash_uniforms_planes(seed, sample_idx, dep, 11)
        with torch.enable_grad():
            with values:
                out = bounce_physics(
                    o, d, thr, sigma_a, sigma_s, *tabs, u, dep, r[tail],
                    nee=nee, t_min=T_MIN, features=features, vol_nee=vol_nee,
                    replay={"gid": r[tail + 2], "nee_add": r[tail + 3]},
                )
                rad_inc, new_alive, thr2, next_o, next_d, _ = step_update(
                    out, o, d, thr, r[tail], alive, dep, rr=rr, rr_start=rr_start
                )
                nexts = [*next_o, *next_d, *thr2]
                if vol:
                    next_sa, next_ss = _medium_update(out, new_alive, sigma_a, sigma_s)
                    nexts += [*next_sa, next_ss]
            grads = torch.autograd.grad(
                [*rad_inc, *nexts], [*leaves, *tabs],
                grad_outputs=[*g_rad, *g_carry], allow_unused=True,
            )
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves + tabs)]
        g_carry = grads[:tail]
        acc = [a + g for a, g in zip(acc, grads[tail:])]
    return (*acc, torch.stack(g_carry[0:3], dim=-1), torch.stack(g_carry[3:6], dim=-1))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("trace_grad")
    if lib.trace_fwd_launch.argtypes is None:
        # without argtypes ctypes would cut pointers to 32 bits
        lib.trace_fwd_launch.restype = ctypes.c_int
        lib.trace_fwd_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,  # geom table, G
            ctypes.c_void_p, ctypes.c_int,  # material table, M
            ctypes.c_void_p, ctypes.c_void_p,  # light table, scalars
            ctypes.c_uint,  # seed
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # origin, dir, sample
            ctypes.c_int,  # n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # radiance, nrays, resid
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # depth, nee, rr, rr_start
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # volumetric, vol_nee, surface bits
            ctypes.c_void_p,  # stream
        ]
        lib.trace_bwd_launch.restype = ctypes.c_int
        lib.trace_bwd_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,  # geom table, G
            ctypes.c_void_p, ctypes.c_int,  # material table, M
            ctypes.c_void_p, ctypes.c_void_p,  # light table, scalars
            ctypes.c_uint,  # seed
            ctypes.c_void_p, ctypes.c_int,  # sample, n
            ctypes.c_void_p, ctypes.c_void_p,  # resid, g_rad
            ctypes.c_void_p, ctypes.c_void_p,  # d_origin, d_direction
            ctypes.c_void_p, ctypes.c_void_p,  # block partials with the row sum's scratch, row
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # depth, nee, rr, rr_start
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # volumetric, vol_nee, surface bits
            ctypes.c_void_p,  # the lane order's scratch (media and surface instances)
            ctypes.c_void_p,  # stream
        ]
        lib.trace_bwd_rows.restype = ctypes.c_int
        lib.trace_bwd_rows.argtypes = [ctypes.c_int]
        lib.lane_order_ints.restype = ctypes.c_int
        lib.lane_order_ints.argtypes = [ctypes.c_int]
        lib.lane_order_launch.restype = ctypes.c_int
        lib.lane_order_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # geom, material tables, resid
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, depth, volumetric
            ctypes.c_void_p, ctypes.c_void_p,  # scratch, stream
        ]
    return lib


def tfwd_cuda(
    gtab, mtab, ltab, scal, seed: int, origin, direction, sample_idx,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int, features=frozenset(),
    vol_nee: bool = True,
):
    """Launch the forward-with-residuals kernel (its ``kVol`` instance with
    ``volumetric``, its ``kSurf`` one with a surface feature): ``(radiance
    [N, 3], rays_traced int64 [], residuals [depth, n_resid(features),
    N])`` on the rays' CUDA device, on the current stream."""
    global fwd_launches, fwd_vol_launches, fwd_surf_launches
    check_diff_features(features, "fused")
    vol = "volumetric" in features
    surf = surface_bits(features)
    device = origin.device
    n = origin.shape[0]
    g, m, bits = check_launch(gtab, mtab, ltab, scal, sample_idx, n, device)
    check_tensor(origin, "origin", torch.float32, (n, 3), device)
    check_tensor(direction, "direction", torch.float32, (n, 3), device)

    radiance = torch.empty((n, 3), dtype=torch.float32, device=device)
    nrays = torch.zeros((), dtype=torch.int64, device=device)
    resid = torch.empty((max_depth, n_resid(features), n), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().trace_fwd_launch(
        gtab.data_ptr(), g, mtab.data_ptr(), m, ltab.data_ptr(), scal.data_ptr(),
        int(seed) & 0xFFFFFFFF,
        origin.data_ptr(), direction.data_ptr(), bits.data_ptr(), n,
        radiance.data_ptr(), nrays.data_ptr(), resid.data_ptr(),
        int(max_depth), int(bool(nee)), int(bool(rr)), int(rr_start), int(vol),
        int(bool(vol_nee)), surf, stream,
    )
    if err != 0:
        raise RuntimeError(f"trace_fwd kernel launch failed: CUDA error {err}")
    if surf:
        fwd_surf_launches += 1
    elif vol:
        fwd_vol_launches += 1
    else:
        fwd_launches += 1
    return radiance, nrays, resid


def tbwd_cuda(
    gtab, mtab, ltab, scal, seed: int, sample_idx, resid, g_rad,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int, features=frozenset(),
    vol_nee: bool = True,
):
    """Launch the reverse kernel (its ``kVol`` instance with
    ``volumetric``, its ``kSurf`` one with a surface feature) and its
    fixed-order block sum: ``(d_gtab, d_mtab, d_ltab, d_scal, d_origin [N,
    3], d_direction [N, 3])`` on the current stream."""
    global bwd_launches, bwd_vol_launches, bwd_surf_launches
    check_diff_features(features, "fused")
    vol = "volumetric" in features
    surf = surface_bits(features)
    device = resid.device
    n = resid.shape[2]
    g, m, bits = check_launch(gtab, mtab, ltab, scal, sample_idx, n, device)
    check_tensor(resid, "residuals", torch.float32, (max_depth, n_resid(features), n), device)
    check_tensor(g_rad, "radiance cotangent", torch.float32, (n, 3), device)

    lib = _lib()
    k = grad_row_len(g, m)
    d_o = torch.empty((n, 3), dtype=torch.float32, device=device)
    d_d = torch.empty((n, 3), dtype=torch.float32, device=device)
    partial = torch.empty((lib.trace_bwd_rows(n), k), dtype=torch.float32, device=device)
    row = torch.empty((k,), dtype=torch.float32, device=device)
    order = (torch.empty(lib.lane_order_ints(n), dtype=torch.int32, device=device)
             if vol or surf else None)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.trace_bwd_launch(
        gtab.data_ptr(), g, mtab.data_ptr(), m, ltab.data_ptr(), scal.data_ptr(),
        int(seed) & 0xFFFFFFFF, bits.data_ptr(), n,
        resid.data_ptr(), g_rad.data_ptr(), d_o.data_ptr(), d_d.data_ptr(),
        partial.data_ptr(), row.data_ptr(),
        int(max_depth), int(bool(nee)), int(bool(rr)), int(rr_start), int(vol),
        int(bool(vol_nee)), surf, None if order is None else order.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"trace_bwd kernel launch failed: CUDA error {err}")
    if surf:
        bwd_surf_launches += 1
    elif vol:
        bwd_vol_launches += 1
    else:
        bwd_launches += 1
    return (*split_grad_row(row, g, m), d_o, d_d)


def lane_keys_plain(gtab, mtab, resid, features, max_depth: int):
    """The plain version of the reverse kernel's lane keys (int32 [N]): bit
    d set where the lane lives at bounce d (d < ``ORDER_BOUNCES``) and takes
    its instance's costly branch there, in a scattering medium with
    ``volumetric`` (5v), else on a Cook-Torrance or Ward material (5s)."""
    tail = tail_plane(features)
    depth = min(max_depth, ORDER_BOUNCES)
    alive = torch.cumprod((resid[:depth, tail + 1] > 0.5).int(), 0).bool()
    if "volumetric" in features:
        costly = resid[:depth, R_SS] > 0
    else:
        gid = resid[:depth, tail + 2].long()
        mat = gtab[gid.clamp(min=0), 13].long()
        costly = (gid >= 0) & (mtab[mat, 24] > 0.5)
    bits = (alive & costly).int() << torch.arange(depth, device=resid.device)[:, None]
    return bits.sum(0, dtype=torch.int32)


def lane_order_cuda(gtab, mtab, resid, features, max_depth: int):
    """The lane order that :func:`tbwd_cuda`'s media and surface instances
    run: ``(keys int32 [N], order int32 [N])``, the lanes grouped by key in
    increasing key order (within a key in no fixed order), on the current
    stream.  ``keys`` equal :func:`lane_keys_plain`'s."""
    device = resid.device
    n = resid.shape[2]
    check_tensor(resid, "residuals", torch.float32, (max_depth, n_resid(features), n), device)
    check_tensor(gtab, "geom table", torch.float32, (gtab.shape[0], GEOM_COLS), device)
    check_tensor(mtab, "material table", torch.float32, (mtab.shape[0], MAT_COLS), device)
    lib = _lib()
    scratch = torch.empty(lib.lane_order_ints(n), dtype=torch.int32, device=device)
    err = lib.lane_order_launch(
        gtab.data_ptr(), mtab.data_ptr(), resid.data_ptr(), n, int(max_depth),
        int("volumetric" in features), scratch.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lane order kernels failed: CUDA error {err}")
    return scratch[:n], scratch[n:2 * n]


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

class TraceDiff(torch.autograd.Function):
    """``(radiance [N, 3], rays_traced int64 [])`` of a wavefront, with the
    reverse loop as its backward.  ``opts`` holds ``max_depth``, ``nee``,
    ``rr``, ``rr_start``, ``features`` and ``vol_nee``."""

    @staticmethod
    def forward(ctx, gtab, mtab, ltab, scal, origin, direction, sample_idx, seed, opts):
        kw = dict(opts)
        if origin.device.type == "cuda":
            rad, nrays, resid = tfwd_cuda(
                gtab, mtab, ltab, scal, seed, origin, direction, sample_idx, **kw
            )
        elif origin.device.type == "cpu":
            rad, nrays, resid = tfwd_plain(
                gtab, mtab, ltab, scal, seed, origin, direction, sample_idx, **kw
            )
        else:
            raise ValueError(f"no differentiable trace for device {origin.device}")
        ctx.save_for_backward(gtab, mtab, ltab, scal, sample_idx, resid)
        ctx.seed, ctx.opts = seed, opts
        ctx.mark_non_differentiable(nrays)
        return rad, nrays

    @staticmethod
    def backward(ctx, g_rad, _g_nrays):
        with span("trace_bwd"):
            gtab, mtab, ltab, scal, sample_idx, resid = ctx.saved_tensors
            if g_rad is None:
                g_rad = torch.zeros((resid.shape[2], 3), dtype=torch.float32, device=resid.device)
            kw = dict(ctx.opts)
            args = (gtab, mtab, ltab, scal, ctx.seed, sample_idx, resid, g_rad.contiguous())
            if resid.device.type == "cuda":
                grads = tbwd_cuda(*args, **kw)
            else:
                grads = tbwd_plain(*args, **kw)
            return (*grads, None, None, None)


def trace_replay(scene, rays, sample_idx, seed: int, cfg, tables=None):
    """The lean engine's forward in the fused scope: ``(radiance [N, 3],
    rays_traced int64 [], gid [depth, N] int16, nee [depth, N] bool, ray
    [depth, 6, N] float32)``.  The forward with residuals (kernel 4 on a
    CUDA tensor, its plain version on the CPU) traces the paths; of its
    residuals each bounce's winner geom (-1: a miss or a dead lane), its
    surface NEE bit and the ray entering it (origin, direction planes) are
    kept, 27 bytes per lane-bounce, for the backward's re-trace to replay,
    and the rest is freed here.  Kernels 1 and 4 run the same
    ``pt::bounce_step``, so the radiance and ray count are the trace
    kernel's."""
    if not replay_scope(scene, cfg):
        raise NotImplementedError("trace_replay takes the scenes of the fused scope")
    gtab, mtab, ltab, scal = tables if tables is not None else pack_tables(scene)
    features = frozenset(cfg.features)
    args = (gtab.detach(), mtab.detach(), ltab.detach(), scal.detach(), int(seed),
            rays.origin.detach(), rays.direction.detach(), sample_idx)
    kw = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
              rr_start=cfg.rr_start, features=features, vol_nee=cfg.vol_nee)
    device_type = rays.origin.device.type
    if device_type == "cuda":
        rad, nrays, resid = tfwd_cuda(*args, **kw)
    elif device_type == "cpu":
        rad, nrays, resid = tfwd_plain(*args, **kw)
    else:
        raise ValueError(f"no differentiable trace for device type {device_type!r}")
    tail = tail_plane(features)
    gid = resid[:, tail + 2].to(torch.int16)
    nee = resid[:, tail + 3] > 0.5
    ray = resid[:, 0:6].clone()
    del resid
    return rad, nrays, gid, nee, ray


def trace_fused_diff(scene, rays, sample_idx, seed: int, cfg, tables=None):
    """Differentiable drop-in for ``render/megakernel.trace_paths``:
    ``(radiance [N, 3], rays_traced int64 [])``.  ``tables`` are
    :func:`pack_tables` of the scene, packed here when not given; their
    graph carries the table cotangents on to the scene's tensors, and the
    rays' graph carries ``d_origin`` / ``d_direction`` to the camera."""
    check_diff_features(cfg.features, "fused")
    if not fused_diff_eligible(scene, cfg):
        raise NotImplementedError(
            "the full-depth differentiable trace takes no meshes, image textures, HG media or "
            "fast_rng=False (the lean engine, RenderConfig(grad_fused=False), runs them)"
        )
    gtab, mtab, ltab, scal = tables if tables is not None else pack_tables(scene)
    opts = dict(
        max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
        rr_start=cfg.rr_start, features=frozenset(cfg.features), vol_nee=cfg.vol_nee,
    )
    return TraceDiff.apply(
        gtab, mtab, ltab, scal, rays.origin, rays.direction, sample_idx, int(seed), opts
    )
