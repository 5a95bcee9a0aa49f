"""Full-depth path trace: the CUDA kernel and its plain version.

Port of ``pathtracer_tpu/ops/trace_pallas.py:62-297`` (``_trace_kernel``,
``_trace_call``, ``trace_fused``, ``fused_trace_eligible``).  One call
traces a wavefront of primary rays through all ``max_depth`` bounces:
per lane the counter-hash uniforms, :func:`bounce_physics`, alive masking,
russian roulette, the radiance sum, and the measured ray count (alive
lanes per bounce, twice that with NEE for the shadow rays).

* :func:`trace_plain` is the plain PyTorch version: the bounce loop of
  ``trace_pallas.py:110-173`` over ``ops/bounce.py``.
* :func:`trace_cuda` launches ``csrc/trace.cu`` (one thread per lane, all
  bounces in a loop inside the thread).
* :func:`trace_fused` dispatches on the rays' device: a CUDA tensor
  launches the kernel or raises, a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracer_tpu_torch.ops import _build
from pathtracer_tpu_torch.ops.bounce import (
    LIGHT_COLS,
    MAT_COLS,
    bounce_physics,
    check_features,
    pack_tables,
)
from pathtracer_tpu_torch.ops.intersect import GEOM_COLS, T_MIN
from pathtracer_tpu_torch.ops.rng import hash_uniforms_planes, sample_bits

MAX_GEOMS = 128  # table caps of the kernel's shared-memory copy
MAX_MATERIALS = 128

launches = 0  # kernel launches of trace_cuda in this process


def fused_trace_eligible(scene, cfg) -> bool:
    """Scope of the one-kernel trace in this slice: the counter-hash RNG,
    analytic geoms only, no image textures."""
    return cfg.fast_rng and not scene.meshes and scene.textures is None


def trace_plain(
    gtab, mtab, ltab, scal, seed: int, origin, direction, sample_idx,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int,
    features=frozenset(),
):
    """Plain version: ``(radiance [N, 3] float32, rays_traced int64 [])``."""
    o = tuple(origin.unbind(-1))
    d = tuple(direction.unbind(-1))
    shape = o[0].shape
    f32 = dict(dtype=torch.float32, device=origin.device)
    throughput = (torch.ones(shape, **f32),) * 3
    sigma_a = (torch.zeros(shape, **f32),) * 3
    sigma_s = torch.zeros(shape, **f32)
    alive = torch.ones(shape, dtype=torch.bool, device=origin.device)
    prev_state = torch.zeros(shape, **f32)
    radiance = [torch.zeros(shape, **f32) for _ in range(3)]
    nrays = torch.zeros((), dtype=torch.int64, device=origin.device)
    ray_mult = 2 if nee else 1

    for dep in range(max_depth):
        nrays = nrays + alive.sum() * ray_mult
        u = hash_uniforms_planes(seed, sample_idx, dep, 11)
        out = bounce_physics(
            o, d, throughput, sigma_a, sigma_s, gtab, mtab, ltab, scal,
            u, dep, prev_state, nee=nee, t_min=T_MIN, features=features,
        )
        radiance = [r + torch.where(alive, c, 0.0) for r, c in zip(radiance, out["contrib"])]
        new_alive = alive & (~out["terminate"])
        throughput = tuple(
            torch.where(new_alive, t * m, t) for t, m in zip(throughput, out["thr_mult"])
        )
        if rr:
            p = torch.clamp(
                torch.maximum(torch.maximum(throughput[0], throughput[1]), throughput[2]),
                0.05, 1.0,
            )
            rr_active = new_alive & (dep >= rr_start)
            survive = out["rru"] < p
            inv_p = 1.0 / p
            throughput = tuple(torch.where(rr_active, t * inv_p, t) for t in throughput)
            new_alive = new_alive & (survive | (~rr_active))
        o = tuple(torch.where(new_alive, n, prev) for n, prev in zip(out["next_o"], o))
        d = tuple(torch.where(new_alive, n, prev) for n, prev in zip(out["next_d"], d))
        alive = new_alive
        prev_state = out["wspec"]
        sigma_a = out["out_ma"]
        sigma_s = out["out_ms"]
    return torch.stack(radiance, dim=-1), nrays


def _lib():
    lib = _build.load("trace")
    fn = lib.trace_launch
    if fn.argtypes is None:  # without argtypes ctypes would cut pointers to 32 bits
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int,  # geom table, G
            ctypes.c_void_p, ctypes.c_int,  # material table, M
            ctypes.c_void_p, ctypes.c_void_p,  # light table, scalars
            ctypes.c_uint,  # seed
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # origin, dir, sample
            ctypes.c_int,  # n
            ctypes.c_void_p, ctypes.c_void_p,  # radiance, nrays
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # depth, nee, rr, rr_start
            ctypes.c_void_p,  # stream
        ]
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def trace_cuda(
    gtab, mtab, ltab, scal, seed: int, origin, direction, sample_idx,
    *, max_depth: int, nee: bool, rr: bool, rr_start: int,
):
    """Launch the trace kernel: ``(radiance [N, 3], rays_traced int64 [])``
    on the rays' CUDA device, on the current stream.  The tables are those
    of :func:`pack_tables`, which checks the material ids."""
    global launches
    device = origin.device
    if device.type != "cuda":
        raise ValueError(f"trace_cuda needs CUDA tensors, got {device}")
    n = origin.shape[0]
    if 3 * n >= 2**31:  # the kernel indexes the [N, 3] planes with 32-bit ints
        raise ValueError(f"trace kernel takes fewer than {2**31 // 3} rays, got {n}")
    g, m = gtab.shape[0], mtab.shape[0]
    if not 1 <= g <= MAX_GEOMS or not 1 <= m <= MAX_MATERIALS:
        raise ValueError(
            f"trace kernel takes 1..{MAX_GEOMS} geoms and 1..{MAX_MATERIALS} "
            f"materials, got {g} and {m}"
        )
    f32 = torch.float32
    _check(gtab, "geom table", f32, (g, GEOM_COLS), device)
    _check(mtab, "material table", f32, (m, MAT_COLS), device)
    _check(ltab, "light table", f32, (g, LIGHT_COLS), device)
    _check(scal, "scalars", f32, (2,), device)
    _check(origin, "origin", f32, (n, 3), device)
    _check(direction, "direction", f32, (n, 3), device)
    # uint32 sample bits as int32 (two's complement) for the kernel
    bits = ((sample_bits(sample_idx) ^ 0x80000000) - 0x80000000).to(torch.int32)
    _check(bits, "sample_idx", torch.int32, (n,), device)

    radiance = torch.empty((n, 3), dtype=f32, device=device)
    nrays = torch.zeros((), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib()(
        gtab.data_ptr(), g, mtab.data_ptr(), m, ltab.data_ptr(), scal.data_ptr(),
        int(seed) & 0xFFFFFFFF,
        origin.data_ptr(), direction.data_ptr(), bits.data_ptr(), n,
        radiance.data_ptr(), nrays.data_ptr(),
        int(max_depth), int(bool(nee)), int(bool(rr)), int(rr_start), stream,
    )
    if err != 0:
        raise RuntimeError(f"trace kernel launch failed: CUDA error {err}")
    launches += 1
    return radiance, nrays


def trace_fused(scene, rays, sample_idx, seed: int, cfg, tables=None):
    """The whole bounce loop for one wavefront: ``(radiance [N, 3],
    rays_traced int64 [])``.  ``tables`` are :func:`pack_tables` of the
    scene (packed here when not given)."""
    check_features(cfg.features)
    if not fused_trace_eligible(scene, cfg):
        raise NotImplementedError(
            "trace of meshes, image textures or fast_rng=False: later slice"
        )
    gtab, mtab, ltab, scal = tables if tables is not None else pack_tables(scene)
    kw = dict(
        max_depth=cfg.max_depth, nee=cfg.nee, rr=cfg.russian_roulette,
        rr_start=cfg.rr_start,
    )
    args = (gtab, mtab, ltab, scal, seed, rays.origin, rays.direction, sample_idx)
    device_type = rays.origin.device.type
    if device_type == "cuda":
        return trace_cuda(*args, **kw)
    if device_type == "cpu":
        return trace_plain(*args, **kw, features=frozenset(cfg.features))
    raise ValueError(f"no trace for device type {device_type!r}")
