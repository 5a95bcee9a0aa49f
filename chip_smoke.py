"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out-dir DIR]

Phases (any failure exits non-zero):

1. build every kernel of ``pathtracer_tpu_torch/csrc`` with nvcc (one
   process per source, all at once) and print ptxas' register / spill
   report;
2. drive the main path: Cornell at its full 800x800, depth 8, NEE, through
   ``pathtracer_tpu_torch.render.integrator.render`` on the card, with the
   launch counters zeroed just before; every kernel of the path must have
   launched (the trace kernel once per progressive iteration);
3. hold each kernel against its plain PyTorch version on the card, on the
   main path's own inputs (the 640,000 primary rays of an iteration):
   equal ray counts, radiance within rtol = atol = 2e-6 on at least 99.9%
   of lanes, and the image sum within 1e-5 relative;
4. time the kernel (CUDA events over a steady window) and its plain
   version, and print ms per iteration and Mrays/s beside the card's name
   and power limit;
5. check the output: finite image of the expected shape, and the port's
   render of the ``cornell_96`` golden configuration against
   ``tests/golden/cornell_96.npy``; write the PNG, and run the CLI once;
6. print the kernels' JSON line, then ``{"ok": true, "device": ...}``.

The rendered PNGs and the profile table go to ``--out-dir`` (default
``renders/chip_smoke``).

Imports nothing of JAX and nothing of ``pathtracer_tpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# fp32 operations per lane of csrc/trace.cu, counted by hand from the source
# (multiply, add, compare, select, min/max, sqrt, rsqrt, divide, sin, cos
# each one): the object-space transform of one geom, the sphere and cube
# tests, and the shading of one non-emissive hit (hit point and frame,
# diffuse BSDF sample, light sample and NEE geometry).  Shadow-ray sweeps
# are left out: which lanes trace them depends on the data and the kernel
# does not count them, so the bound below is a lower bound.
OPS_TO_OBJECT = 33
OPS_SPHERE = 37 + 2
OPS_CUBE = 46 + 2
OPS_SHADE = 270


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` calls (after one
    warm-up call), from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=os.path.join(ROOT, "renders", "chip_smoke"))
    out_dir = parser.parse_args().out_dir

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import _build, trace
    from pathtracer_tpu_torch.ops.bounce import pack_tables
    from pathtracer_tpu_torch.ops.camera import camera_uniforms, generate_camera_rays
    from pathtracer_tpu_torch.ops.rng import key_to_seed, prng_key
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.integrator import render, render_chunk
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.utils.imageio import load_png, save_image

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"

    # ---- 1. build
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build:{name}] {line.strip()}")

    # ---- 2. the main path at full width
    desc = load_scene(os.path.join(ROOT, "scenes", "cornell.txt"))
    scene = desc.scene_for_frame(0, device=dev)
    w, h = scene.camera.width, scene.camera.height
    n = w * h
    cfg = RenderConfig(max_depth=8, nee=True, iters_per_launch=4)
    spp = 8
    trace.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, accum, stats = render(scene, spp, cfg, device=dev)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    main_launches = {"trace": trace.launches}
    print(
        f"[main] cornell {w}x{h} d{cfg.max_depth} nee spp={spp}: {render_s:.3f} s, "
        f"rays {stats['rays_traced']}, launches {main_launches}"
    )
    check(main_launches["trace"] == spp, f"trace launches {main_launches['trace']} != {spp}")
    check(tuple(img.shape) == (h, w, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(accum).all()), "non-finite accumulator")
    check(bool((accum >= 0).all()), "negative radiance")
    save_image(os.path.join(out_dir, "chip_smoke_cornell.png"), img.cpu().numpy())

    # ---- 3. kernel vs plain on the card, on the main path's inputs
    seed = key_to_seed(prng_key(cfg.seed))
    tables = pack_tables(scene)
    pixel = torch.arange(n, dtype=torch.int64, device=dev)
    kw = dict(max_depth=cfg.max_depth, nee=cfg.nee, rr=False, rr_start=cfg.rr_start)
    worst_abs = 0.0
    for it in (0, 1):
        sample = it * n + pixel
        rays = generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, sample))
        args = (*tables, seed, rays.origin, rays.direction, sample)
        rad_k, nr_k = trace.trace_cuda(*args, **kw)
        rad_p, nr_p = trace.trace_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = (rad_k - rad_p).abs()
        beyond = (diff > 2e-6 + 2e-6 * rad_p.abs()).any(-1)
        n_beyond = int(beyond.sum())
        sum_rel = float((rad_k.double().sum() - rad_p.double().sum()).abs() / rad_p.double().sum())
        worst_abs = max(worst_abs, float(diff.max()))
        print(
            f"[check] iteration {it}: rays kernel {int(nr_k)} plain {int(nr_p)}; lanes beyond "
            f"2e-6: {n_beyond} of {n}; max abs err {float(diff.max()):.3g}; sum rel {sum_rel:.3g}"
        )
        check(int(nr_k) == int(nr_p), "ray counts differ")
        check(n_beyond <= n // 1000, f"{n_beyond} lanes beyond tolerance (> 0.1%)")
        check(sum_rel <= 1e-5, f"image sum differs by {sum_rel:.3g} relative")

    # ---- 4. timing on the main path's shapes
    rays_per_iter = int(nr_k)
    k_ms = cuda_ms(lambda: trace.trace_cuda(*args, **kw), reps=20)
    p_ms = cuda_ms(lambda: trace.trace_plain(*args, **kw), reps=2)
    rcfg = resolve_features(cfg, scene.materials)
    acc0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    iter_ms = cuda_ms(lambda: render_chunk(scene, acc0, 0, seed, rcfg, 1, tables=tables), reps=5)
    cam_ms = cuda_ms(
        lambda: generate_camera_rays(scene.camera, pixel, camera_uniforms(seed, pixel)), reps=5
    )
    # where one render iteration's device time goes, and how idle the card is
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            render_chunk(scene, acc0, 0, seed, rcfg, 1, tables=tables)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    kernels_run = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels_run) / 1e3 / 3
    top = sorted(kernels_run, key=dev_us, reverse=True)[:4]
    with open(os.path.join(out_dir, "profile_render_iteration.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=25))
    print(
        f"[profile] render iteration: device busy {busy_ms:.4f} ms; wall {iter_ms:.4f} ms "
        f"unprofiled ({wall_ms:.4f} ms profiled); idle share {1 - busy_ms / iter_ms:.3f}; top: "
        + "; ".join(f"{e.key[:40]} x{e.count // 3} {dev_us(e) / 1e3 / 3:.4f} ms" for e in top)
        + f"; {sum(e.count for e in kernels_run) // 3} kernels per iteration"
    )
    lane_bounces = rays_per_iter // (2 if cfg.nee else 1)
    types = scene.geoms.type.tolist()
    sweep = sum(OPS_TO_OBJECT + (OPS_SPHERE if t == 0 else OPS_CUBE) for t in types)
    ops = lane_bounces * (sweep + OPS_SHADE)
    bytes_moved = n * (12 + 12 + 4 + 12) + sum(t.numel() * 4 for t in tables)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    bound_by = "operations" if ops / FP32_OPS_PER_S > bytes_moved / HBM_BYTES_PER_S else "bytes"
    print(f"[card] {card}")
    print(
        f"[time] trace kernel {k_ms:.4f} ms/iteration ({rays_per_iter / k_ms / 1e3:.1f} Mrays/s), "
        f"plain {p_ms:.3f} ms, camera rays {cam_ms:.4f} ms, render iteration {iter_ms:.4f} ms "
        f"({rays_per_iter / iter_ms / 1e3:.1f} Mrays/s); bound {bound_ms:.4f} ms by {bound_by} "
        f"({ops} fp32 ops, {bytes_moved} bytes); on {card}"
    )

    # ---- 5. golden check of the port's render on the card, CLI entry point
    golden_desc = dataclasses.replace(desc, resolution=(96, 96))
    gscene = golden_desc.scene_for_frame(0, device=dev)
    gimg, gacc, _ = render(
        gscene, 16, RenderConfig(nee=True, max_depth=8, iters_per_launch=8), device=dev
    )
    golden = torch.from_numpy(
        np.load(os.path.join(ROOT, "tests", "golden", "cornell_96.npy"))
    ).to(dev)
    within = (gacc - golden).abs() <= 1e-5 * (golden.abs() + 1e-3)
    frac = float(within.float().mean())
    gsum_rel = float((gacc.double().sum() - golden.double().sum()).abs() / golden.double().sum())
    png = torch.from_numpy(load_png(os.path.join(ROOT, "tests", "golden", "cornell_96.png"))).to(dev)
    png_mean = float((gimg - png.float() / 255.0).abs().mean()) * 255.0
    print(
        f"[golden] cornell_96: {frac:.5f} of entries within 1e-5 rel, sum rel {gsum_rel:.3g}, "
        f"PNG mean abs {png_mean:.3f}/255"
    )
    check(frac >= 0.95 and gsum_rel <= 1e-4 and png_mean <= 0.8, "golden cornell_96 check failed")

    cli = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.cli", "scene=scenes/cornell.txt",
         "--spp", "2", "--device", "cuda", "--out", os.path.join(out_dir, "cli_cornell.png")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    print(f"[cli] exit {cli.returncode}: {cli.stdout.strip()} {cli.stderr.strip()[-2000:]}")
    check(cli.returncode == 0, "CLI run failed")

    # ---- 6. results
    kernels = [
        {
            "name": "trace",
            "route": "cuda",
            "source": "pathtracer_tpu_torch/csrc/trace.cu",
            "replaces": "pathtracer_tpu/ops/trace_pallas.py:62",
            "launches": main_launches["trace"],
            "max_abs_err": worst_abs,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        }
    ]
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
