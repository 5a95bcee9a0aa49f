"""Command-line entry point: forward render of a frame, every frame, or a
frame's shutter interval.

Port of ``pathtracer_tpu/cli.py``: the reference-style ``scene=<file>
frame=<n>`` key=value arguments next to the flags ``--scene --frame --spp
--depth --out --seed --no-jitter``, ``--engine auto|wavefront|megakernel``
(``cli.py:58-62,134-160``), ``--all-frames`` (one image per animation
frame), ``--motion-blur`` (``render/motion.render_motion`` of ``[frame,
frame + 1]``; ``cli.py:67-71,184-245``) and ``--device`` (default
``cuda``).  Frame ``f`` is written to ``<stem>.<f>.<ext>`` of ``--out`` or
the scene's ``FILE``.  ``auto`` takes the megakernel, the full-depth trace
kernel, for scenes inside its scope on a CUDA device (analytic scenes, and
mesh scenes of at most 4096 triangles with the in-kernel sweep), where the
TPU took it on a TPU, and the wavefront engine otherwise.  Checkpoints,
previews, sharding, the debug engine and the interactive mode belong to
later slices.

    python -m pathtracer_tpu_torch.cli scene=scenes/cornell.txt --spp 16
    python -m pathtracer_tpu_torch.cli scene=scenes/animation.txt --all-frames
"""

from __future__ import annotations

import argparse
import sys
import time

from pathtracer_tpu_torch.config import RenderConfig


def _split_kv_args(argv):
    """Accept the reference's ``scene=x frame=n`` positionals alongside flags."""
    kv, rest = {}, []
    for a in argv:
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            kv[k] = v
        else:
            rest.append(a)
    return kv, rest


def build_argparser():
    p = argparse.ArgumentParser(
        prog="pathtracer-tpu-torch", description="PyTorch/CUDA path tracer"
    )
    p.add_argument("--scene", help="scene DSL file")
    p.add_argument("--frame", type=int, default=0, help="animation frame")
    p.add_argument("--spp", type=int, default=None, help="override ITERATIONS")
    p.add_argument("--depth", type=int, default=8, help="max path depth")
    p.add_argument("--out", default=None, help="override output image path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-jitter", action="store_true", help="disable AA jitter")
    p.add_argument(
        "--engine",
        choices=["auto", "wavefront", "megakernel"],
        default="auto",
        help="path tracing engine (auto: the full-depth trace kernel for the scenes "
        "it takes on CUDA, wavefront otherwise)",
    )
    p.add_argument("--all-frames", action="store_true", help="render every animation frame")
    p.add_argument(
        "--motion-blur",
        action="store_true",
        help="render the shutter interval [frame, frame+1] with motion blur",
    )
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def _out_path(out, image_name, frame):
    base = out or image_name
    stem, ext = base.rsplit(".", 1) if "." in base else (base, "png")
    return f"{stem}.{frame}.{ext}"  # the frame number goes before the extension


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv, rest = _split_kv_args(argv)
    parser = build_argparser()
    args = parser.parse_args(rest)
    if "scene" in kv:
        args.scene = kv["scene"]
    if "frame" in kv:
        args.frame = int(kv["frame"])
    if not args.scene:
        parser.error("a scene file is required (scene=<file> or --scene)")

    from pathtracer_tpu_torch.ops.trace import fused_trace_eligible
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.integrator import render, resolve_device
    from pathtracer_tpu_torch.render.motion import render_motion
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.utils.imageio import save_image

    device = resolve_device(args.device)
    desc = load_scene(args.scene)
    spp = args.spp if args.spp is not None else desc.iterations
    engine = args.engine
    if engine == "auto":
        scene = desc.scene_for_frame(args.frame, device=device)
        probe = resolve_features(RenderConfig(), scene.materials)
        eligible = fused_trace_eligible(scene, probe)
        engine = "megakernel" if eligible and device.type == "cuda" else "wavefront"
    cfg = RenderConfig(max_depth=args.depth, jitter=not args.no_jitter, seed=args.seed,
                       wavefront=engine == "wavefront")
    w, h = desc.resolution
    for frame in range(desc.frames) if args.all_frames else [args.frame]:
        print(
            f"[pathtracer-tpu-torch] frame {frame}: {w}x{h}, {spp} spp, "
            f"depth {cfg.max_depth}, engine={engine}, device={device}"
            + (" (motion blur)" if args.motion_blur else "")
        )
        t0 = time.perf_counter()
        if args.motion_blur:
            img, _, stats = render_motion(desc, frame, spp, cfg, device=device)
        else:
            img, _, stats = render(desc.scene_for_frame(frame, device=device), spp, cfg,
                                   device=device)
        img = img.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        path = save_image(_out_path(args.out, desc.image_name, frame), img)
        print(
            f"  saved {path} ({dt:.1f}s, {spp * w * h / dt / 1e6:.1f} Mpaths/s, "
            f"{stats['rays_traced'] / dt / 1e6:.1f} Mrays/s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
