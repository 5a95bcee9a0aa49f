"""Command-line entry point: progressive render of a frame, every frame, or a
frame's shutter interval, with previews, checkpoints and resume.

Port of ``pathtracer_tpu/cli.py``: the reference-style ``scene=<file>
frame=<n>`` key=value arguments next to the flags ``--scene --frame --spp
--depth --out --seed --no-jitter``, ``--engine auto|wavefront|megakernel``
(``cli.py:58-62,134-160``), ``--preview-every N`` (a tone-mapped PNG
``<stem>.<frame>.preview.<ext>`` every N spp), ``--checkpoint FILE`` and
``--checkpoint-every N`` (``utils/checkpoint.py`` every N spp; a render
whose frame matches the file resumes from it), ``--all-frames`` (one image
per animation frame), ``--motion-blur`` (``render/motion.render_motion`` of
``[frame, frame + 1]``), ``--interactive`` (the camera REPL of
``render/interactive.py``), ``--debug`` (``RenderConfig.debug``: the
per-chunk finite check, and the alive histogram on the megakernel engine),
``--resume-on-failure`` (``cli.py:27-30,97-105,250-335``: a render that
raises is retried from the last good checkpoint, up to
:data:`MAX_FAILURE_RETRIES` times), ``--sharded`` (``cli.py:78-85,118-130,
174-181``: ``parallel/sharded.render_sharded`` over the shards of
``parallel/mesh.make_mesh``, on the wavefront engine), ``--profile DIR``
(the frame loop under ``utils/metrics.profile_trace``: a Chrome trace,
``DIR/trace.json``, whose ``pt.*`` spans name the layer that launched each
kernel) and ``--device`` (default ``cuda``; JAX's ``--platform``).  Frame ``f`` is written to
``<stem>.<f>.<ext>`` of ``--out`` or the scene's ``FILE``.  ``auto`` takes
the megakernel, the full-depth trace kernel, for scenes inside its scope on
a CUDA device (analytic scenes, and mesh scenes of at most 4096 triangles
with the in-kernel sweep), where JAX took it on a TPU, and the wavefront
engine otherwise.

Under ``--sharded`` every process of a ``torchrun`` launch joins the group
(``parallel/mesh.initialize_distributed``: NCCL on ``cuda``, gloo on
``cpu``) and owns one shard, on ``cuda:LOCAL_RANK`` (``--device cpu``: one
CPU shard); without a launcher one process owns a shard per local card.
Only rank 0 prints and writes.  Previews and checkpoints gather the
accumulator to pixel order on every rank first, and a checkpoint is in
pixel order, so a single-device checkpoint resumes sharded and the other
way round.

A fault of the CUDA device itself (an illegal address, a launch failure)
leaves the process's CUDA context unusable, so ``--resume-on-failure``
cannot recover from it in the same process: the retry raises again, and
the checkpoint on disk is what a new process resumes from.

    python -m pathtracer_tpu_torch.cli scene=scenes/cornell.txt --spp 16
    python -m pathtracer_tpu_torch.cli scene=scenes/cornell.txt --spp 64 \\
        --checkpoint renders/cornell.npz --checkpoint-every 16 --resume-on-failure
    python -m pathtracer_tpu_torch.cli scene=scenes/cornell.txt --interactive
    torchrun --nproc_per_node=<GPUs> -m pathtracer_tpu_torch.cli \\
        scene=scenes/cornell.txt --sharded
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from pathtracer_tpu_torch.config import RenderConfig

# retries of --resume-on-failure: a transient fault clears on retry; a
# failure that recurs (NaN physics under --debug) exhausts them and the
# last error is raised
MAX_FAILURE_RETRIES = 3


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
    p.add_argument("--preview-every", type=int, default=0, help="dump preview PNG every N spp")
    p.add_argument("--checkpoint-every", type=int, default=0, help="save resume state every N spp")
    p.add_argument("--checkpoint", default=None, help="checkpoint file to resume from / write")
    p.add_argument("--all-frames", action="store_true", help="render every animation frame")
    p.add_argument(
        "--motion-blur",
        action="store_true",
        help="render the shutter interval [frame, frame+1] with motion blur",
    )
    p.add_argument(
        "--sharded",
        action="store_true",
        help="render on a mesh of shards with strided pixel ownership: one per process "
        "of a torchrun launch (torch.distributed, NCCL on cuda, gloo on cpu; "
        "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), or one per local "
        "card (see parallel/mesh.py)",
    )
    p.add_argument(
        "--interactive",
        action="store_true",
        help="interactive camera REPL (WASD moves, live preview)",
    )
    p.add_argument(
        "--debug",
        action="store_true",
        help="debug mode: a finite check of the accumulator after every chunk and the "
        "per-bounce alive-lane histogram (megakernel engine)",
    )
    p.add_argument(
        "--resume-on-failure",
        action="store_true",
        help="if a render raises (a --debug finite check, a transient fault), reload "
        "the last good checkpoint and retry from it (up to "
        f"{MAX_FAILURE_RETRIES} times); needs --checkpoint and --checkpoint-every for "
        "resume points inside a frame. A CUDA device fault poisons the process and "
        "is not recovered here",
    )
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="record the frame loop under torch.profiler and write a Chrome trace, "
        "DIR/trace.json, whose pt.* spans name the layer of every kernel",
    )
    return p


def _out_path(out, image_name, frame, suffix=""):
    base = out or image_name
    stem, ext = base.rsplit(".", 1) if "." in base else (base, "png")
    return f"{stem}.{frame}{suffix}.{ext}"  # the frame number goes before the extension


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
    if args.sharded and (args.interactive or args.motion_blur):
        parser.error("--sharded does not combine with --interactive/--motion-blur")

    import torch

    made_group = False
    if args.sharded:
        from pathtracer_tpu_torch.parallel.mesh import initialize_distributed

        # the rendezvous comes before the first use of a device
        made_group = initialize_distributed(args.device)
    try:
        return _run(args)
    finally:
        if made_group:
            torch.distributed.destroy_process_group()


def _run(args):
    import torch

    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.ops.tonemap import tonemap
    from pathtracer_tpu_torch.ops.trace import fused_trace_eligible
    from pathtracer_tpu_torch.render import integrator
    from pathtracer_tpu_torch.render.features import resolve_features
    from pathtracer_tpu_torch.render.motion import render_motion
    from pathtracer_tpu_torch.scene.parser import load_scene
    from pathtracer_tpu_torch.utils import checkpoint as ckpt
    from pathtracer_tpu_torch.utils import metrics
    from pathtracer_tpu_torch.utils.imageio import save_image

    device = integrator.resolve_device(args.device)
    desc = load_scene(args.scene)
    spp = args.spp if args.spp is not None else desc.iterations
    engine = "wavefront" if args.sharded else args.engine
    if engine == "auto":
        scene = desc.scene_for_frame(args.frame, device=device)
        probe = resolve_features(RenderConfig(), scene.materials)
        eligible = fused_trace_eligible(scene, probe)
        engine = "megakernel" if eligible and device.type == "cuda" else "wavefront"
    mesh = None
    if args.sharded:
        from pathtracer_tpu_torch.parallel import mesh as pmesh
        from pathtracer_tpu_torch.parallel.sharded import gather_image, render_sharded

        mesh = pmesh.make_mesh([device] if device.type == "cpu" else None)
    is_main = mesh is None or mesh.rank == 0
    cfg = RenderConfig(max_depth=args.depth, jitter=not args.no_jitter, seed=args.seed,
                       wavefront=engine == "wavefront", debug=args.debug)

    if args.interactive:
        from pathtracer_tpu_torch.render.interactive import interactive_loop

        interactive_loop(desc, args.frame, cfg, preview_spp=min(spp, 16),
                         out_path=args.out or "renders/interactive.png", full_spp=spp,
                         device=device)
        return 0

    w, h = desc.resolution

    def resume_point(frame):
        """``(accum on the device, spp done)`` of the checkpoint if it holds
        ``frame``, else ``(None, 0)``."""
        state = ckpt.load(args.checkpoint) if args.checkpoint else None
        if state is None or state["frame"] != frame:
            return None, 0
        return torch.from_numpy(state["accum"]).to(device), int(state["spp_done"])

    def say(line):
        if is_main:
            print(line)

    profiling = metrics.profile_trace(args.profile) if args.profile else contextlib.nullcontext()
    with profiling:
        for frame in range(desc.frames) if args.all_frames else [args.frame]:
            say(
                f"[pathtracer-tpu-torch] frame {frame}: {w}x{h}, {spp} spp, "
                f"depth {cfg.max_depth}, engine={engine}, device={device}, "
                f"devices={mesh.size if mesh else 1}"
                + (f" (sharded, {mesh.world} process(es))" if mesh else "")
                + (" (motion blur)" if args.motion_blur else "")
            )
            accum, start_it = resume_point(frame)
            if accum is not None:
                say(f"  resumed at {start_it} spp from {args.checkpoint}")
            t0 = time.perf_counter()

            def run_frame(accum, start_it, frame=frame):
                """One render attempt from ``(accum, start_it)``; raises when a
                chunk fails, for the retry loop below."""
                last = {"t": time.perf_counter(), "spp": start_it}

                def progress(done_in_run, acc):
                    done = start_it + done_in_run
                    now = time.perf_counter()
                    want_preview = args.preview_every and done % args.preview_every == 0
                    want_ckpt = (args.checkpoint and args.checkpoint_every
                                 and done % args.checkpoint_every == 0)
                    if mesh and (want_preview or want_ckpt):
                        acc = gather_image(acc, mesh)  # on every rank: it gathers across them
                    if want_preview and is_main:
                        img = tonemap(acc.reshape(h, w, 3), done).cpu().numpy()
                        save_image(_out_path(args.out, desc.image_name, frame, ".preview"), img)
                    if want_ckpt and is_main:
                        ckpt.save(args.checkpoint, acc, done, frame, cfg.seed)
                    rate = (done - last["spp"]) * w * h / max(now - last["t"], 1e-9) / 1e6
                    last["t"], last["spp"] = now, done
                    say(f"  {done}/{spp} spp  ({rate:.1f} Mpaths/s)")

                if mesh:
                    # a checkpoint's pixel-ordered accumulator is scattered to the shards
                    out = render_sharded(desc.scene_for_frame(frame, device=device),
                                         spp - start_it, cfg, mesh=mesh,
                                         base_key=prng_key(cfg.seed), progress_fn=progress,
                                         accum=accum, start_iteration=start_it)
                elif args.motion_blur:
                    # as JAX's CLI (cli.py:237-243): the remaining spp from
                    # iteration 0, without the checkpoint's accumulator
                    out = render_motion(desc, frame, spp - start_it, cfg,
                                        base_key=prng_key(cfg.seed), progress_fn=progress,
                                        device=device)
                else:
                    out = integrator.render(desc.scene_for_frame(frame, device=device),
                                            spp - start_it, cfg, base_key=prng_key(cfg.seed),
                                            accum=accum, start_iteration=start_it,
                                            progress_fn=progress, device=device)
                return out[0].cpu().numpy(), out[1], out[2]  # waits for the device

            # the periodic checkpoint written by progress() is the last good
            # state: a failed attempt reloads it and retries
            attempts = 0
            while True:
                try:
                    img, accum, stats = run_frame(accum, start_it)
                    break
                except KeyboardInterrupt:
                    raise
                except Exception as e:
                    attempts += 1
                    if not args.resume_on_failure or attempts > MAX_FAILURE_RETRIES:
                        raise
                    accum, start_it = resume_point(frame)
                    say(f"  render failed ({type(e).__name__}: {e}); resuming from {start_it} "
                        f"spp (attempt {attempts}/{MAX_FAILURE_RETRIES})")
            dt = time.perf_counter() - t0
            if is_main:
                path = save_image(_out_path(args.out, desc.image_name, frame), img)
                mrays = stats["rays_traced"] / dt / 1e6
                mpaths = (spp - start_it) * w * h / dt / 1e6
                print(f"  saved {path} ({dt:.1f}s, {mpaths:.1f} Mpaths/s, {mrays:.1f} Mrays/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
