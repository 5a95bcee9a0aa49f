"""Interactive camera: a headless REPL with a live progressive preview.

Port of ``pathtracer_tpu/render/interactive.py:1-297``.  The reference's
window has a keyboard callback (``src/main.cpp:221-228``); a render node
has no window, so this is a terminal REPL: WASD-style camera commands, a
fast progressive preview re-rendered after every move, and a full-quality
save on demand.

The preview is progressive, like the reference's redraw every iteration
(``src/main.cpp:201-218``): while no input is pending it keeps adding
``spp``-sized chunks of samples to the preview accumulator and rewriting
the preview PNG, up to the scene's iteration budget.  A camera move
restarts the accumulator; ``refine N`` adds N chunks at once (and is how
tests without a terminal drive the progressive path).

A move replaces only the camera's four tensors (position, view, up, fov):
the scene's other tensors keep their values and shapes, so every render
after the first runs the kernels the first one built (``ops/_build.py``
builds each once per process), on tables of the same size.

Commands (one per line, chainable: ``w w a l``):
  w / s      dolly forward / back      a / d    truck left / right
  q / e      pedestal down / up        i / k    pitch up / down
  j / l      yaw left / right          + / -    zoom in / out (fov)
  spp N      preview samples           save [f] full-quality render
  refine N   accumulate N more chunks  reset    restore the scene camera
  stat       print camera state        help     this text
  quit       exit
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

HELP = __doc__[__doc__.index("Commands") :]

MOVE_FRAC = 0.05  # dolly / truck step as a fraction of |view|
ROT_DEG = 5.0  # pitch / yaw step
ZOOM_DEG = 2.5  # fov step

# every bare token the REPL understands (tells "save [f]" from "save" + a command)
_COMMANDS = frozenset(
    "w s a d q e i k j l + - spp save refine reset stat help quit exit".split()
)


def _input_pending(stream, timeout: float) -> bool:
    """True if ``stream`` has input ready within ``timeout`` seconds.
    Streams ``select`` cannot watch (``io.StringIO`` in tests) report
    pending, so the idle refinement steps aside."""
    try:
        import select

        r, _, _ = select.select([stream], [], [], timeout)
        return bool(r)
    except (OSError, ValueError, TypeError, AttributeError):
        return True


def _rotate(v, axis, deg):
    """Rodrigues rotation of ``v`` around unit ``axis`` by ``deg``."""
    axis = axis / np.linalg.norm(axis).clip(1e-12)
    th = np.deg2rad(deg)
    return (
        v * np.cos(th)
        + np.cross(axis, v) * np.sin(th)
        + axis * np.dot(axis, v) * (1.0 - np.cos(th))
    )


def _float64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64).copy()


class CameraRig:
    """Mutable camera state (numpy float64) and the camera it resets to."""

    def __init__(self, camera):
        self._camera0 = camera
        self.reset()

    def reset(self):
        c = self._camera0
        self.position = _float64(c.position)
        self.view = _float64(c.view)
        self.up = _float64(c.up)
        self.fov = _float64(c.fov)

    @property
    def _basis(self):
        fwd = self.view / np.linalg.norm(self.view).clip(1e-12)
        right = np.cross(fwd, self.up)
        right /= np.linalg.norm(right).clip(1e-12)
        return fwd, right

    def apply(self, cmd: str) -> bool:
        """Apply one movement command; True if the camera changed."""
        step = MOVE_FRAC * np.linalg.norm(self.view)
        fwd, right = self._basis
        if cmd == "w":
            self.position += step * fwd
        elif cmd == "s":
            self.position -= step * fwd
        elif cmd == "a":
            self.position -= step * right
        elif cmd == "d":
            self.position += step * right
        elif cmd == "q":
            self.position -= step * self.up / np.linalg.norm(self.up).clip(1e-12)
        elif cmd == "e":
            self.position += step * self.up / np.linalg.norm(self.up).clip(1e-12)
        elif cmd == "i":
            self.view = _rotate(self.view, right, ROT_DEG)
        elif cmd == "k":
            self.view = _rotate(self.view, right, -ROT_DEG)
        elif cmd == "j":
            self.view = _rotate(self.view, self.up, ROT_DEG)
        elif cmd == "l":
            self.view = _rotate(self.view, self.up, -ROT_DEG)
        elif cmd == "+":
            self.fov = np.maximum(self.fov - ZOOM_DEG, 5.0)
        elif cmd == "-":
            self.fov = np.minimum(self.fov + ZOOM_DEG, 85.0)
        else:
            return False
        return True

    def camera(self, base):
        """``base`` (the port's ``Camera``) with the rig's state as float32
        tensors on ``base``'s device."""
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=base.position.device)

        return dataclasses.replace(base, position=f32(self.position), view=f32(self.view),
                                   up=f32(self.up), fov=f32(self.fov))

    def describe(self) -> str:
        p, v = self.position, self.view
        return (
            f"eye=({p[0]:.2f}, {p[1]:.2f}, {p[2]:.2f}) "
            f"view=({v[0]:.2f}, {v[1]:.2f}, {v[2]:.2f}) fovy={self.fov[1]:.1f}"
        )


def interactive_loop(
    desc,
    frame: int,
    cfg,
    preview_spp: int = 16,
    out_path: str = "renders/interactive.png",
    full_spp: int | None = None,
    stdin=None,
    stdout=None,
    max_commands: int | None = None,
    device="cuda",
    state: dict | None = None,
):
    """Run the REPL on ``device``; returns the number of renders.
    ``stdin`` / ``stdout`` are injectable for tests.  ``state``, when
    given, is the dict the loop keeps its preview in (``accum``, ``spp``,
    ``png8``) and its ``rig``, for a caller that reads them afterwards."""
    from pathtracer_tpu_torch.ops.rng import prng_key
    from pathtracer_tpu_torch.render.integrator import render, resolve_device
    from pathtracer_tpu_torch.utils.imageio import save_image

    device = resolve_device(device)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    scene = desc.scene_for_frame(frame, device=device)
    rig = CameraRig(scene.camera)
    full_spp = full_spp or desc.iterations
    w, h = scene.camera.width, scene.camera.height
    n_renders = 0

    def emit(msg):
        print(msg, file=stdout, flush=True)

    # the progressive preview of the current camera: the sum accumulator,
    # the samples done and the last 8-bit frame written; a move resets it
    prog = state if state is not None else {}
    prog.update(accum=None, spp=0, png8=None, rig=rig)

    def rig_scene():
        return dataclasses.replace(scene, camera=rig.camera(scene.camera))

    def refine_chunk():
        """Add one ``preview_spp`` chunk and rewrite the PNG, unless the
        8-bit frame did not change."""
        nonlocal n_renders
        t0 = time.perf_counter()
        img, accum, _ = render(rig_scene(), preview_spp, cfg, base_key=prng_key(cfg.seed),
                               accum=prog["accum"], start_iteration=prog["spp"], device=device)
        img = img.cpu().numpy()  # waits for the device
        prog["accum"] = accum
        prog["spp"] += preview_spp
        img8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if prog["png8"] is None or not np.array_equal(img8, prog["png8"]):
            path = save_image(out_path, img)
            prog["png8"] = img8
        else:
            path = out_path  # the same frame at 8 bits: not written again
        n_renders += 1
        return path, time.perf_counter() - t0

    def preview():
        prog["accum"] = None
        prog["spp"] = 0
        path, dt = refine_chunk()
        emit(f"  [{rig.describe()}] {prog['spp']} spp in {dt:.2f}s -> {path}")

    emit(f"[interactive] {w}x{h}, preview {preview_spp} spp — 'help' for keys")
    preview()
    n_cmds = 0
    while True:
        # refine while idle, until input arrives or the scene's iteration
        # budget is reached; the 50 ms select timeout between chunks yields
        # the core while waiting (the reference redraws per display tick)
        while prog["spp"] < full_spp and not _input_pending(stdin, 0.05):
            refine_chunk()
            if max_commands is not None and n_renders > max_commands + 64:
                break  # a bound for test rigs without a driver
        line = stdin.readline()
        if not line:
            break
        tokens = line.split()
        i = 0
        while i < len(tokens):
            cmd = tokens[i]
            i += 1
            n_cmds += 1
            if max_commands is not None and n_cmds > max_commands:
                return n_renders
            cmd_l = cmd.lower()
            # two-token forms ("spp 32", "save out.png") fold the next token
            # into the command; the '=' forms stay
            if cmd_l == "spp" and i < len(tokens):
                cmd_l = f"spp={tokens[i]}"
                i += 1
            elif cmd_l == "refine" and i < len(tokens):
                cmd_l = f"refine={tokens[i]}"
                i += 1
            elif cmd_l == "save" and i < len(tokens) and tokens[i].lower() not in _COMMANDS:
                # "save [f]": the next token is the file unless it is a command
                cmd_l = f"save={tokens[i]}"
                i += 1
            if cmd_l in ("quit", "exit", "\x1b"):
                return n_renders
            if cmd_l == "help":
                emit(HELP)
            elif cmd_l == "stat":
                emit("  " + rig.describe())
            elif cmd_l == "reset":
                rig.reset()
                preview()
            elif cmd_l.startswith("refine"):
                try:
                    n_chunks = int(cmd_l.split("=", 1)[1]) if "=" in cmd_l else 1
                except ValueError:
                    emit(f"  ? refine wants a number, got {cmd_l.split('=', 1)[1]!r}")
                    continue
                for _ in range(max(1, n_chunks)):
                    path, dt = refine_chunk()
                emit(f"  refined to {prog['spp']} spp -> {path}")
            elif cmd_l.startswith("spp="):
                try:
                    preview_spp = max(1, int(cmd_l.split("=", 1)[1]))
                    emit(f"  preview spp = {preview_spp}")
                except ValueError:
                    emit(f"  ? spp wants a number, got {cmd_l.split('=', 1)[1]!r}")
            elif cmd_l.startswith("save"):
                target = (
                    cmd_l.split("=", 1)[1] if "=" in cmd_l else out_path
                ).replace(".png", ".full.png")
                t0 = time.perf_counter()
                img, _, _ = render(rig_scene(), full_spp, cfg, base_key=prng_key(cfg.seed),
                                   device=device)
                path = save_image(target, img.cpu().numpy())
                n_renders += 1
                emit(f"  saved {path} ({full_spp} spp, {time.perf_counter() - t0:.1f}s)")
            elif rig.apply(cmd_l):
                preview()
            else:
                emit(f"  ? unknown command {cmd!r} — 'help' for keys")
    return n_renders
