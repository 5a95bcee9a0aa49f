"""Progressive preview render: one unit is one frame of ``spp_per_frame``
samples per pixel.

A frame calls the program's ``render/integrator.render`` on the scene at the
cell's resolution, carrying the accumulator and ``start_iteration`` forward,
then makes the tone-mapped image 8-bit on the device and copies it into a
page-locked host buffer that every frame reuses: what a user watching the
progressive preview waits for.  Set-up
parses the scene, builds (or loads) the kernels and renders one frame at
the cell's shapes, thrown away.

The check, after the window: the first frame's 8-bit image, every pixel,
and its ray count; and at pixels drawn from the seed the accumulator after
the last frame and that frame's 8-bit image, against the plain reference
(``reference/``) summing the same samples.
"""

from __future__ import annotations

import dataclasses

import torch

from port_bench.harness import cellkit
from port_bench.reference import drive, plain
from port_bench.reference import scene as ref_scene


def program_calls() -> dict:
    """The program's functions a frame calls, by name."""
    from pathtracer_tpu_torch.render.integrator import render

    return {"render": render}


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int, device, program=None):
        tr = workload["traffic"]
        self.w, self.h, self.spp = int(tr["width"]), int(tr["height"]), int(tr["spp_per_frame"])
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        self.settings = cellkit.render_settings(workload, config)
        self.calls = program or program_calls()
        self.key = cellkit.key_of(seed)
        self.rays, self.frame0, self.accum, self.frame = [], None, None, 0
        self.trace_data = None

    def setup(self):
        from pathtracer_tpu_torch.config import RenderConfig
        from pathtracer_tpu_torch.scene.parser import parse_scene_text

        desc = parse_scene_text(cellkit.scene_text(self.config), name=self.config["name"])
        desc = dataclasses.replace(desc, resolution=(self.w, self.h))
        self.scene = desc.scene_for_frame(0, device=self.device)
        self.cfg = RenderConfig(**self.settings)
        # the preview's staging buffer in page-locked host memory, reused by every frame
        self.host = torch.empty((self.h, self.w, 3), dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
        img, _, _ = self._frame(None, 0)  # the warm-up frame: every shape the window uses
        self.host.copy_(cellkit.to8(img))

    def _frame(self, accum, start: int):
        img, accum, stats = self.calls["render"](self.scene, self.spp, self.cfg,
                                                 base_key=self.key, accum=accum,
                                                 start_iteration=start, device=self.device)
        return img, accum, stats["rays_traced"]

    def unit(self, span) -> int:
        with span("render"):
            img, self.accum, rays = self._frame(self.accum, self.frame * self.spp)
        with span("readout"):
            self.host.copy_(cellkit.to8(img))
        self.rays.append(rays)
        if self.frame == 0:
            self.frame0 = self.host.clone()
        self.frame += 1
        return self.w * self.h * self.spp

    def trace_context(self, n_units: int) -> dict:
        return cellkit.trace_context(self.config, self.settings, self.w, self.h, n_units * self.spp,
                                     sum(self.rays[-n_units:]))

    def outputs(self) -> dict:
        """What the window produced, on the host: the frame count, frame 0's
        image and rays, and at the sampled pixels the accumulator and the
        last frame's image."""
        pix = cellkit.sample_pixels(self.seed, self.w * self.h,
                                    int(self.workload["check"]["pixels"]))
        return dict(frames=self.frame, frame0=self.frame0.reshape(-1, 3), rays0=int(self.rays[0]),
                    accum=self.accum.index_select(0, pix.to(self.device)).cpu(),
                    last=self.host.reshape(-1, 3)[pix], pix=pix)

    def release(self):
        self.scene = self.accum = self.host = None


def reference_outputs(workload: dict, config: dict, seed: int, device, dt=torch.float32,
                      frames: int = 1) -> dict:
    """The plain reference's :meth:`Cell.outputs` of a window of ``frames``
    frames, computed in ``dt`` (float32: the reference; lower: the control)."""
    tr = workload["traffic"]
    w, h, spp = int(tr["width"]), int(tr["height"]), int(tr["spp_per_frame"])
    sc = ref_scene.parse(cellkit.scene_text(config), (w, h))
    lv = ref_scene.leaves(sc, device)
    rcfg = cellkit.render_settings(workload, config)
    key = cellkit.key_of(seed)
    acc0, rays0 = drive.render_pixels(sc, lv, torch.arange(w * h, device=device), range(spp), key,
                                      rcfg, dt)
    frame0 = cellkit.to8(plain.tonemap(acc0.float(), spp)).cpu()
    del acc0
    pix = cellkit.sample_pixels(seed, w * h, int(workload["check"]["pixels"]))
    acc, _ = drive.render_pixels(sc, lv, pix.to(device), range(frames * spp), key, rcfg, dt)
    last = cellkit.to8(plain.tonemap(acc.float(), frames * spp)).cpu()
    return dict(frames=frames, frame0=frame0, rays0=rays0, accum=acc.float().cpu(), last=last,
                pix=pix)


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: shares of pixels whose 8-bit values differ, the
    ray count's relative gap, the accumulator's widest gap."""
    return {
        "frame0_pixels_differing": cellkit.share_differing(got["frame0"], ref["frame0"]),
        "frame0_rays_gap": cellkit.rel_gap(got["rays0"], ref["rays0"]),
        "accum_gap": cellkit.max_gap(got["accum"], ref["accum"]),
        "last_pixels_differing": cellkit.share_differing(got["last"], ref["last"]),
    }


def check(workload: dict, config: dict, seed: int, got: dict, device) -> dict:
    ref = reference_outputs(workload, config, seed, device, frames=got["frames"])
    return cellkit.checks(compare(got, ref), workload["check"]["limits"])
