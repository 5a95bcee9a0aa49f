"""Progressive preview render of a scene with triangle meshes: ``render``'s
closed loop, with the scene's mesh files read from its own directory.

A frame is ``entries/render.py``'s: the program's ``render/integrator.
render`` at the cell's resolution with the accumulator and
``start_iteration`` carried forward, the tone-mapped image made 8-bit on the
device and copied into the page-locked host buffer every frame reuses.
Set-up parses the scene with ``scene_dir`` set to the directory of the
configuration's ``scene_file``, so that its ``.obj`` files load, and renders
the warm-up frame, which builds the scene's in-kernel triangle tables once.

The check compares ``render``'s four numbers against the plain mesh
reference (``reference/mesh.py``).  It also prints, to standard error, the
program's counters over the window: the triangle-table builds
(``ops.mesh_tables.builds``, 0 when the tables stay built) and the mesh
trace kernel's launches (``ops.trace.mesh_launches``, one an iteration on
the card); a program without such a counter prints None.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from port_bench.entries import render
from port_bench.harness import cellkit
from port_bench.harness.core import ROOT
from port_bench.reference import mesh as ref_mesh
from port_bench.reference import plain
from port_bench.reference import scene as ref_scene

compare = render.compare
# the program's counters the check reports: (module, attribute)
COUNTERS = (("pathtracer_tpu_torch.ops.mesh_tables", "builds"),
            ("pathtracer_tpu_torch.ops.mesh_tables", "triangles"),
            ("pathtracer_tpu_torch.ops.trace", "mesh_launches"))


def scene_dir(config: dict) -> str:
    """The directory the configuration's scene file lies in: its mesh files
    are named relative to it."""
    return os.path.join(ROOT, os.path.dirname(config["scene_file"]))


def parse_reference(config: dict, w: int, h: int) -> dict:
    return ref_mesh.parse(cellkit.scene_text(config), (w, h), scene_dir(config))


def read_counters() -> dict:
    out = {}
    for mod, attr in COUNTERS:
        m = sys.modules.get(mod)
        out[f"{mod.split('.', 1)[1]}.{attr}"] = getattr(m, attr, None) if m else None
    return out


class Cell(render.Cell):
    def setup(self):
        from pathtracer_tpu_torch.config import RenderConfig
        from pathtracer_tpu_torch.scene.parser import parse_scene_text

        desc = parse_scene_text(cellkit.scene_text(self.config), name=self.config["name"],
                                scene_dir=scene_dir(self.config))
        desc = dataclasses.replace(desc, resolution=(self.w, self.h))
        self.scene = desc.scene_for_frame(0, device=self.device)
        self.cfg = RenderConfig(**self.settings)
        self.host = torch.empty((self.h, self.w, 3), dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
        img, _, _ = self._frame(None, 0)  # the warm-up frame: every shape the window uses
        self.host.copy_(cellkit.to8(img))
        sc = parse_reference(self.config, self.w, self.h)
        self.context = dict(geom_types=sc["types"], n_materials=len(sc["materials"]["emittance"]),
                            nee=self.settings["nee"], vol=False, depth=self.settings["max_depth"],
                            mesh_tris=[(int(m["verts"].shape[0]), m["norm"] is not None)
                                       for m in sc["meshes"]])
        self.counters0 = read_counters()

    def trace_context(self, n_units: int) -> dict:
        return dict(self.context, spp=n_units * self.spp, pixels=self.w * self.h,
                    rays=sum(self.rays[-n_units:]))

    def outputs(self) -> dict:
        after = read_counters()
        window = {k: (None if v is None or self.counters0[k] is None else v - self.counters0[k])
                  for k, v in after.items()}
        return dict(super().outputs(), counters=window)


def reference_outputs(workload: dict, config: dict, seed: int, device, dt=torch.float32,
                      frames: int = 1) -> dict:
    """``render.reference_outputs`` with the mesh reference."""
    tr = workload["traffic"]
    w, h, spp = int(tr["width"]), int(tr["height"]), int(tr["spp_per_frame"])
    sc = parse_reference(config, w, h)
    lv = ref_scene.leaves(sc, device)
    rcfg = cellkit.render_settings(workload, config)
    key = cellkit.key_of(seed)
    acc0, rays0 = ref_mesh.render_pixels(sc, lv, torch.arange(w * h, device=device), range(spp),
                                         key, rcfg, dt)
    frame0 = cellkit.to8(plain.tonemap(acc0.float(), spp)).cpu()
    del acc0
    pix = cellkit.sample_pixels(seed, w * h, int(workload["check"]["pixels"]))
    acc, _ = ref_mesh.render_pixels(sc, lv, pix.to(device), range(frames * spp), key, rcfg, dt)
    last = cellkit.to8(plain.tonemap(acc.float(), frames * spp)).cpu()
    return dict(frames=frames, frame0=frame0, rays0=rays0, accum=acc.float().cpu(), last=last,
                pix=pix)


def check(workload: dict, config: dict, seed: int, got: dict, device) -> dict:
    frames = got["frames"]
    for name, v in got.get("counters", {}).items():
        print(f"counter {name} {v!r} over the window's {frames} frames", file=sys.stderr)
    ref = reference_outputs(workload, config, seed, device, frames=frames)
    return cellkit.checks(compare(got, ref), workload["check"]["limits"])
