"""Inverse rendering: one unit is one gradient step of ``spp`` samples per
pixel on the full image, and an Adam step on every non-emissive
material's colour.

Set-up parses the scene at the cell's resolution, renders the target from
the true parameters with a target key (``render/diff.render_linear``),
perturbs the colours it fits by draws from the seed, and runs the first
``checked_steps`` steps through the window's own step, each with a fresh
key: those are the warm-up, and the steps the check follows.  The window
continues the same optimizer from there.  A step calls the program's
``render/diff.loss_and_grad_rays`` (on the card the full-depth engine:
kernels 4 and 5) and reads the loss and the ray count on the host.

The check, after the window: the plain reference (``reference/``) renders
the target again, and runs the same steps from the same start with
``torch.autograd`` through the plain path tracer and ``torch.optim.Adam``;
compared are the target, each step's loss, the first step's gradient of
every leaf (materials, transforms, camera) and the first gradient as the
optimizer holds it, and the fitted colours' change over the steps, each as
the gap of the worst leaf.
"""

from __future__ import annotations

import dataclasses

import torch

from port_bench.harness import cellkit
from port_bench.reference import drive
from port_bench.reference import scene as ref_scene

ADAM_BETA1 = 0.9


def program_calls() -> dict:
    from pathtracer_tpu_torch.render.diff import loss_and_grad_rays, render_linear

    return {"loss_and_grad_rays": loss_and_grad_rays, "render_linear": render_linear}


def fitted_materials(config: dict) -> list:
    """The materials whose colour the steps fit: every non-emissive one."""
    sc = ref_scene.parse(cellkit.scene_text(config), (2, 2))
    return [i for i, e in enumerate(sc["materials"]["emittance"]) if e <= 0.0]


def start_colours(config: dict, seed: int, perturb: float):
    """The fitted colours' start: the true ones moved by uniform draws in
    ``[-perturb, perturb]`` from the seed, held in [0.02, 0.98]."""
    sc = ref_scene.parse(cellkit.scene_text(config), (2, 2))
    true = torch.as_tensor(sc["materials"]["color"])[fitted_materials(config)]
    g = torch.Generator().manual_seed((seed ^ 0xC0102) & 0x7FFFFFFFFFFFFFFF)
    return (true + (torch.rand(true.shape, generator=g) * 2 - 1) * perturb).clamp(0.02, 0.98)


def leaf_norms(named: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in named.items()}


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int, device, program=None):
        tr = workload["traffic"]
        self.tr = tr
        self.w, self.h, self.spp = int(tr["width"]), int(tr["height"]), int(tr["spp"])
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        self.settings = cellkit.render_settings(workload, config)
        self.calls = program or program_calls()
        self.step_no, self.rays = 0, []
        self.trace_data = None
        self.record = {}

    def setup(self):
        from pathtracer_tpu_torch.config import RenderConfig
        from pathtracer_tpu_torch.render.diff import params_from_description
        from pathtracer_tpu_torch.scene.parser import parse_scene_text

        desc = parse_scene_text(cellkit.scene_text(self.config), name=self.config["name"])
        desc = dataclasses.replace(desc, resolution=(self.w, self.h))
        self.params, self.static = params_from_description(desc, 0, device=self.device)
        self.cfg = RenderConfig(**self.settings)
        with torch.no_grad():
            self.target = self.calls["render_linear"](self.params, self.static,
                                                      int(self.tr["target_spp"]),
                                                      cellkit.key_of(self.seed, 1), self.cfg)
        self.fitted = fitted_materials(self.config)
        start = start_colours(self.config, self.seed, float(self.tr["perturb"]))
        self.colours = [c.to(self.device).requires_grad_(True) for c in start]
        self.opt = torch.optim.Adam(self.colours, lr=float(self.tr["lr"]))
        rec = self.record
        rec["start"] = [c.detach().cpu().clone() for c in self.colours]
        rec["losses"] = []
        for s in range(int(self.tr["checked_steps"])):
            loss, grads = self._step()
            rec["losses"].append(loss)
            if s == 0:
                rec["grad_norms"] = leaf_norms(grads.leaves())
                rec["adam_norms"] = [float((self.opt.state[c]["exp_avg"] / (1 - ADAM_BETA1))
                                           .double().norm()) for c in self.colours]
        rec["end"] = [c.detach().cpu().clone() for c in self.colours]
        rec["target"] = self.target.cpu()

    def _step(self):
        color = self.params.materials.color.detach().clone()
        color[self.fitted] = torch.stack([c.detach() for c in self.colours])
        params = dataclasses.replace(
            self.params, materials=dataclasses.replace(self.params.materials, color=color))
        loss, grads, rays = self.calls["loss_and_grad_rays"](
            params, self.static, self.target, self.spp, cellkit.key_of(self.seed, 2 + self.step_no),
            self.cfg, device=self.device)
        for c, i in zip(self.colours, self.fitted):
            c.grad = grads.materials.color[i].clone()
        self.opt.step()
        with torch.no_grad():
            for c in self.colours:
                c.clamp_(0.0, 1.0)
        self.step_no += 1
        self.rays.append(int(rays))
        return float(loss), grads

    def unit(self, span) -> int:
        with span("step"):
            self._step()
        return self.w * self.h * self.spp

    def trace_context(self, n_units: int) -> dict:
        return cellkit.trace_context(self.config, self.settings, self.w, self.h, n_units * self.spp,
                                     sum(self.rays[-n_units:]))

    def outputs(self) -> dict:
        return dict(self.record)

    def release(self):
        self.params = self.target = self.opt = self.colours = None


def reference_outputs(workload: dict, config: dict, seed: int, device, dt=torch.float32,
                      frames=None) -> dict:
    """The plain reference's record of the checked steps (:meth:`Cell.setup`'s
    ``record``), the trace computed in ``dt`` (float32: the reference;
    lower: the control)."""
    tr = workload["traffic"]
    w, h, spp = int(tr["width"]), int(tr["height"]), int(tr["spp"])
    sc = ref_scene.parse(cellkit.scene_text(config), (w, h))
    rcfg = cellkit.render_settings(workload, config)
    lv = ref_scene.leaves(sc, device)
    with torch.no_grad():
        target = drive.render_pixels(sc, lv, torch.arange(w * h, device=device),
                                     range(int(tr["target_spp"])), cellkit.key_of(seed, 1), rcfg,
                                     dt)[0].float() / int(tr["target_spp"])
    fitted = fitted_materials(config)
    colours = [c.to(device).requires_grad_(True)
               for c in start_colours(config, seed, float(tr["perturb"]))]
    opt = torch.optim.Adam(colours, lr=float(tr["lr"]))
    rec = {"start": [c.detach().cpu().clone() for c in colours], "losses": []}
    for s in range(int(tr["checked_steps"])):
        color = lv["materials.color"].detach().clone()
        color[fitted] = torch.stack([c.detach() for c in colours])
        live = dict(lv, **{"materials.color": color})
        loss, grads = drive.loss_and_grad(sc, live, target, spp, cellkit.key_of(seed, 2 + s), rcfg,
                                          dt)
        for c, i in zip(colours, fitted):
            c.grad = grads["materials.color"][i].clone()
        opt.step()
        with torch.no_grad():
            for c in colours:
                c.clamp_(0.0, 1.0)
        rec["losses"].append(loss)
        if s == 0:
            rec["grad_norms"] = leaf_norms(grads)
            rec["adam_norms"] = [float((opt.state[c]["exp_avg"] / (1 - ADAM_BETA1)).double().norm())
                                 for c in colours]
    rec["end"] = [c.detach().cpu().clone() for c in colours]
    rec["target"] = target.cpu()
    return rec


def leaf_gaps(got: dict, ref: dict, floor_share: float) -> dict:
    """Per leaf the gap between the two sides' norms, over the larger of the
    reference's norm of that leaf and of the median leaf (of those the
    reference moves).  Leaves whose reference norm is under
    ``floor_share`` of the median leaf's move by round-off alone and are
    left out."""
    nonzero = sorted(v for v in ref.values() if v > 0)
    if not nonzero:
        return {k: (0.0 if got[k] == 0 else 1e300) for k in ref}
    median = nonzero[len(nonzero) // 2]
    return {k: abs(got[k] - r) / max(r, median) for k, r in ref.items()
            if r >= floor_share * median}


def worst_leaf(got: dict, ref: dict, floor_share: float) -> float:
    return max(leaf_gaps(got, ref, floor_share).values())


def compare(got: dict, ref: dict) -> dict:
    change_got = {str(i): float((e - s).double().norm())
                  for i, (s, e) in enumerate(zip(got["start"], got["end"]))}
    change_ref = {str(i): float((e - s).double().norm())
                  for i, (s, e) in enumerate(zip(ref["start"], ref["end"]))}
    return {
        "target_gap": cellkit.max_gap(got["target"], ref["target"]),
        "loss_gap": max(cellkit.rel_gap(a, b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": worst_leaf(got["grad_norms"], ref["grad_norms"], 1e-3),
        "adam_grad_gap": worst_leaf(dict(enumerate(got["adam_norms"])),
                                    dict(enumerate(ref["adam_norms"])), 1e-3),
        "change_gap": worst_leaf(change_got, change_ref, 1e-3),
    }


def check(workload: dict, config: dict, seed: int, got: dict, device) -> dict:
    import sys

    ref = reference_outputs(workload, config, seed, device)
    for k, v in sorted(leaf_gaps(got["grad_norms"], ref["grad_norms"], 1e-3).items()):
        print(f"leaf {k} gap {v!r} program {got['grad_norms'][k]!r} "
              f"reference {ref['grad_norms'][k]!r}", file=sys.stderr)
    return cellkit.checks(compare(got, ref), workload["check"]["limits"])
