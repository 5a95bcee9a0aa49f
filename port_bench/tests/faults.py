"""Faults planted in the timed path, for the tests and for the readings
that limits are set from (``calibrate.py --faults``).

Each builder returns the ``program`` mapping a cell's entry calls in place
of the program's functions: the program's own call, broken where its result
is produced.  ``unchanged``: a step that returns its state as it was given;
``half``: half of the batch left out (for a gradient step, the mean taken
over the other half); ``altered``: an answer changed where it is produced
(a frame's new radiance scaled by 1.01; a step's colour gradient doubled,
as a leaf moved double); ``object`` (renders): one object's shading off,
the blue sphere's colour (material 6 in both scenes) scaled by 0.99 in the
scene the program renders."""

import dataclasses

import torch

OBJECT_MATERIAL = 6


def render_fault(kind):
    from pathtracer_tpu_torch.render.integrator import render
    from pathtracer_tpu_torch.ops.tonemap import tonemap

    def broken(scene, spp, cfg, base_key=None, accum=None, start_iteration=0, device="cuda"):
        n = scene.camera.width * scene.camera.height
        before = torch.zeros((n, 3), device=scene.device) if accum is None else accum
        if kind == "object":
            color = scene.materials.color.clone()
            color[OBJECT_MATERIAL] *= 0.99
            scene = dataclasses.replace(
                scene, materials=dataclasses.replace(scene.materials, color=color))
        img, after, stats = render(scene, spp, cfg, base_key=base_key, accum=accum,
                                   start_iteration=start_iteration, device=device)
        if kind == "unchanged":
            after = before.clone()
        elif kind == "half":
            after = after.clone()
            after[1::2] = before[1::2]
        elif kind == "altered":
            after = before + (after - before) * 1.01
        img = tonemap(after.reshape(scene.camera.height, scene.camera.width, 3),
                      start_iteration + spp)
        return img, after, stats

    return {"render": broken}


def grad_fault(kind):
    from pathtracer_tpu_torch.render import diff

    def broken(params, static, target, spp, base_key, cfg, device="cuda"):
        if kind == "half":
            half = torch.arange(0, target.shape[0], 2, device=target.device)
            return diff._value_and_grad(params, lambda p: diff.l2_loss_rays(
                p, static, target[half], spp, base_key, cfg, pixel_index=half,
                n_global_pixels=target.shape[0]))
        loss, grads, rays = diff.loss_and_grad_rays(params, static, target, spp, base_key, cfg,
                                                    device=device)
        leaves = grads.leaves()
        if kind == "unchanged":
            leaves = {k: torch.zeros_like(v) for k, v in leaves.items()}
        elif kind == "altered":
            leaves["materials.color"] = leaves["materials.color"] * 2.0
        return loss, diff.SceneParams.from_leaves(leaves), rays

    return {"loss_and_grad_rays": broken, "render_linear": diff.render_linear}
