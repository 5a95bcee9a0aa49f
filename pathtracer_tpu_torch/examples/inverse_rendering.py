"""Inverse rendering: recover a wall colour from a target image.

Port of ``examples/inverse_rendering.py``.  Renders a ground-truth Cornell
box, perturbs the red left wall's albedo, and recovers it with
``torch.optim.Adam`` on the L2 loss of the linear image, the gradients
coming from ``render/diff.loss_and_grad`` (on the card: the forward and
reverse trace kernels once each per progressive iteration).

    python -m pathtracer_tpu_torch.examples.inverse_rendering
    python -m pathtracer_tpu_torch.examples.inverse_rendering --device cpu --res 24

The last line printed is a JSON summary: the first and last losses and the
wall's colour error before and after.  Every step uses the target's seed:
the counter-hash RNG makes the estimator a deterministic function of the
parameters, with an exact zero at the true ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render.diff import loss_and_grad, params_from_description, render_linear
from pathtracer_tpu_torch.scene.parser import load_scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WALL_MATERIAL = 1  # the red left wall of scenes/cornell.txt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=os.path.join(ROOT, "scenes", "cornell.txt"))
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    desc = dataclasses.replace(load_scene(args.scene), resolution=(args.res, args.res))
    params_true, static = params_from_description(desc, 0, device=args.device)
    cfg = RenderConfig(wavefront=False, nee=True, max_depth=args.depth)
    key = prng_key(0)
    with torch.no_grad():
        target = render_linear(params_true, static, args.spp, key, cfg)
    true_color = params_true.materials.color[WALL_MATERIAL].clone()
    print(f"true wall albedo:      {true_color.tolist()}")

    wall = torch.tensor([0.2, 0.5, 0.7], device=params_true.device, requires_grad=True)
    err_start = float((wall.detach() - true_color).abs().max())
    print(f"perturbed wall albedo: {wall.tolist()}")
    opt = torch.optim.Adam([wall], lr=args.lr)
    losses = []
    for step in range(args.steps):
        color = params_true.materials.color.clone()
        color[WALL_MATERIAL] = wall.detach()
        params = dataclasses.replace(
            params_true, materials=dataclasses.replace(params_true.materials, color=color)
        )
        loss, grads = loss_and_grad(params, static, target, args.spp, key, cfg, device=args.device)
        # optimize the wall colour only
        wall.grad = grads.materials.color[WALL_MATERIAL].clone()
        opt.step()
        with torch.no_grad():
            wall.clamp_(0.0, 1.0)
        losses.append(float(loss))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {losses[-1]:.6f}  wall "
                  f"{[round(float(c), 3) for c in wall.detach()]}")

    err_end = float((wall.detach() - true_color).abs().max())
    print(f"recovered wall albedo: {wall.detach().tolist()}  (max abs err {err_end:.3f})")
    summary = dict(loss_first=losses[0], loss_last=losses[-1], err_start=err_start,
                   err_end=err_end, steps=args.steps, device=str(params_true.device))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
