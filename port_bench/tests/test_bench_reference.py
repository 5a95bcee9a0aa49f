"""The plain reference agrees with the program's CPU path (its plain
versions) on tiny renders and a tiny gradient of both configurations."""

import dataclasses

import pytest
import torch

from port_bench.harness import cellkit, core
from port_bench.reference import drive
from port_bench.reference import scene as ref_scene

W, H = 20, 12
KEY = (7, 2_147_483_901)


def scene_pair(name):
    from pathtracer_tpu_torch.scene.parser import parse_scene_text

    _, cfg = core.load_cell(f"{name}.render")
    text = cellkit.scene_text(cfg)
    desc = dataclasses.replace(parse_scene_text(text), resolution=(W, H))
    return cfg, desc, ref_scene.parse(text, (W, H))


@pytest.mark.parametrize("name", ["cornell", "milky"])
def test_render_is_bit_equal_to_the_programs_cpu_path(name):
    from pathtracer_tpu_torch import RenderConfig, render

    cfg, desc, sc = scene_pair(name)
    _, acc, stats = render(desc.scene_for_frame(0, device="cpu"), 3,
                           RenderConfig(**cfg["render"]), base_key=KEY, device="cpu")
    ref, rays = drive.render_pixels(sc, ref_scene.leaves(sc, "cpu"), torch.arange(W * H),
                                    range(3), KEY, cfg["render"])
    assert torch.equal(acc, ref) and stats["rays_traced"] == rays


@pytest.mark.parametrize("name", ["cornell", "milky"])
def test_gradient_agrees_with_the_programs_cpu_path(name):
    """The program's CPU engine differentiates in double at the float
    values; the reference is float32 autograd: agreement to 1e-6 in the
    loss and 1e-3 of the median leaf in each leaf's norm."""
    from pathtracer_tpu_torch import RenderConfig
    from pathtracer_tpu_torch.render.diff import loss_and_grad_rays, params_from_description

    cfg, desc, sc = scene_pair(name)
    params, static = params_from_description(desc, 0, device="cpu")
    target = torch.rand((W * H, 3), generator=torch.Generator().manual_seed(3))
    loss, grads, _ = loss_and_grad_rays(params, static, target, 2, KEY,
                                        RenderConfig(**cfg["render"]), device="cpu")
    r_loss, r_grads = drive.loss_and_grad(sc, ref_scene.leaves(sc, "cpu"), target, 2, KEY,
                                          cfg["render"], lanes=128)
    assert float(loss) == pytest.approx(r_loss, rel=1e-6)
    got = {k: float(v.double().norm()) for k, v in grads.leaves().items()}
    want = {k: float(v.double().norm()) for k, v in r_grads.items()}
    assert set(got) == set(want)
    median = sorted(v for v in want.values() if v > 0)[len([v for v in want.values() if v > 0]) // 2]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 * max(want[k], median), k
