"""The interactive camera REPL of the port against the JAX package's.

Port of ``tests/test_interactive.py`` (the rig's moves, a scripted session,
``refine`` equal to one render of as many spp) on the CPU at 32x32, depth
2; and the rig against JAX's: after the same commands the port's
``CameraRig`` (numpy float64, as JAX's) holds JAX's state within 1e-12, and
its ``camera`` the same float32 values.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from pathtracer_tpu.render import interactive as jax_interactive
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render import interactive
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.render.interactive import CameraRig, interactive_loop
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils.imageio import load_png

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = RenderConfig(max_depth=2, wavefront=False, iters_per_launch=2)
SCRIPT = "w w a j i + d l k q e s - + + j"


@pytest.fixture(scope="module")
def desc():
    return dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=(32, 32))


def test_rig_moves(desc):
    rig = CameraRig(desc.scene_for_frame(0, device="cpu").camera)
    p0 = rig.position.copy()
    v0 = rig.view.copy()
    assert rig.position.dtype == np.float64
    assert rig.apply("w")
    assert np.linalg.norm(rig.position - p0) > 0  # dollied forward
    rig.apply("s")  # w then s returns to the start
    np.testing.assert_allclose(rig.position, p0, atol=1e-9)
    rig.apply("j")  # yaw turns the view but keeps its length
    assert np.linalg.norm(rig.view - v0) > 1e-3
    np.testing.assert_allclose(np.linalg.norm(rig.view), np.linalg.norm(v0), rtol=1e-12)
    for _ in range(100):  # zoom clamps
        rig.apply("+")
    assert rig.fov.min() >= 5.0
    rig.reset()
    np.testing.assert_allclose(rig.position, p0)
    assert not rig.apply("z")  # unknown key


def test_rig_matches_jax(desc, cornell_scene):
    """The same commands move both rigs alike; the port's camera holds the
    state as float32 tensors on the base camera's device, as JAX's holds
    float32 arrays."""
    port = CameraRig(desc.scene_for_frame(0, device="cpu").camera)
    jax_rig = jax_interactive.CameraRig(cornell_scene.camera)
    for cmd in SCRIPT.split():
        assert port.apply(cmd) == jax_rig.apply(cmd)
        for k in ("position", "view", "up", "fov"):
            np.testing.assert_allclose(getattr(port, k), getattr(jax_rig, k), rtol=0,
                                       atol=1e-12, err_msg=f"{k} after {cmd}")
    assert port.describe() == jax_rig.describe()
    base = desc.scene_for_frame(0, device="cpu").camera
    cam, jcam = port.camera(base), jax_rig.camera(cornell_scene.camera)
    for k in ("position", "view", "up", "fov"):
        got = getattr(cam, k)
        assert got.dtype == torch.float32 and got.device == base.position.device
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jcam, k)), k)
    assert cam.resolution == base.resolution and cam.aperture is base.aperture
    assert interactive.HELP == jax_interactive.HELP
    assert interactive._COMMANDS == jax_interactive._COMMANDS
    assert interactive._input_pending(io.StringIO("w\n"), 0.0)  # unselectable: pending


def test_scripted_session(desc, tmp_path):
    """A scripted stdin session renders previews and a full save."""
    out = str(tmp_path / "it.png")
    stdin = io.StringIO("w j stat\nspp=2\nd\nhelp\nbogus\nsave\nquit\n")
    stdout = io.StringIO()
    n = interactive_loop(desc, 0, CFG, preview_spp=2, out_path=out, full_spp=2,
                         stdin=stdin, stdout=stdout, device="cpu")
    log = stdout.getvalue()
    assert n == 5  # initial + w + j + d previews + the full save
    assert os.path.exists(out)
    assert os.path.exists(out.replace(".png", ".full.png"))
    assert "eye=" in log and "preview spp = 2" in log and "Commands" in log
    assert "? unknown command 'bogus'" in log


def test_progressive_refine_matches_single_render(desc, tmp_path):
    """``refine 3``: 2 spp initially and 3 x 2 more; the preview's
    accumulator equals one fresh 8-spp render bit for bit, and its PNG that
    render's."""
    out = str(tmp_path / "prog.png")
    stdout = io.StringIO()
    state = {}
    n = interactive_loop(desc, 0, CFG, preview_spp=2, out_path=out, full_spp=64,
                         stdin=io.StringIO("refine 3\nquit\n"), stdout=stdout,
                         device="cpu", state=state)
    assert n == 4  # initial preview + 3 refines
    assert "refined to 8 spp" in stdout.getvalue()
    assert state["spp"] == 8
    img, accum, _ = render(desc.scene_for_frame(0, device="cpu"), 8, CFG,
                           base_key=prng_key(CFG.seed), device="cpu")
    assert torch.equal(state["accum"], accum)
    want = np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8)  # as save_image
    np.testing.assert_array_equal(load_png(out), want)


def test_moved_preview_renders_the_rig_camera(desc, tmp_path):
    """After ``w j`` and ``refine 1`` the preview is a fresh 4-spp render of
    the rig's camera, and ``save`` writes that camera's full render."""
    out = str(tmp_path / "m.png")
    state = {}
    interactive_loop(desc, 0, CFG, preview_spp=2, out_path=out, full_spp=4,
                     stdin=io.StringIO("w j refine 1 save quit\n"), stdout=io.StringIO(),
                     device="cpu", state=state)
    scene = desc.scene_for_frame(0, device="cpu")
    moved = dataclasses.replace(scene, camera=state["rig"].camera(scene.camera))
    img, accum, _ = render(moved, 4, CFG, device="cpu")
    assert state["spp"] == 4 and torch.equal(state["accum"], accum)
    want = np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8)  # as save_image
    np.testing.assert_array_equal(load_png(out.replace(".png", ".full.png")), want)
