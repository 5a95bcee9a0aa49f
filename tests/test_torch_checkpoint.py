"""Checkpoints: the port's ``utils/checkpoint.py`` against the JAX package's.

The two packages write the same ``.npz`` (``accum`` float32 ``[N, 3]``,
``spp_done`` / ``frame`` / ``seed`` int64), so a checkpoint of either
loads in the other with equal contents and dtypes.  A resume in the port is
bit-exact: 8 spp, a checkpoint, and a resume to 16 give the straight
16-spp accumulator on the megakernel and the pinned engine (both add each
chunk's radiance to the accumulator in the same order, chunks of 8).  A
JAX checkpoint resumed in the port meets JAX's straight render within the
golden bars of ``tests/test_torch_render.py`` (95% of entries within 1e-5
relative, the sum within 2e-5): the port's iterations 8-15 differ from
JAX's in the last ulp, as every render does.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.render.integrator import render as jax_render
from pathtracer_tpu.utils import checkpoint as jax_ckpt
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
RES = (32, 32)
DTYPES = {"accum": np.float32, "spp_done": np.int64, "frame": np.int64, "seed": np.int64}


def _raw(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _accum(seed=3):
    return np.random.default_rng(seed).random((RES[0] * RES[1], 3), dtype=np.float32) * 4.0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A file either package writes loads in both with equal contents; the
    raw ``.npz`` holds the four keys at their dtypes; no temporary file is
    left."""
    acc = _accum()
    path = str(tmp_path / "sub" / "state.npz")
    if writer == "jax":
        jax_ckpt.save(path, jnp.asarray(acc), 24, 3, 7)
    else:
        ckpt.save(path, torch.from_numpy(acc), 24, 3, 7)
    assert os.listdir(tmp_path / "sub") == ["state.npz"]
    raw = _raw(path)
    assert sorted(raw) == sorted(DTYPES)
    for k, dt in DTYPES.items():
        assert raw[k].dtype == dt, k
    assert raw["accum"].shape == acc.shape
    for reader in (ckpt.load, jax_ckpt.load):
        state = reader(path)
        np.testing.assert_array_equal(state["accum"], acc)
        assert state["accum"].dtype == np.float32
        assert (state["spp_done"], state["frame"], state["seed"]) == (24, 3, 7)


def test_checkpoint_files_equal_and_missing(tmp_path):
    """Both packages' files hold the same arrays; a missing file loads as
    None in both; a second save replaces the first."""
    acc = _accum(5)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    jax_ckpt.save(a, jnp.asarray(acc), 8, 0, 0)
    ckpt.save(b, torch.from_numpy(acc), 8, 0, 0)
    ra, rb = _raw(a), _raw(b)
    for k in DTYPES:
        np.testing.assert_array_equal(ra[k], rb[k])
        assert ra[k].dtype == rb[k].dtype
    assert ckpt.load(str(tmp_path / "none.npz")) is None
    assert jax_ckpt.load(str(tmp_path / "none.npz")) is None
    ckpt.save(b, torch.from_numpy(acc * 2), 16, 0, 0)
    state = ckpt.load(b)
    assert state["spp_done"] == 16 and np.array_equal(state["accum"], acc * 2)
    assert sorted(os.listdir(tmp_path)) == ["a.npz", "b.npz"]


def _port_scene():
    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=RES)
    return desc.scene_for_frame(0, device="cpu")


@pytest.mark.parametrize("engine", [dict(), dict(wavefront=True)], ids=["megakernel", "pinned"])
def test_resume_is_bit_exact(tmp_path, engine):
    """8 spp with a checkpoint written from ``progress_fn``, a resume from
    the loaded file to 16: the straight 16-spp accumulator, bit for bit."""
    scene = _port_scene()
    cfg = RenderConfig(max_depth=5, nee=True, iters_per_launch=8, **engine)
    path = str(tmp_path / "ck.npz")

    def progress(done, acc):
        ckpt.save(path, acc, done, 0, cfg.seed)

    _, _, first = render(scene, 8, cfg, progress_fn=progress, device="cpu")
    state = ckpt.load(path)
    assert state["spp_done"] == 8 and state["frame"] == 0
    _, resumed, st = render(scene, 8, cfg, accum=torch.from_numpy(state["accum"]),
                            start_iteration=state["spp_done"], device="cpu")
    _, straight, st16 = render(scene, 16, cfg, device="cpu")
    assert torch.equal(resumed, straight)
    assert first["rays_traced"] + st["rays_traced"] == st16["rays_traced"]


def test_jax_checkpoint_resumes_in_the_port(tmp_path, cornell_scene):
    """Cornell at 32x32, depth 5, NEE: JAX renders 8 spp and writes its
    checkpoint; the port loads it and renders iterations 8-15; the result
    meets JAX's straight 16-spp accumulator at the golden bars."""
    jscene = dataclasses.replace(
        cornell_scene, camera=dataclasses.replace(cornell_scene.camera, resolution=RES))
    jcfg = JaxConfig(max_depth=5, nee=True, iters_per_launch=8)
    path = str(tmp_path / "jax.npz")
    jax_render(jscene, 8, jcfg,
               progress_fn=lambda done, acc: jax_ckpt.save(path, acc, done, 0, jcfg.seed))
    _, want, _ = jax_render(jscene, 16, jcfg)
    want = np.asarray(want)

    state = ckpt.load(path)
    assert state["spp_done"] == 8
    cfg = RenderConfig(max_depth=5, nee=True, iters_per_launch=8, seed=state["seed"])
    _, got, _ = render(port_scene_from_jax(jscene), 16 - state["spp_done"], cfg,
                       accum=torch.from_numpy(state["accum"]),
                       start_iteration=state["spp_done"], device="cpu")
    got = got.numpy()
    frac = (np.abs(got - want) <= 1e-5 * (np.abs(want) + 1e-3)).mean()
    sum_rel = abs(float(got.sum()) - float(want.sum())) / abs(float(want.sum()))
    print(f"JAX checkpoint resumed in the port: {frac:.5f} of entries within 1e-5, "
          f"sum rel {sum_rel:.3g}")
    assert frac >= 0.95 and sum_rel <= 2e-5
