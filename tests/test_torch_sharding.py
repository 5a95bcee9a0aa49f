"""The port's multi-shard render on the CPU: ``tests/test_sharding.py`` for
``pathtracer_tpu_torch/parallel``.

Eight shards on one repeated CPU device stand in for JAX's 8 virtual CPU
devices (``tests/conftest.py:14-16``).  Bars:

* the sharded pinned render against the port's single-device pinned
  render: the accumulator bit for bit and the int64 ray counts equal
  (each pixel sums its samples in iteration order on both);
* the queue engine: within 1e-6 (its ``index_add_`` flush adds a pixel's
  samples in another order), ray counts equal;
* against JAX's ``render_sharded`` on its 8-device mesh: equal ray
  counts and JAX's own bar, rtol = atol = 2e-4
  (``tests/test_sharding.py:46-63``), on the share of entries that the
  port's single-device engines hold against JAX's
  (``tests/test_torch_wavefront.py``: 99.5%, sums within 2e-5).  Not on
  every entry: the frameworks' last-ulp differences (XLA's CPU ``rsqrt``,
  fused multiply-adds) grow over four bounces, the accepted difference of
  ROADMAP's "Golden bar".  Measured at 16x16, 8 spp: 767 of 768
  accumulator entries within 2e-4, the other at 4.3e-4 relative.  Between
  the port's own layouts the bar is bit-equality (above).
  ``per_device_ray_counts`` equal to JAX's.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JaxConfig
from pathtracer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pathtracer_tpu.parallel.sharded import gather_image as jax_gather_image
from pathtracer_tpu.parallel.sharded import per_device_ray_counts as jax_ray_counts
from pathtracer_tpu.parallel.sharded import render_sharded as jax_render_sharded
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.parallel import mesh as pmesh
from pathtracer_tpu_torch.parallel.sharded import (
    gather_image,
    make_accum,
    per_device_ray_counts,
    render_sharded,
    scatter_accum,
)
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene
from tests.test_torch_scene import port_scene_from_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU8 = [torch.device("cpu")] * 8
CFG = dict(wavefront=True, max_depth=4, iters_per_launch=4)


@pytest.fixture(scope="module")
def mesh():
    return pmesh.make_mesh(CPU8)


def _cornell(res):
    desc = dataclasses.replace(load_scene(os.path.join(ROOT, "scenes", "cornell.txt")),
                               resolution=res)
    return desc.scene_for_frame(0, device="cpu")


def test_gather_image_layout(mesh):
    """Row ``d*(N/D) + j`` of a device-major ``[N, 3]`` holds pixel
    ``d + D*j`` (``test_sharding.py:27-36``)."""
    n_dev, n = 8, 32
    acc = np.zeros((n, 3), np.float32)
    for d in range(n_dev):
        for j in range(n // n_dev):
            acc[d * (n // n_dev) + j] = d + n_dev * j
    img = gather_image(torch.from_numpy(acc), mesh)
    np.testing.assert_array_equal(img[:, 0].numpy(), np.arange(n))


def test_scatter_then_gather_is_the_identity(mesh):
    flat = torch.from_numpy(np.random.default_rng(3).random((64, 3)).astype(np.float32))
    blocks = scatter_accum(flat, mesh)
    assert len(blocks) == 8 and all(b.shape == (8, 3) for b in blocks)
    assert torch.equal(blocks[3][:, 0], flat[3::8, 0])  # shard d holds pixels d + 8j
    assert torch.equal(gather_image(blocks, mesh), flat)
    assert torch.equal(gather_image(scatter_accum(flat.numpy(), mesh), mesh), flat)


def test_make_accum_divisibility(mesh):
    with pytest.raises(ValueError, match="not divisible"):
        make_accum(30, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        scatter_accum(np.zeros((30, 3), np.float32), mesh)
    blocks = make_accum(64, mesh)
    assert [tuple(b.shape) for b in blocks] == [(8, 3)] * 8
    assert all(b.dtype == torch.float32 and not b.any() for b in blocks)


@pytest.mark.parametrize("pinned", [True, False], ids=["pinned", "queue"])
def test_sharded_equals_single_device(mesh, pinned):
    """The 8-shard strided render traces the single-device render's
    samples: bit-equal on the pinned engine, ray counts equal on both."""
    scene = _cornell((16, 16))
    cfg = RenderConfig(**CFG, wavefront_pinned=pinned, wavefront_capacity=1 << 7)
    img1, acc1, st1 = render(scene, 8, cfg, device="cpu")
    img8, acc8, st8 = render_sharded(scene, 8, cfg, mesh=mesh)
    assert st1 == st8 and isinstance(st8["rays_traced"], int)
    flat8 = gather_image(acc8, mesh)
    if pinned:
        assert torch.equal(acc1, flat8)
        assert torch.equal(img1, img8)
    else:
        torch.testing.assert_close(flat8, acc1, rtol=1e-6, atol=1e-6)


def test_sharded_matches_jax(mesh, cornell_scene):
    """The port's sharded render against JAX's on its 8 virtual devices."""
    assert jax.device_count() == 8
    jscene = dataclasses.replace(
        cornell_scene, camera=dataclasses.replace(cornell_scene.camera, resolution=(16, 16)))
    jcfg = JaxConfig(**CFG, wavefront_capacity=1 << 8)
    jmesh = jax_make_mesh()
    jimg, jacc, jst = jax_render_sharded(jscene, 8, jcfg, mesh=jmesh)
    scene = port_scene_from_jax(jscene)
    img, acc, st = render_sharded(scene, 8, RenderConfig(**CFG), mesh=mesh)
    assert st["rays_traced"] == int(jst["rays_traced"])
    for name, got, want in (("accum", gather_image(acc, mesh).numpy(),
                             np.asarray(jax_gather_image(jacc, jmesh))),
                            ("image", img.numpy(), np.asarray(jimg))):
        share = float(np.isclose(got, want, rtol=2e-4, atol=2e-4).mean())
        sum_rel = abs(float(got.sum()) - float(want.sum())) / abs(float(want.sum()))
        print(f"{name}: {share:.5f} of entries within 2e-4 of JAX, sums within {sum_rel:.3g}")
        assert share >= 0.995 and sum_rel <= 2e-5, (name, share, sum_rel)


def test_per_device_ray_counts_match_jax(mesh, cornell_scene):
    jscene = dataclasses.replace(
        cornell_scene, camera=dataclasses.replace(cornell_scene.camera, resolution=(16, 16)))
    want = jax_ray_counts(jscene, 4, JaxConfig(**CFG), jax_make_mesh())
    got = per_device_ray_counts(port_scene_from_jax(jscene), 4, RenderConfig(**CFG), mesh)
    assert got.shape == (8,) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
    assert got.min() > 0.8 * got.max()  # strided pixels balance the shards


def test_sharded_deterministic(mesh):
    scene = _cornell((16, 16))
    cfg = RenderConfig(**CFG)
    _, a1, _ = render_sharded(scene, 4, cfg, mesh=mesh)
    _, a2, _ = render_sharded(scene, 4, cfg, mesh=mesh)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


def test_mesh_repeating_one_device_and_resume():
    """A mesh of one device twice: shards 0 and 1 of 2 in turn on it; a
    pixel-ordered accumulator resumes on it bit for bit (chunks of 2 on
    both: the pinned engine adds a chunk's samples to the accumulator at
    the chunk's end)."""
    m = pmesh.make_mesh(["cpu", "cpu"])
    assert (m.size, m.n_local, m.shard_ids, m.rank, m.world) == (2, 2, (0, 1), 0, 1)
    scene = _cornell((12, 10))
    cfg = RenderConfig(**dict(CFG, iters_per_launch=2))
    _, whole, st = render(scene, 6, cfg, device="cpu")
    _, half, st1 = render(scene, 2, cfg, device="cpu")
    img, resumed, st2 = render_sharded(scene, 4, cfg, mesh=m, accum=half, start_iteration=2)
    assert torch.equal(gather_image(resumed, m), whole)
    assert st["rays_traced"] == st1["rays_traced"] + st2["rays_traced"]
    assert img.shape == (10, 12, 3)
    seen = []
    render_sharded(scene, 4, cfg, mesh=m,
                   progress_fn=lambda done, acc: seen.append((done, len(acc))))
    assert seen == [(2, 2), (4, 2)]


def test_make_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        pmesh.make_mesh([])
    assert pmesh.AXIS == "shard"


def test_initialize_distributed_without_a_launcher(monkeypatch):
    """No ``WORLD_SIZE``: nothing to join; ``RANK`` alone names the missing
    ``WORLD_SIZE`` (``WORLD_SIZE`` alone: ``tests/test_torch_distributed.py``)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert pmesh.initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is missing"):
        pmesh.initialize_distributed("cpu")
