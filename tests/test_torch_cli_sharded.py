"""The port's CLI under ``--sharded``: ``tests/test_cli.py:40-110`` for
``pathtracer_tpu_torch.cli``.

In one process ``parallel.mesh.make_mesh`` is patched to 8 CPU shards, the
stand-in for JAX's 8 virtual CPU devices; a last test launches the CLI in
two gloo processes with torchrun's variables.  Cornell at 16x16, depth 4,
``--device cpu``.  Bars, JAX's: the sharded image within one 8-bit quantum
of the single-device image; a sharded checkpoint resumed to the image of
an uninterrupted sharded run, PNG bit for bit; a single-device checkpoint
resumed sharded within one quantum of a single-device run.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import os
import re
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.parallel import mesh as pmesh
from pathtracer_tpu_torch.utils import checkpoint as ckpt
from pathtracer_tpu_torch.utils.imageio import load_png
from tests.test_torch_distributed import launch

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    text = open(os.path.join(ROOT, "scenes", "cornell.txt")).read()
    path = tmp_path_factory.mktemp("scenes") / "cornell_16.txt"
    path.write_text(re.sub(r"RES\s+\d+\s+\d+", "RES 16 16", text))
    return str(path)


@pytest.fixture
def eight_shards(monkeypatch):
    real = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh", lambda devices=None: real([torch.device("cpu")] * 8))


def _run(scene, tmp, name, spp, extra=()):
    rc = cli.main([f"scene={scene}", "--spp", str(spp), "--depth", "4", "--device", "cpu",
                   "--out", str(tmp / f"{name}.png"), *extra])
    assert rc == 0
    return load_png(str(tmp / f"{name}.0.png"))


def test_cli_sharded_matches_single_device(small_scene, tmp_path, eight_shards, capsys):
    img1 = _run(small_scene, tmp_path, "single", 8)
    img8 = _run(small_scene, tmp_path, "sharded", 8, ["--sharded"])
    log = capsys.readouterr().out
    assert "engine=wavefront, device=cpu, devices=8 (sharded, 1 process(es))" in log
    assert img1.shape == (16, 16, 3)
    assert np.abs(img1.astype(int) - img8.astype(int)).max() <= 1


def test_cli_sharded_checkpoint_roundtrip(small_scene, tmp_path, eight_shards, capsys):
    """8 spp checkpointed on the shards, resumed to 16: the PNG of 16
    uninterrupted sharded spp; the checkpoint is in pixel order."""
    ck = str(tmp_path / "state.npz")
    direct = _run(small_scene, tmp_path, "direct", 16, ["--sharded"])
    _run(small_scene, tmp_path, "partial", 8,
         ["--sharded", "--checkpoint", ck, "--checkpoint-every", "8"])
    state = ckpt.load(ck)
    assert state["spp_done"] == 8 and state["accum"].shape == (256, 3)
    _run(small_scene, tmp_path, "single8", 8, ["--checkpoint", str(tmp_path / "s.npz"),
                                                "--checkpoint-every", "8"])
    np.testing.assert_array_equal(state["accum"], ckpt.load(str(tmp_path / "s.npz"))["accum"])
    capsys.readouterr()
    resumed = _run(small_scene, tmp_path, "resumed", 16, ["--sharded", "--checkpoint", ck])
    assert "resumed at 8 spp" in capsys.readouterr().out
    np.testing.assert_array_equal(direct, resumed)


def test_cli_checkpoint_crosses_layouts(small_scene, tmp_path, eight_shards):
    """A single-device checkpoint resumes on 8 shards, and a sharded one on
    a single device."""
    ck1, ck8 = str(tmp_path / "one.npz"), str(tmp_path / "eight.npz")
    _run(small_scene, tmp_path, "p1", 8, ["--checkpoint", ck1, "--checkpoint-every", "8"])
    _run(small_scene, tmp_path, "p8", 8,
         ["--sharded", "--checkpoint", ck8, "--checkpoint-every", "8"])
    x = _run(small_scene, tmp_path, "x", 16, ["--sharded", "--checkpoint", ck1])
    y = _run(small_scene, tmp_path, "y", 16)
    z = _run(small_scene, tmp_path, "z", 16, ["--checkpoint", ck8])
    assert np.abs(x.astype(int) - y.astype(int)).max() <= 1
    assert np.abs(z.astype(int) - y.astype(int)).max() <= 1


def test_cli_sharded_preview_and_resume_on_failure(small_scene, tmp_path, eight_shards,
                                                   monkeypatch, capsys):
    """A sharded render that fails after its checkpoint resumes from it
    (``--resume-on-failure``) to the uninterrupted image; the preview is
    gathered to pixel order."""
    from pathtracer_tpu_torch.parallel import sharded

    ck = str(tmp_path / "state.npz")
    real = sharded.render_sharded
    calls = {"n": 0}

    def flaky(scene, spp, cfg, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            _, acc, _ = real(scene, 8, cfg, **dict(kw, progress_fn=None))
            kw["progress_fn"](8, acc)
            raise RuntimeError("injected transient fault")
        return real(scene, spp, cfg, **kw)

    direct = _run(small_scene, tmp_path, "direct", 16, ["--sharded"])
    monkeypatch.setattr(sharded, "render_sharded", flaky)
    got = _run(small_scene, tmp_path, "flaky", 16,
               ["--sharded", "--checkpoint", ck, "--checkpoint-every", "8", "--preview-every",
                "8", "--resume-on-failure"])
    log = capsys.readouterr().out
    assert calls["n"] == 2 and "resuming from 8 spp (attempt 1/3)" in log
    np.testing.assert_array_equal(direct, got)
    preview = load_png(str(tmp_path / "flaky.0.preview.png"))
    assert preview.shape == (16, 16, 3) and preview.mean() > 0


@pytest.mark.parametrize("flag", ["--interactive", "--motion-blur"])
def test_cli_sharded_rejects(small_scene, flag):
    with pytest.raises(SystemExit):
        cli.main([f"scene={small_scene}", "--device", "cpu", "--sharded", flag])


def test_cli_two_process_gloo(small_scene, tmp_path):
    """The CLI as torchrun launches it, two processes of one CPU shard
    each: rank 0 alone prints and writes, within one quantum of one
    process."""
    out = str(tmp_path / "dist.png")
    argv = [sys.executable, "-m", "pathtracer_tpu_torch.cli", f"scene={small_scene}", "--spp",
            "4", "--depth", "4", "--device", "cpu", "--sharded", "--out", out]
    results = launch(argv, 2)
    for rank, (rc, log) in enumerate(results):
        assert rc == 0, f"process {rank} failed:\n{log}"
    assert "devices=2 (sharded, 2 process(es))" in results[0][1] and "saved" in results[0][1]
    assert "saved" not in results[1][1] and "frame 0" not in results[1][1]
    single = _run(small_scene, tmp_path, "one", 4)
    got = load_png(str(tmp_path / "dist.0.png"))
    assert np.abs(got.astype(int) - single.astype(int)).max() <= 1
