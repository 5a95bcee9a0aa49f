"""The port's CLI: checkpoints, previews, resume on failure, debug, the REPL.

Port of the single-device tests of ``tests/test_cli.py`` (the ``--sharded``
ones wait for the multi-GPU slice) on the CPU: Cornell at 32x32, depth 5,
through ``pathtracer_tpu_torch.cli.main`` with ``--device cpu``.  The
checkpoint round trip runs on the megakernel engine, whose chunks add each
iteration to the accumulator in order, so 8 spp and a resume to 16 equal
16 straight spp exactly (JAX's test compares the PNGs of its wavefront
engine; the port compares the PNGs and the accumulators).
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import importlib
import io
import os
import re

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.utils import checkpoint as ckpt
from pathtracer_tpu_torch.utils.imageio import load_png

ROOT = os.path.join(os.path.dirname(__file__), "..")
MEGA = ["--engine", "megakernel"]


def _cornell_text(red="RGB         .75 .12 .08"):
    text = open(os.path.join(ROOT, "scenes", "cornell.txt")).read()
    text = re.sub(r"RES\s+\d+\s+\d+", "RES 32 32", text)
    return text.replace("RGB         .75 .12 .08", red, 1)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    path = tmp_path_factory.mktemp("scenes") / "cornell_small.txt"
    path.write_text(_cornell_text())
    return str(path)


def _main(scene, out, spp, extra=()):
    return cli.main([f"scene={scene}", "--spp", str(spp), "--depth", "5", "--device", "cpu",
                     "--out", str(out), *extra])


def test_cli_checkpoint_roundtrip(small_scene, tmp_path, capsys):
    """8 spp with a checkpoint, then a resume to 16 from it: the image and
    the accumulator of 16 straight spp."""
    ck, ck16 = str(tmp_path / "state.npz"), str(tmp_path / "straight.npz")
    assert _main(small_scene, tmp_path / "direct.png", 16,
                 MEGA + ["--checkpoint", ck16, "--checkpoint-every", "16"]) == 0
    assert _main(small_scene, tmp_path / "partial.png", 8,
                 MEGA + ["--checkpoint", ck, "--checkpoint-every", "8"]) == 0
    state = ckpt.load(ck)
    assert (state["spp_done"], state["frame"], state["seed"]) == (8, 0, 0)
    capsys.readouterr()
    assert _main(small_scene, tmp_path / "resumed.png", 16,
                 MEGA + ["--checkpoint", ck, "--checkpoint-every", "8"]) == 0
    log = capsys.readouterr().out
    assert f"resumed at 8 spp from {ck}" in log and "16/16 spp" in log
    assert "8/16 spp" not in log  # the resume renders iterations 8-15 only
    np.testing.assert_array_equal(load_png(str(tmp_path / "direct.0.png")),
                                  load_png(str(tmp_path / "resumed.0.png")))
    resumed, straight = ckpt.load(ck), ckpt.load(ck16)
    assert resumed["spp_done"] == straight["spp_done"] == 16
    np.testing.assert_array_equal(resumed["accum"], straight["accum"])


def test_cli_checkpoint_of_another_frame_is_ignored(small_scene, tmp_path, capsys):
    """A checkpoint whose frame differs is not resumed from."""
    ck = str(tmp_path / "other.npz")
    ckpt.save(ck, torch.full((32 * 32, 3), float("nan")), 8, 1, 0)
    assert _main(small_scene, tmp_path / "x.png", 4, MEGA + ["--checkpoint", ck]) == 0
    assert "resumed" not in capsys.readouterr().out
    assert load_png(str(tmp_path / "x.0.png")).mean() > 0


def test_cli_preview_name_and_progress(small_scene, tmp_path, capsys):
    """``--preview-every`` writes ``<stem>.<frame>.preview.<ext>``; the last
    preview is the final image; the progress and summary lines are JAX's."""
    assert _main(small_scene, tmp_path / "p.png", 8, ["--preview-every", "4"]) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["p.0.png", "p.0.preview.png"], names
    np.testing.assert_array_equal(load_png(str(tmp_path / "p.0.png")),
                                  load_png(str(tmp_path / "p.0.preview.png")))
    log = capsys.readouterr().out
    assert re.search(r"^  8/8 spp  \(\d+\.\d Mpaths/s\)$", log, re.M), log
    assert re.search(r"^  saved .*p\.0\.png \(\d+\.\ds, \d+\.\d Mpaths/s, \d+\.\d Mrays/s\)$",
                     log, re.M), log


def test_cli_resume_on_failure(small_scene, tmp_path, monkeypatch, capsys):
    """A render that raises after a good checkpoint is retried from that
    checkpoint; the final image equals an uninterrupted run's."""
    integ = importlib.import_module("pathtracer_tpu_torch.render.integrator")
    ck = str(tmp_path / "state.npz")
    real_render = integ.render
    calls = {"n": 0}

    def flaky_render(scene, spp, cfg, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            # the first 8 spp for real (progress checkpoints at 8), then a
            # transient fault after a good checkpoint
            _, acc, _ = real_render(scene, 8, cfg, **kw)
            kw["progress_fn"](8, acc)
            raise RuntimeError("injected transient fault")
        return real_render(scene, spp, cfg, **kw)

    monkeypatch.setattr(integ, "render", flaky_render)
    assert _main(small_scene, tmp_path / "flaky.png", 16,
                 MEGA + ["--checkpoint", ck, "--checkpoint-every", "8",
                         "--resume-on-failure"]) == 0
    assert calls["n"] == 2  # one failure, one resume
    log = capsys.readouterr().out
    assert ("render failed (RuntimeError: injected transient fault); resuming from 8 spp "
            f"(attempt 1/{cli.MAX_FAILURE_RETRIES})") in log
    state = ckpt.load(ck)
    assert state is not None and state["spp_done"] == 16
    monkeypatch.setattr(integ, "render", real_render)
    assert _main(small_scene, tmp_path / "clean.png", 16, MEGA) == 0
    np.testing.assert_array_equal(load_png(str(tmp_path / "flaky.0.png")),
                                  load_png(str(tmp_path / "clean.0.png")))


def test_cli_failure_without_flag_raises(small_scene, tmp_path, monkeypatch):
    """Without ``--resume-on-failure`` the error propagates, once."""
    integ = importlib.import_module("pathtracer_tpu_torch.render.integrator")
    calls = {"n": 0}

    def dead_render(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("injected fault")

    monkeypatch.setattr(integ, "render", dead_render)
    with pytest.raises(RuntimeError, match="injected fault"):
        _main(small_scene, tmp_path / "x.png", 8)
    assert calls["n"] == 1


def test_cli_deterministic_failure_exhausts_retries(small_scene, tmp_path, monkeypatch):
    """A failure that recurs on every attempt is raised after
    ``MAX_FAILURE_RETRIES`` retries."""
    integ = importlib.import_module("pathtracer_tpu_torch.render.integrator")
    calls = {"n": 0}

    def dead_render(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("deterministic NaN")

    monkeypatch.setattr(integ, "render", dead_render)
    with pytest.raises(RuntimeError, match="deterministic NaN"):
        _main(small_scene, tmp_path / "x.png", 8, ["--resume-on-failure"])
    assert calls["n"] == 1 + cli.MAX_FAILURE_RETRIES == 4


def test_cli_debug(small_scene, tmp_path, monkeypatch):
    """``--debug`` renders the clean scene as without it (the debug scan on
    the megakernel engine); a NaN colour fails its finite check, and with
    ``--resume-on-failure`` the check recurs until the retries run out."""
    assert _main(small_scene, tmp_path / "d.png", 4, MEGA + ["--debug"]) == 0
    assert _main(small_scene, tmp_path / "n.png", 4, MEGA) == 0
    np.testing.assert_array_equal(load_png(str(tmp_path / "d.0.png")),
                                  load_png(str(tmp_path / "n.0.png")))
    nan_scene = tmp_path / "nan.txt"
    nan_scene.write_text(_cornell_text(red="RGB         nan .12 .08"))
    for engine in (MEGA, ["--engine", "wavefront"]):
        with pytest.raises(RuntimeError, match=r"non-finite accumulator after spp window"):
            _main(nan_scene, tmp_path / "bad.png", 4, engine + ["--debug"])
    integ = importlib.import_module("pathtracer_tpu_torch.render.integrator")
    real_render, calls = integ.render, {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return real_render(*a, **kw)

    monkeypatch.setattr(integ, "render", counting)
    with pytest.raises(RuntimeError, match=r"spp window \[0, 4\)"):
        _main(nan_scene, tmp_path / "bad.png", 4, MEGA + ["--debug", "--resume-on-failure"])
    assert calls["n"] == 1 + cli.MAX_FAILURE_RETRIES
    assert not (tmp_path / "bad.0.png").exists()


def test_cli_interactive(small_scene, tmp_path, monkeypatch, capsys):
    """``--interactive`` runs the REPL on stdin, on ``cuda`` unless
    ``--device`` says otherwise."""
    out = tmp_path / "it.png"
    monkeypatch.setattr("sys.stdin", io.StringIO("w\nsave\nquit\n"))
    assert _main(small_scene, out, 2, ["--interactive"]) == 0
    log = capsys.readouterr().out
    assert "[interactive] 32x32, preview 2 spp" in log and "saved" in log
    assert os.path.exists(out) and os.path.exists(str(out).replace(".png", ".full.png"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([f"scene={small_scene}", "--interactive"])
