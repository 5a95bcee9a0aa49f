"""The port's profiling spans (``utils/metrics.span``) on the CPU.

Under a CPU ``torch.profiler`` a render records ``pt.render`` with
``pt.pack_tables``, ``pt.render_chunk`` (holding each iteration's
``pt.camera_sample``, ``pt.trace_paths`` and ``pt.accumulate``) and
``pt.tonemap`` inside it; a gradient step records ``pt.loss_and_grad``
around ``pt.forward`` and ``pt.backward``, with the reverse trace
``pt.trace_bwd`` inside the backward.  Without a profiler a span is one
shared no-op context.  The outputs are the same bits either way, and the
CLI's ``--profile`` writes a Chrome trace holding the spans.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import dataclasses
import json
import os
import re

import torch

from pathtracer_tpu_torch import cli
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops.rng import prng_key
from pathtracer_tpu_torch.render import diff
from pathtracer_tpu_torch.render.integrator import render
from pathtracer_tpu_torch.scene.parser import load_scene
from pathtracer_tpu_torch.utils import metrics

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORNELL = os.path.join(ROOT, "scenes", "cornell.txt")


def _profiled(tmp_path, fn):
    """``fn()``'s result and the ``pt.`` spans its CPU profile recorded:
    ``[(name, start, end)]`` in start order, read from the Chrome trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return out, _trace_spans(path)


def _trace_spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("pt.")),
                  key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _render_inputs():
    scene = dataclasses.replace(load_scene(CORNELL), resolution=(24, 16)).scene_for_frame(
        0, device="cpu")
    return scene, RenderConfig(max_depth=4)


def _step_inputs():
    desc = dataclasses.replace(load_scene(CORNELL), resolution=(16, 16))
    params, static = diff.params_from_description(desc, 0, device="cpu")
    target = torch.full((16 * 16, 3), 0.25)
    return params, static, target, RenderConfig(max_depth=3)


def _step(params, static, target, cfg):
    return diff.loss_and_grad_rays(params, static, target, 2, prng_key(3), cfg, device="cpu")


def test_render_records_its_spans_nested(tmp_path):
    scene, cfg = _render_inputs()
    _, spans = _profiled(tmp_path, lambda: render(scene, 4, cfg, base_key=prng_key(1),
                                                  device="cpu"))
    (top,) = _named(spans, "pt.render")
    (chunk,) = _named(spans, "pt.render_chunk")
    (tables,) = _named(spans, "pt.pack_tables")
    (tone,) = _named(spans, "pt.tonemap")
    assert all(_inside(s, top) for s in (chunk, tables, tone))
    assert tables[2] <= chunk[1] and chunk[2] <= tone[1]
    for name in ("pt.camera_sample", "pt.trace_paths", "pt.accumulate"):
        got = _named(spans, name)
        assert len(got) == 4 and all(_inside(s, chunk) for s in got), name
    order = [n for n, _, _ in spans if n in ("pt.camera_sample", "pt.trace_paths",
                                              "pt.accumulate")]
    assert order == ["pt.camera_sample", "pt.trace_paths", "pt.accumulate"] * 4
    assert {n for n, _, _ in spans} == {"pt.render", "pt.render_chunk", "pt.pack_tables",
                                        "pt.tonemap", "pt.camera_sample", "pt.trace_paths",
                                        "pt.accumulate"}


def test_gradient_step_records_forward_and_backward_spans(tmp_path):
    params, static, target, cfg = _step_inputs()
    _, spans = _profiled(tmp_path, lambda: _step(params, static, target, cfg))
    (top,) = _named(spans, "pt.loss_and_grad")
    (fwd,) = _named(spans, "pt.forward")
    (bwd,) = _named(spans, "pt.backward")
    assert _inside(fwd, top) and _inside(bwd, top) and fwd[2] <= bwd[1]
    (tables,) = _named(spans, "pt.pack_tables")
    assert _inside(tables, fwd)
    for name in ("pt.camera_sample", "pt.trace_paths"):
        got = _named(spans, name)
        assert len(got) == 2 and all(_inside(s, fwd) for s in got), name
    got = _named(spans, "pt.trace_bwd")
    assert len(got) == 2 and all(_inside(s, bwd) for s in got)
    assert not _named(spans, "pt.render")


def test_span_without_a_profiler_is_one_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = metrics.span("render")
    assert metrics.span("trace_paths") is first
    with first as entered:
        assert entered is None
    scene, cfg = _render_inputs()
    render(scene, 2, cfg, base_key=prng_key(1), device="cpu")
    _step(*_step_inputs())


def test_outputs_are_the_same_bits_with_the_profiler_on_and_off(tmp_path):
    scene, cfg = _render_inputs()
    run = lambda: render(scene, 4, cfg, base_key=prng_key(1), device="cpu")  # noqa: E731
    img, accum, stats = run()
    (img_p, accum_p, stats_p), _ = _profiled(tmp_path, run)
    assert torch.equal(img, img_p) and torch.equal(accum, accum_p) and stats == stats_p
    inputs = _step_inputs()
    loss, grads, rays = _step(*inputs)
    (loss_p, grads_p, rays_p), _ = _profiled(tmp_path, lambda: _step(*inputs))
    assert torch.equal(loss, loss_p) and torch.equal(rays, rays_p)
    leaves, leaves_p = grads.leaves(), grads_p.leaves()
    assert leaves.keys() == leaves_p.keys()
    for name, g in leaves.items():
        assert torch.equal(g, leaves_p[name]), name
    assert any(float(g.abs().max()) > 0 for g in leaves.values())


def test_cli_profile_writes_a_trace_with_the_render_span(tmp_path, capsys):
    text = re.sub(r"RES\s+\d+\s+\d+", "RES 16 12", open(CORNELL).read())
    scene = tmp_path / "cornell_small.txt"
    scene.write_text(text)
    log_dir = tmp_path / "profile"
    assert cli.main([f"scene={scene}", "--spp", "2", "--depth", "3", "--device", "cpu",
                     "--out", str(tmp_path / "out.png"), "--profile", str(log_dir)]) == 0
    spans = _trace_spans(str(log_dir / "trace.json"))
    assert len(_named(spans, "pt.render")) == 1
    assert "saved" in capsys.readouterr().out

