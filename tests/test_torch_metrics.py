"""The port's ``utils/metrics.py`` on the CPU: JAX's record keys, the
timer, device memory without a card, and a profiler trace."""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import io
import json
import os
import types

import torch

from pathtracer_tpu_torch.utils import metrics


def test_render_metrics_keys_and_values(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(metrics, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))
    stream = io.StringIO()
    m = metrics.RenderMetrics(stream=stream)
    now[0] = 102.0
    rec = m.record(spp_done=4, rays_traced=8e6)
    now[0] = 102.5
    rec2 = m.record(spp_done=8, rays_traced=9e6, extra={"frame": 0})
    assert rec == {"event": "render_chunk", "spp_done": 4, "rays_traced": 8e6,
                   "mrays_per_s": 4.0, "chunk_s": 2.0}
    assert rec2 == {"event": "render_chunk", "spp_done": 8, "rays_traced": 9e6,
                    "mrays_per_s": 2.0, "chunk_s": 0.5, "frame": 0}
    lines = [json.loads(x) for x in stream.getvalue().splitlines()]
    assert lines == [rec, rec2]
    quiet = metrics.RenderMetrics(stream=io.StringIO(), enabled=False)
    quiet.record(spp_done=1, rays_traced=1.0)
    assert quiet.stream.getvalue() == ""


def test_timer():
    out, secs = metrics.Timer.timed(lambda a, b: {"x": (a + b, [a])}, torch.ones(3), torch.ones(3))
    assert torch.equal(out["x"][0], torch.full((3,), 2.0)) and secs >= 0
    with metrics.Timer() as t:
        sum(range(1000))
    assert t.elapsed > 0


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert metrics.device_memory_stats() == {}


def test_profile_trace_writes_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with metrics.profile_trace(log_dir) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    trace = json.load(open(os.path.join(log_dir, "trace.json")))
    assert trace["traceEvents"]
