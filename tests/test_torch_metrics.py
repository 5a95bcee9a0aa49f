"""The port's ``utils/metrics.py`` on the CPU: device memory without a
card, and a profiler trace."""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import json
import os

import torch

from pathtracer_tpu_torch.utils import metrics


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
