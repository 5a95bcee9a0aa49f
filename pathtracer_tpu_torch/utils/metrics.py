"""Observability: per-chunk render records, timers, device memory, traces.

Port of ``pathtracer_tpu/utils/metrics.py:1-91``: :class:`RenderMetrics`
emits one JSON line per chunk with JAX's keys (``event``, ``spp_done``,
``rays_traced``, ``mrays_per_s``, ``chunk_s``); :class:`Timer` is a wall
timer whose :meth:`Timer.timed` waits for the CUDA devices of its
outputs, where JAX calls ``block_until_ready``, since CUDA launches return
before the device finishes; :func:`device_memory_stats` reads
``torch.cuda.memory_stats`` per card; :func:`profile_trace` records a
``torch.profiler`` trace into a directory (JAX's ``jax.profiler.trace``).
Nothing in the package calls them, as nothing in JAX's does.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors inside ``out`` (nested tuples,
    lists, dicts and dataclasses)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    elif hasattr(out, "__dataclass_fields__"):
        for name in out.__dataclass_fields__:
            _cuda_devices(getattr(out, name), found)
    return found


def synchronize(out) -> None:
    """Wait until the devices of ``out``'s CUDA tensors have finished."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)


@dataclass
class Timer:
    """Wall timer; :meth:`timed` waits for its outputs' devices."""

    t0: float = 0.0
    elapsed: float = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0

    @staticmethod
    def timed(fn, *args, **kwargs):
        """Run ``fn``, wait for its outputs' devices, return ``(outputs,
        seconds)``."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        return out, time.perf_counter() - t0


@dataclass
class RenderMetrics:
    """Running render telemetry; emits one JSON line per record."""

    stream: object = field(default_factory=lambda: sys.stderr)
    enabled: bool = True
    _last_t: float = field(default_factory=lambda: time.perf_counter())
    _last_rays: float = 0.0

    def record(self, *, spp_done: int, rays_traced: float, extra: Optional[dict] = None):
        now = time.perf_counter()
        dt = max(now - self._last_t, 1e-9)
        d_rays = rays_traced - self._last_rays
        rec = {
            "event": "render_chunk",
            "spp_done": spp_done,
            "rays_traced": rays_traced,
            "mrays_per_s": round(d_rays / dt / 1e6, 3),
            "chunk_s": round(dt, 4),
        }
        if extra:
            rec.update(extra)
        self._last_t, self._last_rays = now, rays_traced
        if self.enabled:
            print(json.dumps(rec), file=self.stream, flush=True)
        return rec


def device_memory_stats() -> dict:
    """``{device: {"bytes_in_use", "peak_bytes_in_use"}}`` per CUDA device,
    from ``torch.cuda.memory_stats``; ``{}`` without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        if s:
            out[f"cuda:{i}"] = {
                "bytes_in_use": s.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            }
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` context (the CPU, and CUDA where there is a
    card) that writes a Chrome trace, ``trace.json``, into ``log_dir``;
    yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
