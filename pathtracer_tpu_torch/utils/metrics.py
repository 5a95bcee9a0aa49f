"""Observability: the program's profiling spans, device memory, traces.

:func:`span` names a layer of a frame or a gradient step while a
``torch.profiler`` session records: the spans are the program's own
profiling names for its layers (``pt.render``, ``pt.pack_tables``,
``pt.render_chunk``, ``pt.camera_sample``, ``pt.trace_paths``,
``pt.accumulate``, ``pt.tonemap``, ``pt.loss_and_grad``, ``pt.forward``,
``pt.backward``, ``pt.trace_bwd``, and ``pt.mesh_tables`` around a scene's
one build of its in-kernel triangle tables), stamped on the profiler's clock, so that
every kernel in the trace is tied through its launch to the layer that
issued it.  :func:`device_memory_stats` reads ``torch.cuda.memory_stats``
per card; :func:`profile_trace` records a ``torch.profiler`` Chrome trace
into a directory (JAX's ``jax.profiler.trace``; the CLI's ``--profile``).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "pt."
# the one context every span returns while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The context of the layer ``name``: while a profiler records, a
    ``record_function`` named ``pt.<name>``; otherwise one shared no-op
    context, so an unprofiled call makes no dispatcher call and allocates
    nothing.  A span adds no tensor operation and no synchronisation."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


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
    yields the profiler.  The program's spans (:func:`span`) are in it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
