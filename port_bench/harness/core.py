"""One run of one cell: set-up, the measured window, the check, the line.

``run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`` lands
here.  Everything a cell needs is found by name: ``workloads/<name>.json``
(its configuration, entry and traffic), ``configs/<config>.json`` (the
scene and its render settings), ``entries/<entry>.py`` (what a frame or a
step of that traffic calls in the program), ``e2e/<metric>.py`` and
``metrics/<metric>.py`` (one reader per metric).  ``BENCHMARK.json`` at the
root of the checkout says which metrics a cell reports.

The window is a closed loop: the next unit (a preview frame or a gradient
step) starts when the last has delivered its result to the host, for
``--seconds`` seconds; the rates are all the work over all the window.  With
``--trace 1`` three steady stretches of whole units inside the window are
timed, the last two under the profiler (``harness/profile.py``): the
per-layer readers take their numbers from the one that records the device
alone.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from contextlib import nullcontext

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # port_bench/
ROOT = os.path.dirname(HERE)  # the checkout
# top-level module names that no process of the benchmark may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pathtracer_tpu")
TRACE_SKIP = 2  # units run before the first stretch, so the stretches are steady
# a traced run's stretches, in order: timed only, the device traced alone, the host's operators too
STRETCHES = ("untraced", "device", "host")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """``(workload, config)`` dicts of the cell ``name``."""
    wl = load_json(HERE, "workloads", f"{name}.json")
    cfg = load_json(HERE, "configs", f"{wl['config']}.json")
    return wl, cfg


def cell_metrics(bench: dict, cell: str) -> tuple:
    """The end-to-end and per-layer metric entries of ``BENCHMARK.json``
    that ``cell`` reports: those listing it, and those without a
    ``workloads`` key (a per-layer one then where its ``moves`` is
    reported)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench.get("per_layer", [])
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def reader(kind: str, name: str):
    """The module ``port_bench/<kind>/<name>.py`` (its ``value`` function),
    loaded by its path: a metric's name may hold dots.  Where there is no
    such file, the name's last dotted part is dropped until one is found, so
    that ``idle_pct.render`` and ``idle_pct.grad`` share ``idle_pct.py``."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(HERE, kind, ".".join(parts[:n]) + ".py")
        if os.path.exists(path):
            break
    else:
        raise FileNotFoundError(f"no reader for {name} in {os.path.join(HERE, kind)}")
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Run:
    """What one run measured: the host clock's readings of the window."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.latencies_s = []  # per unit, start to result on the host
        self.samples = 0  # pixel-samples completed in the window
        self.peak_bytes = 0  # torch.cuda.max_memory_allocated over the window


def run_cell(workload: dict, config: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", program=None) -> dict:
    """One run; returns the result line's dict.  ``program`` replaces the
    entry's calls into the program (the tests plant faults there)."""
    import torch

    t0 = time.perf_counter()
    entry = importlib.import_module(f"port_bench.entries.{workload['entry']}")
    cell = entry.Cell(workload, config, seed, torch.device(device), program=program)
    cell.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    run = Run()
    run.setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    n_traced = int(workload.get("trace_units", 10)) if trace else 0
    # the units that start a stretch of n_traced units, and what it records
    starts = {TRACE_SKIP + i * n_traced: what for i, what in enumerate(STRETCHES)} if n_traced else {}
    last = TRACE_SKIP + len(STRETCHES) * n_traced if n_traced else 1
    profile, stretches = None, []
    t_start = time.perf_counter()
    k = 0
    while True:
        if k in starts:
            profile = _Profile(torch, device, k, starts[k])
        t_unit = time.perf_counter()
        with _span(torch, profile, "port_bench.unit"):
            run.samples += cell.unit(lambda name: _span(torch, profile, f"port_bench.{name}"))
        t_end = time.perf_counter()
        run.latencies_s.append(t_end - t_unit)
        k += 1
        if profile is not None and k == profile.first + n_traced:
            stretches.append(profile.stop(cell, n_traced))
            profile = None
        if t_end - t_start >= seconds and k >= last:
            break
    run.window_s = t_end - t_start
    if device == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    untraced_s, traced, host_traced = stretches if n_traced else (None, None, None)
    if n_traced:
        traced.untraced_window_s = untraced_s

    e2e, layer = cell_metrics(load_json(ROOT, "BENCHMARK.json"), workload["name"])
    metrics = {}
    if trace:
        for m in layer:
            value = reader("metrics", m["name"]).value(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": reader("e2e", m["name"]).value(run), "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": int(workload.get("chips", 1)),
           "memory_peak_bytes": int(max(setup_peak, run.peak_bytes))}
    if trace:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    if device == "cuda":
        dev["power"] = power_limit()

    outputs = cell.outputs()
    cell.release()
    del cell
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = entry.check(workload, config, seed, outputs, torch.device(device))
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": len(run.latencies_s), "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = {"device_ops": traced.top_device_ops(),
                             "idle_gaps": host_traced.top_idle_gaps()}
        line["stretches"] = {"untraced": {"window_s": untraced_s, "units": n_traced}}
        for name, t in (("device_only", traced), ("with_host_ops", host_traced)):
            line["stretches"][name] = {"busy_s": t.busy_s, "window_s": t.window_s,
                                       "units": n_traced, "trace_bytes": t.trace_bytes}
    line["seconds"] = {"setup": run.setup_s, "window": run.window_s,
                       "check": time.perf_counter() - t_check}
    line["checks"] = checks
    return line


def _span(torch, profile, name: str):
    """A named host span while a stretch with the host's operators is traced."""
    if profile is not None and profile.what == "host":
        return torch.profiler.record_function(name)
    return nullcontext()


PROFILE_PAD_S = 0.05  # idle host time at both ends of a profile, so none of its records is lost


class _Profile:
    """One stretch of whole units, from unit ``first`` on, timed by CUDA
    events: ``untraced`` (no profiler: the host's own pace), ``device`` (the
    profiler records the device alone) or ``host`` (the device and the host's
    operators, with the harness's spans, bounded by the spans)."""

    def __init__(self, torch, device: str, first: int, what: str):
        self.torch, self.first, self.what = torch, first, what
        self.cuda = device == "cuda"
        self.prof = None
        if what != "untraced":
            acts = [torch.profiler.ProfilerActivity.CUDA] if self.cuda else []
            if what == "host" or not self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CPU)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            time.sleep(PROFILE_PAD_S)
        self.events = None
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.events[0].record()
        self.t0 = time.perf_counter()

    def stop(self, cell, n_units: int):
        """The untraced stretch's seconds, or what a traced one says."""
        from port_bench.harness.profile import TraceData

        if self.cuda:
            self.events[1].record()
            self.torch.cuda.synchronize()
            window_s = self.events[0].elapsed_time(self.events[1]) * 1e-3
        else:
            window_s = time.perf_counter() - self.t0
        if self.prof is None:
            return window_s
        time.sleep(PROFILE_PAD_S)
        self.prof.__exit__(None, None, None)
        path = os.path.join(ROOT, "build", "port_bench", f"trace.{os.getpid()}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.prof.export_chrome_trace(path)
        data = TraceData.from_chrome(path, cell.trace_context(n_units),
                                     None if self.what == "host" else window_s)
        data.trace_bytes = os.path.getsize(path)
        os.remove(path)
        return data


def parse_args(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of the port.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv) -> int:
    args = parse_args(argv)
    # fixed caches inside the checkout, should the program come to build Triton or
    # C++ extension kernels (its nvcc kernels go to build/torch_kernels/)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "port_bench", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "port_bench", "extensions")
    import torch

    workload, config = load_cell(args.workload)
    chips = int(workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = run_cell(workload, config, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"port_bench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"port_bench: {workload['name']} seed {args.seed} on {line['device'].get('power')}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
