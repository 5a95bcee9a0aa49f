"""Where a cell's device time goes, by the program's own spans.

    python3 port_bench/span_report.py --workload <name> --seed <n> [--units N]

Sets the cell up as a run does, runs two units, then traces ``--units``
units (the cell's ``trace_units`` by default) with the host's operators and
the harness's spans, as a ``--trace 1`` run's last stretch does, and reads
the trace with ``harness/spans.SpanTrace``.  Prints one JSON object: the
device ms per sample per pixel owned by each ``pt.`` and ``bwd:`` span (all
operations, and the kernels that are not hand-written), the kernel launches
per spp of each, the stretch's total device time beside the owners' sum,
the share of the non-hand kernels launched inside ``pt.render`` or
``pt.loss_and_grad`` that a span inside it owns, the span metrics
(``camera_ms_per_spp``, ``glue_bwd_ms_per_spp``, ``syncs_per_spp``), the
stretch's ``other_device_ms_per_spp`` beside them, the ten longest idle
gaps named by the program's spans, and the waits counted per unit by the
host's state at each.  Checks no output: a run of
``run.py`` does that.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.harness import core, readers, spans  # noqa: E402

TOP_SPANS = ("pt.render", "pt.loss_and_grad")


def per_spp(seconds: dict, spp: int) -> dict:
    return {k: v * 1e3 / spp for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])}


def child_shares(t: spans.SpanTrace) -> dict:
    """Per top span: the share of the non-hand kernels' device time launched
    inside it that a span inside it owns."""
    out = {}
    for top in TOP_SPANS:
        held = [(s, e) for s, e, n in t.pt_spans.items if n == top]
        inside = total = 0.0
        for s, e, name, corr, cat in t.device_corr:
            if cat != "kernel" or spans.is_hand_kernel(name) or corr not in t.launches:
                continue
            at = t.launches[corr]
            if any(a <= at < b for a, b in held):
                total += e - s
                inside += (e - s) if t.owner(corr) != top else 0.0
        if total:
            out[top] = inside / total
    return out


def report(workload: dict, config: dict, seed: int, units: int, device: str = "cuda") -> dict:
    import torch

    entry = importlib.import_module(f"port_bench.entries.{workload['entry']}")
    cell = entry.Cell(workload, config, seed, torch.device(device))
    cell.setup()
    for _ in range(core.TRACE_SKIP):
        cell.unit(lambda name: contextlib.nullcontext())
    if device == "cuda":
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rec = torch.profiler.record_function
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(core.PROFILE_PAD_S)
        for _ in range(units):
            with rec("port_bench.unit"):
                cell.unit(lambda name: rec(f"port_bench.{name}"))
        if device == "cuda":
            torch.cuda.synchronize()
        time.sleep(core.PROFILE_PAD_S)
    path = os.path.join(core.ROOT, "build", "port_bench", f"spans.{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    t = spans.SpanTrace.from_chrome(path, cell.trace_context(units))
    trace_bytes = os.path.getsize(path)
    os.remove(path)
    spp = t.context["spp"]
    launches = {}
    for _, _, _, corr, cat in t.device_corr:
        if cat == "kernel":
            k = t.owner(corr)
            launches[k] = launches.get(k, 0) + 1
    owned = t.device_seconds()
    syncs = {}  # the host's state at each wait counted in syncs_per_spp
    for state in t.host_states([x for x in t.syncs if t.start <= x < t.end and t.span_at(x)]):
        syncs[state] = syncs.get(state, 0) + 1
    return {
        "workload": workload["name"], "seed": seed, "units": units, "spp": spp,
        "device": torch.cuda.get_device_name(0) if device == "cuda" else device,
        "power": core.power_limit() if device == "cuda" else None,
        "window_s": t.window_s, "busy_s": t.busy_s, "trace_bytes": trace_bytes,
        "device_ms_per_spp": per_spp(owned, spp),
        "glue_ms_per_spp": per_spp(t.device_seconds(glue_only=True), spp),
        "launches_per_spp": {k: v / spp for k, v in sorted(launches.items(),
                                                            key=lambda kv: -kv[1])},
        "device_s": sum(e - s for s, e, _ in t.device_ops), "owners_sum_s": sum(owned.values()),
        "child_share": child_shares(t),
        "metrics": {"camera_ms_per_spp": spans.camera_ms_per_spp(t),
                    "glue_bwd_ms_per_spp": spans.glue_bwd_ms_per_spp(t),
                    "syncs_per_spp": spans.syncs_per_spp(t),
                    "other_device_ms_per_spp": readers.other_device_ms_per_spp(t)},
        "idle_gaps": t.top_idle_gaps(),
        "syncs_per_unit": {k: v / units for k, v in sorted(syncs.items(), key=lambda kv: -kv[1])},
    }


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="A cell's device time by the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 2
    workload, config = core.load_cell(args.workload)
    units = args.units or int(workload.get("trace_units", 10))
    print(json.dumps(report(workload, config, args.seed, units)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
