"""What a traced stretch of units says, read from the profiler's trace.

``TraceData.from_chrome`` reads the Chrome trace that ``torch.profiler``
exports: the device's kernels, copies and sets (``kernel``, ``gpu_memcpy``,
``gpu_memset``), the host's operators (``cpu_op``) and the harness's own
spans (``user_annotation`` named ``port_bench.*``), all on one clock.

A traced run times three stretches of as many whole units, each by CUDA
events recorded before its first unit and after its last.  The first runs
untraced: its length (``untraced_window_s``) is the host's own pace.  The
second records the device alone; the per-layer readers
(``metrics/<name>.py``) read it: the kernels by name, the busy time, and
what the entry knows of the work in the stretch (``context``: the samples
and rays it completed, the scene's geoms, the engine's depth).  Its
``window_s`` is longer than the untraced one by the profiler's cost per
launch, so the idle share is its busy time over the untraced length.  The
third records the host's operators as well, bounded by the unit spans; it
only names what the host was doing in each of the device's idle gaps,
which the profiler's own host cost there lengthens.
"""

from __future__ import annotations

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "port_bench."


def short_name(name: str) -> str:
    """A kernel's name without ``void``, an anonymous namespace, its
    template arguments and its parameter list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def _union(intervals):
    """Sorted, merged ``(start, end)`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class TraceData:
    """The traced stretch; times in seconds."""

    def __init__(self, kernels, device_ops, host_ops, spans, context: dict, window_s=None):
        """``window_s``: the stretch's length where it was taken apart from
        the trace (a device-only stretch, every record of which lies in it);
        None: the stretch runs from the first unit span's start to the last
        one's end."""
        if window_s is None:
            units = [s for s in spans if s[2] == SPAN_PREFIX + "unit"]
            self.start = min(s[0] for s in units)
            self.end = max(s[1] for s in units)
        else:
            self.start = min((s for s, _, _ in device_ops), default=0.0)
            self.end = max((e for _, e, _ in device_ops), default=self.start)
        self.window_s = self.end - self.start if window_s is None else window_s
        self.untraced_window_s = None  # an untraced stretch of as many units, where one was timed
        self.trace_bytes = 0
        self.context = context

        def inside(evs):
            if window_s is not None:
                return list(evs)
            return [e for e in evs if e[1] > self.start and e[0] < self.end]

        self.kernels = inside(kernels)  # (start, end, name)
        self.device_ops = inside(device_ops)  # kernels, copies and sets
        self.host_ops = inside(host_ops)
        self.spans = inside(spans)
        busy = _union((max(s, self.start), min(e, self.end)) for s, e, _ in self.device_ops)
        self.busy_s = sum(e - s for s, e in busy)
        self.gaps = []  # (start, end) of the device's idle time in the stretch
        t = self.start
        for s, e in busy:
            if s > t:
                self.gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            self.gaps.append((t, self.end))

    @classmethod
    def from_chrome(cls, path: str, context: dict, window_s=None) -> "TraceData":
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
        kernels, device_ops, host_ops, spans = [], [], [], []
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"]) * 1e-6
            rec = (s, s + float(ev["dur"]) * 1e-6, ev.get("name", ""))
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                device_ops.append(rec)
                if cat == "kernel":
                    kernels.append(rec)
            elif cat == "cpu_op":
                host_ops.append(rec)
            elif cat == "user_annotation" and rec[2].startswith(SPAN_PREFIX):
                spans.append(rec)
        return cls(kernels, device_ops, host_ops, spans, context, window_s)

    def kernel_seconds(self, pattern: str) -> tuple:
        """``(seconds, launches)`` of the kernels whose short name matches
        the regular expression ``pattern`` in full."""
        rx = re.compile(pattern)
        hits = [(e - s) for s, e, n in self.kernels
                if rx.fullmatch(short_name(n).split("::")[-1])]
        return sum(hits), len(hits)

    def host_states(self, times) -> list:
        """What the host was doing at each of ``times`` (ascending): the
        innermost harness span and the outermost operator running then."""
        import heapq

        ops = sorted(self.host_ops)
        heap, i, out = [], 0, []
        for t in times:
            while i < len(ops) and ops[i][0] <= t:
                heapq.heappush(heap, ops[i])
                i += 1
            while heap and heap[0][1] <= t:
                heapq.heappop(heap)
            span = [(s, n) for s, e, n in self.spans if s <= t < e and n != SPAN_PREFIX + "unit"]
            where = max(span)[1][len(SPAN_PREFIX):] if span else "between units"
            out.append(f"{where}: {heap[0][2] if heap else 'python'}")
        return out

    def top_device_ops(self) -> list:
        """The ten device operations with the most time: ``[[name, seconds]]``."""
        ops = {}
        for s, e, n in self.device_ops:
            k = short_name(n)
            ops[k] = ops.get(k, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:10]]

    def top_idle_gaps(self) -> list:
        """The ten host states that left the device idle longest:
        ``[[state, seconds]]``."""
        idle = {}
        for (s, e), k in zip(self.gaps, self.host_states([g[0] for g in self.gaps])):
            idle[k] = idle.get(k, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
